"""Positional encodings: Identity / Fourier / BARF-annealed.

Semantics of `barf/positional_encodings.py:7-148`. The BARF annealing
coefficient alpha is an explicit argument, not module state.

Feature order matches the reference and the JAX package exactly
(channel-major: [cos(x·2^0..2^L), cos(y·...), cos(z·...), sin(x·...), ...],
identity prepended when enabled), so converted weights line up.

All encodings share one signature:
    encode(x, dir=None, pixel_width=None, t_start=None, t_end=None, alpha=None)
"""
from __future__ import annotations

import dataclasses
import math

import torch

_TWO_PI = 2.0 * math.pi


@dataclasses.dataclass(frozen=True)
class Encoding:
    """Base config. `output_dim` is what networks size their inputs by."""

    space_dimensions: int = 3

    @property
    def output_dim(self) -> int:
        raise NotImplementedError

    def __call__(self, x, dir=None, pixel_width=None, t_start=None, t_end=None, alpha=None):
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Identity(Encoding):
    """`IdentityPositionalEncoding` (`positional_encodings.py:17-25`)."""

    @property
    def output_dim(self) -> int:
        return self.space_dimensions

    def __call__(self, x, dir=None, pixel_width=None, t_start=None, t_end=None, alpha=None):
        return x


def _fourier_args(x: torch.Tensor, levels: int, scale: float) -> torch.Tensor:
    """Channel-major arguments: x repeat_interleave(levels) * scale * 2^j."""
    freq = scale * (2.0 ** torch.arange(levels, dtype=x.dtype, device=x.device))
    return (x[..., None] * freq).reshape(*x.shape[:-1], -1)


def _barf_mask(levels: int, space_dimensions: int, alpha, x: torch.Tensor) -> torch.Tensor:
    """Coarse-to-fine cosine-edge mask (`compute_mask:105-122`): 1 below
    floor(alpha), (1 - cos((alpha - k)π))/2 at the ramp level, 0 above."""
    k = torch.arange(levels, dtype=x.dtype, device=x.device)
    alpha = torch.as_tensor(alpha, dtype=x.dtype, device=x.device)
    ramp = torch.clamp(alpha - k, 0.0, 1.0)
    mask = (1.0 - torch.cos(ramp * math.pi)) / 2.0
    return mask.repeat(space_dimensions)


def barf_alpha_schedule(epoch, levels: int, alpha_start: float,
                        start_epoch: float, end_epoch: float) -> float:
    """Linear alpha ramp (`update_alpha:84-103`) as a function of the
    (fractional) epoch."""
    frac = min(max((epoch - start_epoch) / (end_epoch - start_epoch + 1e-12), 0.0), 1.0)
    return alpha_start + frac * (levels - alpha_start)


@dataclasses.dataclass(frozen=True)
class Fourier(Encoding):
    """`FourierFeatures` (`positional_encodings.py:28-57`)."""

    levels: int = 10
    scale: float = _TWO_PI

    @property
    def output_dim(self) -> int:
        return self.levels * 2 * self.space_dimensions

    def __call__(self, x, dir=None, pixel_width=None, t_start=None, t_end=None, alpha=None):
        args = _fourier_args(x, self.levels, self.scale)
        return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


@dataclasses.dataclass(frozen=True)
class Barf(Encoding):
    """`BarfPositionalEncoding` (`positional_encodings.py:61-148`); alpha
    defaults to all levels on (= levels)."""

    levels: int = 10
    scale: float = _TWO_PI
    include_identity: bool = True
    alpha_start: float = 0.0
    alpha_increase_start_epoch: float = 0.0
    alpha_increase_end_epoch: float = 1.0

    @property
    def output_dim(self) -> int:
        return (self.levels * 2 + int(self.include_identity)) * self.space_dimensions

    def alpha_at(self, epoch) -> float:
        return barf_alpha_schedule(
            float(epoch), self.levels, self.alpha_start,
            self.alpha_increase_start_epoch, self.alpha_increase_end_epoch,
        )

    def __call__(self, x, dir=None, pixel_width=None, t_start=None, t_end=None, alpha=None):
        if alpha is None:
            alpha = float(self.levels)
        args = _fourier_args(x, self.levels, self.scale)
        mask = _barf_mask(self.levels, self.space_dimensions, alpha, x)
        parts = [mask * torch.cos(args), mask * torch.sin(args)]
        if self.include_identity:
            parts.insert(0, x)
        return torch.cat(parts, dim=-1)
