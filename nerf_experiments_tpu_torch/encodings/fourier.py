"""Positional encodings: Identity / Fourier / BARF-annealed / Integrated (Mip)
/ Integrated-BARF.

Semantics of `barf/positional_encodings.py:7-282`. The BARF annealing
coefficient alpha is an explicit argument, not module state.

Feature order matches the reference and the JAX package exactly
(channel-major: [cos(x·2^0..2^L), cos(y·...), cos(z·...), sin(x·...), ...],
identity prepended when enabled), so converted weights line up.

All encodings share one signature:
    encode(x, dir=None, pixel_width=None, t_start=None, t_end=None, alpha=None)
and the integrated ones also take `pixel_width_sigma` (`encode_position`
passes it to them only).
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
    # a host alpha stays a host scalar, which a device kernel takes as an
    # argument: copied to the device, it would wait for the device's queue
    alpha = torch.as_tensor(alpha, dtype=x.dtype)
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


def _ipe_moments(pos, dir, pixel_width, t_start, t_end, pixel_width_sigma):
    """Conical-frustum mean and variances (Mip-NeRF eqs 7, 8) plus the
    reference's `pixel_width_sigma` extra-blur term
    (`positional_encodings.py:185-207`), which counts only above 1/4."""
    t_mu = (t_start + t_end) / 2.0
    t_delta = (t_end - t_start) / 2.0

    mu_diff = 2.0 * t_mu * t_delta**2 / (3.0 * t_mu**2 + t_delta**2)
    pos_mu = pos + mu_diff * dir

    r_dot = pixel_width * (2.0 / math.sqrt(12.0))
    sigma_t_sq = t_delta**2 / 3.0 - (
        4.0 * t_delta**4 * (12.0 * t_mu**2 - t_delta**2)
    ) / (15.0 * (3.0 * t_mu**2 + t_delta**2) ** 2)
    sigma_r_sq = r_dot**2 * (
        t_mu**2 / 4.0
        + 5.0 * t_delta**2 / 12.0
        - 4.0 * t_delta**4 / (15.0 * (3.0 * t_mu**2 + t_delta**2))
    )
    if float(pixel_width_sigma) > 0.25:
        add_sigma = (pixel_width_sigma * pixel_width * t_mu) ** 2
        sigma_t_sq, sigma_r_sq = sigma_t_sq + add_sigma, sigma_r_sq + add_sigma
    return pos_mu, sigma_t_sq, sigma_r_sq


@dataclasses.dataclass(frozen=True)
class Integrated(Encoding):
    """`IntegratedFourierFeatures`, Mip-NeRF's integrated positional encoding
    (`positional_encodings.py:151-240`). `pixel_width_sigma` comes with each
    call: Mip-BARF schedules it per step (`barf/model_mip.py:252`)."""

    levels: int = 10
    scale: float = _TWO_PI
    include_identity: bool = True
    distribute_variance: bool = False

    @property
    def output_dim(self) -> int:
        return (self.levels * 2 + int(self.include_identity)) * self.space_dimensions

    def __call__(self, x, dir=None, pixel_width=None, t_start=None, t_end=None, alpha=None,
                 pixel_width_sigma: float = 0.0):
        pos_mu, sigma_t_sq, sigma_r_sq = _ipe_moments(
            x, dir, pixel_width, t_start, t_end, pixel_width_sigma)
        scale4 = (4.0 ** torch.arange(self.levels, dtype=x.dtype, device=x.device)).repeat(
            self.space_dimensions)
        if self.distribute_variance:
            sigma = (sigma_t_sq + sigma_r_sq * 2.0) / self.space_dimensions * scale4
            weight = torch.exp(-sigma / 2.0)
        else:
            diag_sigma = sigma_t_sq * dir**2 + sigma_r_sq * (
                1.0 - dir**2 / torch.sum(dir**2, dim=-1, keepdim=True))  # eq 16
            rep = torch.repeat_interleave(diag_sigma, self.levels, dim=-1)
            weight = torch.exp(-rep * scale4 / 2.0)  # eq 14
        args = _fourier_args(pos_mu, self.levels, self.scale)
        ipe = torch.cat([weight * torch.cos(args), weight * torch.sin(args)], dim=-1)
        if self.include_identity:
            ipe = torch.cat([pos_mu, ipe], dim=-1)
        return ipe


@dataclasses.dataclass(frozen=True)
class IntegratedBarf(Encoding):
    """`IntegratedBarfFourierFeatures`: the integrated encoding times the
    BARF mask (`positional_encodings.py:242-282`)."""

    levels: int = 10
    scale: float = _TWO_PI
    include_identity: bool = True
    distribute_variance: bool = True
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

    def __call__(self, x, dir=None, pixel_width=None, t_start=None, t_end=None, alpha=None,
                 pixel_width_sigma: float = 0.0):
        if alpha is None:
            alpha = float(self.levels)
        ipe = Integrated(
            space_dimensions=self.space_dimensions, levels=self.levels, scale=self.scale,
            include_identity=self.include_identity,
            distribute_variance=self.distribute_variance,
        )(x, dir, pixel_width, t_start, t_end, pixel_width_sigma=pixel_width_sigma)
        mask = _barf_mask(self.levels, self.space_dimensions, alpha, x)
        ident = self.space_dimensions if self.include_identity else 0
        size = self.levels * self.space_dimensions
        parts = [mask * ipe[..., ident:ident + size], mask * ipe[..., ident + size:]]
        if self.include_identity:
            parts.insert(0, ipe[..., :ident])
        return torch.cat(parts, dim=-1)


def encode_position(encoder: Encoding, x, dir, pixel_width, t_start, t_end, alpha,
                    pixel_width_sigma: float = 0.0):
    """The position encoding of a NeRF MLP: integrated (Mip) encoders also take
    the scheduled extra-blur `pixel_width_sigma`, the others ignore it."""
    if isinstance(encoder, (Integrated, IntegratedBarf)):
        return encoder(x, dir, pixel_width, t_start, t_end, alpha=alpha,
                       pixel_width_sigma=pixel_width_sigma)
    return encoder(x, dir, pixel_width, t_start, t_end, alpha=alpha)
