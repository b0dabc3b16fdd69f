"""Segmented NeRF MLP ("interpolation between naive and vanilla NeRF").

Architecture semantics from `barf/model_interpolation_architecture.py:33-168`
(`NerfModel`): `n_segments` MLP segments with the encoded position
re-injected at the start of every segment; `delayed_direction` feeds the
encoded direction only to the colour head; `delayed_density` reads density
from the colour head instead of the last segment; softplus(threshold=8)
density; sigmoid rgb; colour head hidden_dim -> hidden_dim//2 -> 3(+1).

Parameters keep the JAX package's names and (in, out) layout:
`segments[i].layers[j].{w,b}` and `color[k].{w,b}`; `from_numpy` /
`to_numpy` convert to and from its pytree of numpy arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from nerf_experiments_tpu_torch.encodings.fourier import Encoding, encode_position
from nerf_experiments_tpu_torch.models.common import (
    Dense,
    ParamGroup,
    linear_apply,
    linear_init,
    softplus8,
)


@dataclasses.dataclass(frozen=True)
class NerfMLPConfig:
    position_encoder: Encoding
    direction_encoder: Encoding
    n_hidden: int = 4
    hidden_dim: int = 256
    delayed_direction: bool = True
    delayed_density: bool = False
    n_segments: int = 2
    learning_rate_start: float = 5e-4
    learning_rate_stop: float = 5e-5
    learning_rate_decay_end: int = 0
    compute_dtype: Any = None  # None (fp32) or torch.bfloat16

    @property
    def param_group(self) -> ParamGroup:
        return ParamGroup(
            self.learning_rate_start,
            self.learning_rate_stop,
            self.learning_rate_decay_end,
        )


def _segment_dims(cfg: NerfMLPConfig, segment_idx: int) -> Tuple[int, int]:
    pos_dim = cfg.position_encoder.output_dim
    dir_dim = cfg.direction_encoder.output_dim
    in_dim = (
        pos_dim
        + (0 if cfg.delayed_direction else dir_dim)
        + (cfg.hidden_dim if segment_idx > 0 else 0)
    )
    out_dim = cfg.hidden_dim + (
        0 if cfg.delayed_density else int(segment_idx == cfg.n_segments - 1)
    )
    return in_dim, out_dim


class _Segment(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class NerfMLP(nn.Module):
    """The network's parameters plus its config; `forward` is `apply`."""

    def __init__(self, cfg: NerfMLPConfig, segments, color):
        super().__init__()
        self.cfg = cfg
        self.segments = nn.ModuleList(_Segment(layers) for layers in segments)
        self.color = nn.ModuleList(color)

    def forward(self, pos, dir, **kwargs):
        return apply(self, self.cfg, pos, dir, **kwargs)


def init(generator: torch.Generator, cfg: NerfMLPConfig, device=None) -> NerfMLP:
    """Segments (each an n_hidden-deep ReLU FFNN) + colour head, with
    nn.Linear's uniform bounds drawn from `generator`."""
    if cfg.n_segments == 0:
        raise NotImplementedError("n_segments must be greater than 0")

    def lin(i, o):
        return linear_init(generator, i, o, device=device)

    segments = []
    for i in range(cfg.n_segments):
        in_dim, out_dim = _segment_dims(cfg, i)
        if cfg.n_hidden == 0:
            segments.append([lin(in_dim, out_dim)])
            continue
        layers = [lin(in_dim, cfg.hidden_dim)]
        layers += [lin(cfg.hidden_dim, cfg.hidden_dim) for _ in range(cfg.n_hidden - 1)]
        layers.append(lin(cfg.hidden_dim, out_dim))
        segments.append(layers)
    dir_dim = cfg.direction_encoder.output_dim
    color_in = cfg.hidden_dim + (dir_dim if cfg.delayed_direction else 0)
    color = [lin(color_in, cfg.hidden_dim // 2),
             lin(cfg.hidden_dim // 2, 3 + int(cfg.delayed_density))]
    return NerfMLP(cfg, segments, color)


def from_numpy(tree: Dict, cfg: NerfMLPConfig, device=None) -> NerfMLP:
    """The JAX package's parameter pytree (numpy or array-like leaves) ->
    NerfMLP. Layouts are identical, so this is a copy."""
    def dense(p):
        return Dense(torch.tensor(np.asarray(p["w"], np.float32), device=device),
                     torch.tensor(np.asarray(p["b"], np.float32), device=device))

    segments = [[dense(l) for l in s["layers"]] for s in tree["segments"]]
    return NerfMLP(cfg, segments, [dense(l) for l in tree["color"]])


def to_numpy(module: NerfMLP) -> Dict:
    """NerfMLP -> the JAX package's parameter pytree of numpy arrays."""
    def dense(layer):
        return {"w": layer.w.detach().cpu().numpy(), "b": layer.b.detach().cpu().numpy()}

    return {
        "segments": [{"layers": [dense(l) for l in s.layers]} for s in module.segments],
        "color": [dense(l) for l in module.color],
    }


def _apply_segment(layers, x, compute_dtype):
    """FFNN with ReLU between layers (none after the last: the inter-segment
    ReLU is the caller's, as in `forward:109-115`)."""
    h = x
    for i, layer in enumerate(layers):
        h = linear_apply(layer, h, compute_dtype)
        if i < len(layers) - 1:
            h = torch.relu(h)
    return h


def apply(
    params: NerfMLP,
    cfg: NerfMLPConfig,
    pos: torch.Tensor,
    dir: torch.Tensor,
    pixel_width: Optional[torch.Tensor] = None,
    t_start: Optional[torch.Tensor] = None,
    t_end: Optional[torch.Tensor] = None,
    alpha_pos=None,
    alpha_dir=None,
    pixel_width_sigma: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(density, rgb) for flattened samples pos/dir (B, 3); alpha_* are the
    BARF annealing scalars of the two encoders (`NerfModel.forward:96-141`);
    `pixel_width_sigma` is the scheduled extra blur of integrated (Mip)
    position encoders."""
    pos_enc = encode_position(cfg.position_encoder, pos, dir, pixel_width, t_start, t_end,
                              alpha_pos, pixel_width_sigma)
    dir_enc = cfg.direction_encoder(dir, alpha=alpha_dir)
    if cfg.compute_dtype is not None:
        pos_enc = pos_enc.to(cfg.compute_dtype)
        dir_enc = dir_enc.to(cfg.compute_dtype)

    z = pos_enc[:, :0]
    for i, segment in enumerate(params.segments):
        if not cfg.delayed_direction:
            z = torch.cat([z, dir_enc], dim=-1)
        z = _apply_segment(segment.layers, torch.cat([z, pos_enc], dim=-1),
                           cfg.compute_dtype)
        if i < cfg.n_segments - 1:
            z = torch.relu(z)

    length = z.shape[-1] - (0 if cfg.delayed_density else 1)
    if cfg.delayed_direction:
        final_input = torch.cat([z[:, :length], dir_enc], dim=-1)
    else:
        final_input = z[:, :length]

    h = torch.relu(linear_apply(params.color[0], final_input, cfg.compute_dtype))
    final_output = linear_apply(params.color[1], h, cfg.compute_dtype)

    density_raw = final_output[:, -1] if cfg.delayed_density else z[:, -1]
    # heads back to fp32: compositing stays full precision
    density = softplus8(density_raw.float())
    rgb = torch.sigmoid(final_output[:, :3].float())
    return density, rgb
