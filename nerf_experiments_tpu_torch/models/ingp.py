"""Instant-NGP-style models: the 2-D Gigapixel image fitter and the 3-D
hash-grid NeRF.

Port of `nerf_experiments_tpu/models/ingp.py`: `2d-ingp/model.py:118-176`
(Gigapixel: hash encoding -> small ReLU MLP -> sigmoid rgb) and
`3d-ingp/model.py:151-193` (NerfModelINGP: hash encoding of x/8 + 0.5 ->
density MLP (hidden+1 out, softplus(z - 1)) + Fourier direction -> colour
head). The small MLPs stay `torch.matmul` (`models/common.linear_apply`):
in the JAX package they are XLA matmuls outside any Pallas kernel; the
table access goes through `ops/hashgrid.encode` (kernels on a CUDA device).

Parameters keep the JAX package's names and (in, out) layout:
`grid.table`, `density[i].{w,b}`, `color[k].{w,b}` (NeRF) and `grid.table`,
`layers[i].{w,b}` (Gigapixel); `*_from_numpy` / `*_to_numpy` convert to and
from its pytrees.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch
from torch import nn

from nerf_experiments_tpu_torch.encodings.fourier import Fourier
from nerf_experiments_tpu_torch.models.common import Dense, linear_apply, linear_init, softplus8
from nerf_experiments_tpu_torch.ops import hashgrid

ENCODERS = ("fused", "matmul", "rolled")


def _encode(grid: hashgrid.HashGrid, grid_cfg: hashgrid.HashGridConfig, x: torch.Tensor,
            compute_dtype, encoder: str) -> torch.Tensor:
    """The JAX package's table-access switch: 'fused' and 'matmul' are the
    xor hash ('matmul' is a TPU lowering of the same row fetch), 'rolled' the
    additive hash. Rows are gathered at the compute dtype in all three."""
    if encoder not in ENCODERS:
        raise ValueError(f"unknown encoder {encoder!r}")
    return hashgrid.encode(grid, grid_cfg, x, "additive" if encoder == "rolled" else "xor",
                           gather_dtype=compute_dtype)


def _mlp(generator, dims, device):
    return [linear_init(generator, i, o, device=device) for i, o in zip(dims[:-1], dims[1:])]


def _dense_from_numpy(p, device) -> Dense:
    return Dense(torch.tensor(np.asarray(p["w"], np.float32), device=device),
                 torch.tensor(np.asarray(p["b"], np.float32), device=device))


def _dense_to_numpy(layer: Dense) -> Dict:
    return {"w": layer.w.detach().cpu().numpy(), "b": layer.b.detach().cpu().numpy()}


def _hidden_dims(in_dim: int, n_hidden: int, hidden_dim: int, out_dim: int):
    return [in_dim] + [hidden_dim] * n_hidden + [out_dim]


# ------------------------------------------------------------------ 2-D


@dataclasses.dataclass(frozen=True)
class GigapixelConfig:
    grid: hashgrid.HashGridConfig
    n_hidden: int = 2
    hidden_dim: int = 64
    compute_dtype: Any = None  # None (fp32) or torch.bfloat16
    encoder: str = "fused"  # "fused" | "matmul" | "rolled"


class Gigapixel(nn.Module):
    def __init__(self, grid: hashgrid.HashGrid, layers):
        super().__init__()
        self.grid = grid
        self.layers = nn.ModuleList(layers)


def gigapixel_init(generator: torch.Generator, cfg: GigapixelConfig, device=None) -> Gigapixel:
    """Table U(-1e-4, 1e-4), then the MLP with nn.Linear's bounds, all drawn
    from `generator`."""
    grid = hashgrid.init(generator, cfg.grid, device=device)
    dims = _hidden_dims(cfg.grid.output_dim, cfg.n_hidden, cfg.hidden_dim, 3)
    return Gigapixel(grid, _mlp(generator, dims, device))


def gigapixel_apply(params: Gigapixel, cfg: GigapixelConfig, pos: torch.Tensor) -> torch.Tensor:
    """pos (B, 2) in [0,1]^2 -> rgb (B, 3) fp32."""
    h = _encode(params.grid, cfg.grid, pos, cfg.compute_dtype, cfg.encoder)
    for i, layer in enumerate(params.layers):
        h = linear_apply(layer, h, cfg.compute_dtype)
        if i < len(params.layers) - 1:
            h = torch.relu(h)
    return torch.sigmoid(h).float()


def gigapixel_from_numpy(tree: Dict, device=None) -> Gigapixel:
    return Gigapixel(hashgrid.from_numpy(tree["grid"], device),
                     [_dense_from_numpy(l, device) for l in tree["layers"]])


def gigapixel_to_numpy(params: Gigapixel) -> Dict:
    return {"grid": hashgrid.to_numpy(params.grid),
            "layers": [_dense_to_numpy(l) for l in params.layers]}


# ------------------------------------------------------------------ 3-D


@dataclasses.dataclass(frozen=True)
class NerfINGPConfig:
    grid: hashgrid.HashGridConfig
    direction_encoder: Fourier = Fourier(levels=4, scale=1.0, space_dimensions=3)
    n_hidden: int = 2
    hidden_dim: int = 64
    pos_normalization_scale: float = 8.0  # x/8 + 0.5 (`3d-ingp/model.py:117`)
    compute_dtype: Any = None  # None (fp32) or torch.bfloat16
    encoder: str = "fused"  # "fused" | "matmul" | "rolled"


class NerfINGP(nn.Module):
    def __init__(self, grid: hashgrid.HashGrid, density, color):
        super().__init__()
        self.grid = grid
        self.density = nn.ModuleList(density)
        self.color = nn.ModuleList(color)


def nerf_ingp_init(generator: torch.Generator, cfg: NerfINGPConfig, device=None) -> NerfINGP:
    """Table, density MLP (hidden + 1 out), colour head (hidden + dir ->
    hidden/2 -> 3), drawn from `generator` in that order."""
    grid = hashgrid.init(generator, cfg.grid, device=device)
    density = _mlp(generator, _hidden_dims(cfg.grid.output_dim, cfg.n_hidden, cfg.hidden_dim,
                                           cfg.hidden_dim + 1), device)
    color = _mlp(generator, [cfg.hidden_dim + cfg.direction_encoder.output_dim,
                             cfg.hidden_dim // 2, 3], device)
    return NerfINGP(grid, density, color)


def nerf_ingp_apply(params: NerfINGP, cfg: NerfINGPConfig, pos: torch.Tensor,
                    dir: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(density (B,), rgb (B, 3)), matching `NerfModelINGP.forward:184-193`.
    With a compute dtype the heads run in it, as in the JAX package, and come
    back as fp32 values for the compositing."""
    x = pos / cfg.pos_normalization_scale + 0.5
    h = _encode(params.grid, cfg.grid, torch.clamp(x, 0.0, 1.0 - 1e-6), cfg.compute_dtype,
                cfg.encoder)
    for i, layer in enumerate(params.density):
        h = linear_apply(layer, h, cfg.compute_dtype)
        if i < len(params.density) - 1:
            h = torch.relu(h)
    density = softplus8(h[:, cfg.hidden_dim] - 1.0)
    c = torch.cat([h[:, :cfg.hidden_dim].float(), cfg.direction_encoder(dir)], dim=-1)
    c = torch.relu(linear_apply(params.color[0], c, cfg.compute_dtype))
    rgb = torch.sigmoid(linear_apply(params.color[1], c, cfg.compute_dtype))
    return density.float(), rgb.float()


def nerf_ingp_from_numpy(tree: Dict, device=None) -> NerfINGP:
    """The JAX package's {"grid": {"table"}, "density": [...], "color": [...]}."""
    return NerfINGP(hashgrid.from_numpy(tree["grid"], device),
                    [_dense_from_numpy(l, device) for l in tree["density"]],
                    [_dense_from_numpy(l, device) for l in tree["color"]])


def nerf_ingp_to_numpy(params: NerfINGP) -> Dict:
    return {"grid": hashgrid.to_numpy(params.grid),
            "density": [_dense_to_numpy(l) for l in params.density],
            "color": [_dense_to_numpy(l) for l in params.color]}
