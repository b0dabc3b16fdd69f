"""Volume rendering (alpha compositing): the plain PyTorch version and the
dispatchers that send CUDA tensors to the compositing kernel.

Two call conventions of the reference are reproduced:
  * `barf/model_interpolation.py:316-353` `_render_rays`: returns (rgb, weights);
  * nerfacc `rendering` (`barf/model_garf.py:236-243`): returns rgb, opacity,
    depth and the per-sample transmittance.

`render_rays` / `render_full` are the semantic reference, the CPU path, and
the oracle that `ops/render_cuda.py` is held to; `render_bwd_reference` is
the plain version of the compositing backward kernel.
"""
from __future__ import annotations

from typing import Tuple

import torch

from nerf_experiments_tpu_torch.utils.magic import MAGIC_NUMBER

DENSITY_SCALE = 3.0 * MAGIC_NUMBER  # net effect = 1.0, kept for parity clarity


def render_weights(
    densities: torch.Tensor, dists: torch.Tensor, density_scale: float = DENSITY_SCALE
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Compositing weights from densities (N, S), dists (N, S).

    Returns (weights, alpha, trans), each (N, S):
      blocking_neg = -sigma * delta * density_scale
      alpha_i      = 1 - exp(blocking_neg_i)
      trans_i      = exp(sum_{j<i} blocking_neg_j)
      weights_i    = trans_i * alpha_i
    """
    blocking_neg = -densities * dists * density_scale
    alpha = 1.0 - torch.exp(blocking_neg)
    cum = torch.cumsum(blocking_neg, dim=-1)
    trans = torch.exp(torch.cat([torch.zeros_like(cum[:, :1]), cum[:, :-1]], dim=-1))
    return trans * alpha, alpha, trans


def render_rays(
    densities: torch.Tensor,
    colors: torch.Tensor,
    dists: torch.Tensor,
    density_scale: float = DENSITY_SCALE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """densities (N, S), colors (N, S, 3), dists (N, S) -> rgb (N, 3), weights (N, S)."""
    weights, _, _ = render_weights(densities, dists, density_scale)
    rgb = torch.sum(weights[..., None] * colors, dim=-2)
    return rgb, weights


def render_full(
    densities: torch.Tensor,
    colors: torch.Tensor,
    t_start: torch.Tensor,
    t_end: torch.Tensor,
    density_scale: float = DENSITY_SCALE,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, dict]:
    """nerfacc.rendering equivalent: rgb, opacity, depth, extras{"trans",
    "weights", "alpha"}; depth = sum_i w_i * (t_start_i + t_end_i)/2."""
    dists = t_end - t_start
    weights, alpha, trans = render_weights(densities, dists, density_scale)
    rgb = torch.sum(weights[..., None] * colors, dim=-2)
    opacity = torch.sum(weights, dim=-1, keepdim=True)
    t_mid = (t_start + t_end) / 2.0
    depth = torch.sum(weights * t_mid, dim=-1, keepdim=True)
    return rgb, opacity, depth, {"trans": trans, "weights": weights, "alpha": alpha}


def render_bwd_reference(
    densities: torch.Tensor,
    dists: torch.Tensor,
    t_mid,
    colors: torch.Tensor,
    g_weights: torch.Tensor,
    g_trans: torch.Tensor,
    g_stats: torch.Tensor,
    density_scale: float = DENSITY_SCALE,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The compositing backward written out (plain version of the kernel in
    `csrc/render.cu`): cotangents of weights and trans (N, S) and of the stats
    [r, g, b, opacity, depth] (N, 5) -> (d_densities, d_dists (N, S),
    d_colors (N, S, 3)). With b = -sigma * delta * scale:
      gw'_j = gw_j + c_j . g_rgb + g_opacity + t_j * g_depth
      db_j  = sum_{i>j} (gw'_i w_i + gT_i T_i) - gw'_j T_j exp(b_j)
    t_mid (or None for a zero depth) gets no gradient."""
    blocking = -densities * dists * density_scale
    exp_b = torch.exp(blocking)
    cum = torch.cumsum(blocking, dim=-1)
    trans = torch.exp(torch.cat([torch.zeros_like(cum[:, :1]), cum[:, :-1]], dim=-1))
    weights = trans * (1.0 - exp_b)
    g_rgb = g_stats[:, 0:3]
    gw = g_weights + torch.sum(colors * g_rgb[:, None, :], dim=-1) + g_stats[:, 3:4]
    if t_mid is not None:
        gw = gw + t_mid * g_stats[:, 4:5]
    src = gw * weights + g_trans * trans
    suffix = torch.flip(torch.cumsum(torch.flip(src, dims=[-1]), dim=-1), dims=[-1])
    after = torch.cat([suffix[:, 1:], torch.zeros_like(suffix[:, :1])], dim=-1)
    db = after - gw * trans * exp_b
    return (db * (-dists * density_scale), db * (-densities * density_scale),
            weights[..., None] * g_rgb[:, None, :])


def render_rays_auto(densities, colors, dists, density_scale: float = DENSITY_SCALE):
    """`render_rays` for CPU tensors, the compositing kernels (forward and,
    under autograd, backward) for CUDA ones."""
    from nerf_experiments_tpu_torch.ops.render_cuda import render_rays_cuda

    return render_rays_cuda(densities, colors, dists, density_scale)


def render_full_auto(densities, colors, t_start, t_end,
                     density_scale: float = DENSITY_SCALE):
    """`render_full` for CPU tensors, the compositing kernels for CUDA ones.
    On CUDA, t_mid (the depth's sample positions) gets no gradient, as in the
    JAX package's kernel VJP; the plain `render_full` differentiates depth
    through t_mid as well. Training never sees the difference: its bins are
    constants."""
    from nerf_experiments_tpu_torch.ops.render_cuda import render_full_cuda

    return render_full_cuda(densities, colors, t_start, t_end, density_scale)
