"""Wrappers of the compositing kernels `csrc/render.cu` (the counterpart of
the JAX package's `ops/render_pallas.py`): the forward `render_fwd_cuda`, the
backward `render_bwd_cuda`, and `Composite`, the autograd function over the
two.

A CPU tensor goes to the plain version in `ops/render.py`; a CUDA tensor goes
to the kernels, or the call raises.
"""
from __future__ import annotations

from typing import Tuple

import torch

from nerf_experiments_tpu_torch.ops import cuda_build, render
from nerf_experiments_tpu_torch.ops.render import DENSITY_SCALE


def _check_inputs(densities, dists, t_mid, colors):
    n, s = densities.shape
    dev = densities.device
    cuda_build.check_tensor("densities", densities, (n, s), dev)
    cuda_build.check_tensor("dists", dists, (n, s), dev)
    cuda_build.check_tensor("colors", colors, (n, s, 3), dev)
    if t_mid is not None:
        cuda_build.check_tensor("t_mid", t_mid, (n, s), dev)
    return n, s, dev


def render_fwd_cuda(densities, dists, t_mid, colors, density_scale):
    """One launch of the forward kernel: (weights (N,S), trans (N,S), stats
    (N,5) = [r, g, b, opacity, depth])."""
    n, s, dev = _check_inputs(densities, dists, t_mid, colors)
    lib = cuda_build.library()
    weights = torch.empty((n, s), dtype=torch.float32, device=dev)
    trans = torch.empty((n, s), dtype=torch.float32, device=dev)
    stats = torch.empty((n, 5), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.netpu_render_fwd(
            densities.data_ptr(), dists.data_ptr(),
            None if t_mid is None else t_mid.data_ptr(), colors.data_ptr(),
            weights.data_ptr(), trans.data_ptr(), stats.data_ptr(),
            n, s, float(density_scale), stream)
    cuda_build.check(code, "netpu_render_fwd")
    render_fwd_cuda.launches += 1
    return weights, trans, stats


render_fwd_cuda.launches = 0


def render_bwd_cuda(densities, dists, t_mid, colors, g_weights, g_trans, g_stats,
                    density_scale):
    """One launch of the backward kernel: (d_densities, d_dists (N,S),
    d_colors (N,S,3)); the plain version is `render.render_bwd_reference`."""
    n, s, dev = _check_inputs(densities, dists, t_mid, colors)
    cuda_build.check_tensor("g_weights", g_weights, (n, s), dev)
    cuda_build.check_tensor("g_trans", g_trans, (n, s), dev)
    cuda_build.check_tensor("g_stats", g_stats, (n, 5), dev)
    lib = cuda_build.library()
    ddens = torch.empty((n, s), dtype=torch.float32, device=dev)
    ddists = torch.empty((n, s), dtype=torch.float32, device=dev)
    dcolors = torch.empty((n, s, 3), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.netpu_render_bwd(
            densities.data_ptr(), dists.data_ptr(),
            None if t_mid is None else t_mid.data_ptr(), colors.data_ptr(),
            g_weights.data_ptr(), g_trans.data_ptr(), g_stats.data_ptr(),
            ddens.data_ptr(), ddists.data_ptr(), dcolors.data_ptr(),
            n, s, float(density_scale), stream)
    cuda_build.check(code, "netpu_render_bwd")
    render_bwd_cuda.launches += 1
    return ddens, ddists, dcolors


render_bwd_cuda.launches = 0


class Composite(torch.autograd.Function):
    """(densities, dists, t_mid | None, colors) -> (weights, trans, stats):
    the forward kernel, and the backward kernel under autograd. t_mid gets no
    gradient (the JAX package's `_render_core` VJP does the same)."""

    @staticmethod
    def forward(ctx, densities, dists, t_mid, colors, density_scale):
        ctx.save_for_backward(densities, dists, t_mid, colors)
        ctx.density_scale = density_scale
        return render_fwd_cuda(densities, dists, t_mid, colors, density_scale)

    @staticmethod
    def backward(ctx, g_weights, g_trans, g_stats):
        densities, dists, t_mid, colors = ctx.saved_tensors
        ddens, ddists, dcolors = render_bwd_cuda(
            densities, dists, t_mid, colors, g_weights.contiguous(), g_trans.contiguous(),
            g_stats.contiguous(), ctx.density_scale)
        return ddens, ddists, None, dcolors, None


def render_full_cuda(
    densities: torch.Tensor,
    colors: torch.Tensor,
    t_start: torch.Tensor,
    t_end: torch.Tensor,
    density_scale: float = DENSITY_SCALE,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, dict]:
    """Drop-in for `render.render_full`: rgb, opacity, depth,
    extras{"trans", "weights"}."""
    if densities.device.type != "cuda":
        return render.render_full(densities, colors, t_start, t_end, density_scale)
    dists = t_end - t_start
    t_mid = (t_start + t_end) / 2.0
    weights, trans, stats = Composite.apply(
        densities.contiguous(), dists, t_mid.detach(), colors.contiguous(), density_scale)
    return stats[:, 0:3], stats[:, 3:4], stats[:, 4:5], {"trans": trans, "weights": weights}


def render_rays_cuda(
    densities: torch.Tensor,
    colors: torch.Tensor,
    dists: torch.Tensor,
    density_scale: float = DENSITY_SCALE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop-in for `render.render_rays`: (rgb, weights)."""
    if densities.device.type != "cuda":
        return render.render_rays(densities, colors, dists, density_scale)
    weights, _, stats = Composite.apply(
        densities.contiguous(), dists.contiguous(), None, colors.contiguous(), density_scale)
    return stats[:, 0:3], weights
