"""Wrapper of the compositing kernel `csrc/render.cu` (the counterpart of the
JAX package's `ops/render_pallas.py`).

A CPU tensor goes to the plain version in `ops/render.py`; a CUDA tensor goes
to the kernel, or the call raises. The backward kernel comes with training,
so a CUDA input that requires grad is refused.
"""
from __future__ import annotations

from typing import Tuple

import torch

from nerf_experiments_tpu_torch.ops import cuda_build, render
from nerf_experiments_tpu_torch.ops.render import DENSITY_SCALE


def _on_cuda(*tensors: torch.Tensor) -> bool:
    if tensors[0].device.type != "cuda":
        return False
    if any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "the compositing backward kernel is not ported yet: CUDA inputs "
            "to the compositing kernel must not require grad")
    return True


def _check(name: str, t: torch.Tensor, shape, device) -> None:
    if t.dtype != torch.float32 or t.device != device:
        raise ValueError(f"{name}: need float32 on {device}, got {t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: need shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def render_fwd_cuda(densities, dists, t_mid, colors, density_scale):
    """One launch of the kernel: (weights (N,S), trans (N,S), stats (N,5))."""
    n, s = densities.shape
    dev = densities.device
    _check("densities", densities, (n, s), dev)
    _check("dists", dists, (n, s), dev)
    _check("colors", colors, (n, s, 3), dev)
    if t_mid is not None:
        _check("t_mid", t_mid, (n, s), dev)
    weights = torch.empty((n, s), dtype=torch.float32, device=dev)
    trans = torch.empty((n, s), dtype=torch.float32, device=dev)
    stats = torch.empty((n, 5), dtype=torch.float32, device=dev)
    lib = cuda_build.library()
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


def render_full_cuda(
    densities: torch.Tensor,
    colors: torch.Tensor,
    t_start: torch.Tensor,
    t_end: torch.Tensor,
    density_scale: float = DENSITY_SCALE,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, dict]:
    """Drop-in for `render.render_full`: rgb, opacity, depth,
    extras{"trans", "weights"}."""
    if not _on_cuda(densities, colors, t_start, t_end):
        return render.render_full(densities, colors, t_start, t_end, density_scale)
    dists = t_end - t_start
    t_mid = (t_start + t_end) / 2.0
    weights, trans, stats = render_fwd_cuda(
        densities, dists, t_mid, colors, density_scale)
    return stats[:, 0:3], stats[:, 3:4], stats[:, 4:5], {"trans": trans, "weights": weights}


def render_rays_cuda(
    densities: torch.Tensor,
    colors: torch.Tensor,
    dists: torch.Tensor,
    density_scale: float = DENSITY_SCALE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop-in for `render.render_rays`: (rgb, weights)."""
    if not _on_cuda(densities, colors, dists):
        return render.render_rays(densities, colors, dists, density_scale)
    weights, _, stats = render_fwd_cuda(densities, dists, None, colors, density_scale)
    return stats[:, 0:3], weights
