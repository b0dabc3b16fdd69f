"""The flagship BARF radiance field's render: `flagship_render`, the wrapper
of the kernel `csrc/flagship_render.cu`, and `flagship_render_reference`, its
plain PyTorch version (`nerf_mlp.apply` + `render.render_full`).

Same name as the JAX package's module, whose `flagship_render` runs the TPU
kernel `_render_kernel`. The training entry points (`flagship_train_grads`
and its backward kernel) come with the training slice of the port.

A CPU tensor goes to the plain version; a CUDA tensor goes to the kernel,
or the call raises.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from nerf_experiments_tpu_torch.encodings.fourier import Barf
from nerf_experiments_tpu_torch.models import nerf_mlp
from nerf_experiments_tpu_torch.ops import cuda_build, render, sampling
from nerf_experiments_tpu_torch.ops.render import DENSITY_SCALE


def is_flagship(cfg: nerf_mlp.NerfMLPConfig) -> bool:
    """The architecture the kernel covers: Barf encoders with identity and
    one scale, 2 segments, delayed direction, immediate density."""
    pe, de = cfg.position_encoder, cfg.direction_encoder
    return (
        isinstance(pe, Barf) and isinstance(de, Barf)
        and pe.include_identity and de.include_identity
        and cfg.n_segments == 2 and cfg.delayed_direction
        and not cfg.delayed_density and pe.scale == de.scale
        and cfg.n_hidden >= 1
    )


def flagship_render_reference(
    params: nerf_mlp.NerfMLP,
    cfg: nerf_mlp.NerfMLPConfig,
    origs: torch.Tensor,
    dirs: torch.Tensor,
    t_start: torch.Tensor,
    t_end: torch.Tensor,
    alpha_pos,
    alpha_dir,
    density_scale: float = DENSITY_SCALE,
    return_weights: bool = False,
):
    """Plain version: middle-point positions -> `nerf_mlp.apply` ->
    `render.render_full`. Returns (rgb (N,3), opacity (N,1), depth (N,1)
    [, weights (N,S)])."""
    n, s = t_start.shape
    t_q = sampling.t_query(t_start, t_end, "middle")
    pos = origs[:, None, :] + t_q[..., None] * dirs[:, None, :]
    dirs_rep = dirs[:, None, :].expand(n, s, 3)
    density, rgb = nerf_mlp.apply(
        params, cfg, pos.reshape(n * s, 3), dirs_rep.reshape(n * s, 3),
        alpha_pos=alpha_pos, alpha_dir=alpha_dir)
    out_rgb, opacity, depth, extras = render.render_full(
        density.reshape(n, s), rgb.reshape(n, s, 3), t_start, t_end, density_scale)
    if return_weights:
        return out_rgb, opacity, depth, extras["weights"]
    return out_rgb, opacity, depth


def _layers(params: nerf_mlp.NerfMLP):
    """The kernel's layer order: segment 1, segment 2, colour head."""
    return [l for seg in params.segments for l in seg.layers] + list(params.color)


def flagship_render(
    params: nerf_mlp.NerfMLP,
    cfg: nerf_mlp.NerfMLPConfig,
    origs: torch.Tensor,      # (N, 3)
    dirs: torch.Tensor,       # (N, 3)
    t_start: torch.Tensor,    # (N, S)
    t_end: torch.Tensor,      # (N, S)
    alpha_pos=None,
    alpha_dir=None,
    density_scale: float = DENSITY_SCALE,
    return_weights: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """Forward-only render with middle-point integration: (rgb (N,3),
    opacity (N,1), depth (N,1)) and, with return_weights, the (N, S)
    compositing weights. No gradient: eval and serving only."""
    if not is_flagship(cfg):
        raise ValueError("flagship_render supports the canonical BARF config only")
    pe, de = cfg.position_encoder, cfg.direction_encoder
    alpha_pos = float(pe.levels) if alpha_pos is None else float(alpha_pos)
    alpha_dir = float(de.levels) if alpha_dir is None else float(alpha_dir)
    if origs.device.type != "cuda":
        return flagship_render_reference(
            params, cfg, origs, dirs, t_start, t_end, alpha_pos, alpha_dir,
            density_scale, return_weights)

    layers = _layers(params)
    if any(t.requires_grad for t in (origs, dirs, t_start, t_end)):
        raise NotImplementedError(
            "flagship_render has no backward kernel: pass tensors that do not "
            "require grad")
    n, s = t_start.shape
    dev = origs.device
    for name, t, shape in (("origs", origs, (n, 3)), ("dirs", dirs, (n, 3)),
                           ("t_start", t_start, (n, s)), ("t_end", t_end, (n, s))):
        if t.dtype != torch.float32 or t.device != dev:
            raise ValueError(f"{name}: need float32 on {dev}, got {t.dtype} on {t.device}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name}: need a contiguous {shape}, got {tuple(t.shape)}")
    if cfg.compute_dtype not in (None, torch.bfloat16):
        raise ValueError(f"compute_dtype {cfg.compute_dtype} is not supported")
    bf16 = cfg.compute_dtype == torch.bfloat16
    wdt = torch.bfloat16 if bf16 else torch.float32
    ws = [l.w.detach().to(dev, wdt).contiguous() for l in layers]
    bs = [l.b.detach().to(dev, torch.float32).contiguous() for l in layers]
    D = params.segments[0].layers[0].w.shape[1]
    C = params.color[0].w.shape[1]

    out = torch.empty((n, 5), dtype=torch.float32, device=dev)
    weights = torch.empty((n, s), dtype=torch.float32, device=dev) if return_weights else None
    w_ptrs = (ctypes.c_void_p * len(ws))(*[w.data_ptr() for w in ws])
    b_ptrs = (ctypes.c_void_p * len(bs))(*[b.data_ptr() for b in bs])
    lib = cuda_build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.netpu_flagship_render(
            origs.data_ptr(), dirs.data_ptr(), t_start.data_ptr(), t_end.data_ptr(),
            ctypes.cast(w_ptrs, ctypes.c_void_p), ctypes.cast(b_ptrs, ctypes.c_void_p),
            len(layers), int(bf16), n, s, cfg.n_hidden, D, C, pe.levels, de.levels,
            float(pe.scale), alpha_pos, alpha_dir, float(density_scale),
            out.data_ptr(), None if weights is None else weights.data_ptr(), stream)
    cuda_build.check(code, "netpu_flagship_render")
    flagship_render.launches += 1
    if return_weights:
        return out[:, 0:3], out[:, 3:4], out[:, 4:5], weights
    return out[:, 0:3], out[:, 3:4], out[:, 4:5]


flagship_render.launches = 0
