"""The flagship BARF radiance field's kernels:
  * `flagship_render`, the wrapper of `csrc/flagship_render.cu` (forward
    only), with `flagship_render_reference`, its plain PyTorch version
    (`nerf_mlp.apply` + `render.render_full`);
  * `flagship_train_grads`, the wrapper of `csrc/flagship_train.cu`
    (forward, MSE gradient and full backward in one call), with
    `flagship_train_grads_reference`, torch autograd over
    `flagship_render_reference`.

Same name as the JAX package's module, whose `flagship_render` and
`flagship_train_grads` run the TPU kernels `_render_kernel` and `_kernel`.

A CPU tensor goes to the plain version; a CUDA tensor goes to the kernel,
or the call raises.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from nerf_experiments_tpu_torch.encodings.fourier import Barf
from nerf_experiments_tpu_torch.models import nerf_mlp
from nerf_experiments_tpu_torch.ops import cuda_build, render, sampling
from nerf_experiments_tpu_torch.ops.cuda_build import (
    check_rays, device_weights, is_bf16, pointers)
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


def _layer_names(params: nerf_mlp.NerfMLP):
    """`named_parameters` prefixes of `_layers(params)`, in the same order."""
    names = [f"segments.{i}.layers.{j}" for i, seg in enumerate(params.segments)
             for j in range(len(seg.layers))]
    return names + [f"color.{k}" for k in range(len(params.color))]


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
    compositing weights. No gradient: eval and serving (training takes
    `flagship_train_grads`)."""
    if not is_flagship(cfg):
        raise ValueError("flagship_render supports the canonical BARF config only")
    pe, de = cfg.position_encoder, cfg.direction_encoder
    alpha_pos = float(pe.levels) if alpha_pos is None else float(alpha_pos)
    alpha_dir = float(de.levels) if alpha_dir is None else float(alpha_dir)
    if origs.device.type != "cuda":
        return flagship_render_reference(
            params, cfg, origs, dirs, t_start, t_end, alpha_pos, alpha_dir,
            density_scale, return_weights)

    out = launch_render_kernel(params, cfg, origs, dirs, t_start, t_end, alpha_pos, alpha_dir,
                               density_scale, return_weights)
    flagship_render.launches += 1
    return out


flagship_render.launches = 0


def launch_render_kernel(params, cfg, origs, dirs, t_start, t_end, alpha_pos: float,
                         alpha_dir: float, density_scale: float, return_weights: bool = False):
    """One launch of `netpu_flagship_render` (csrc/flagship_render.cu) on CUDA
    tensors, as `flagship_render` returns its result. Shared by the two
    wrappers of the kernel, which count their own launches:
    `flagship_render` and `render_megakernel.flagship_render`."""
    pe, de = cfg.position_encoder, cfg.direction_encoder
    layers = _layers(params)
    n, s = t_start.shape
    dev = origs.device
    check_rays(n, s, dev, origs=origs, dirs=dirs, t_start=t_start, t_end=t_end)
    bf16 = is_bf16(cfg)
    lib = cuda_build.library()
    ws, bs = device_weights(layers, dev, bf16)
    D = params.segments[0].layers[0].w.shape[1]
    C = params.color[0].w.shape[1]

    out = torch.empty((n, 5), dtype=torch.float32, device=dev)
    weights = torch.empty((n, s), dtype=torch.float32, device=dev) if return_weights else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.netpu_flagship_render(
            origs.data_ptr(), dirs.data_ptr(), t_start.data_ptr(), t_end.data_ptr(),
            pointers(ws), pointers(bs),
            len(layers), int(bf16), n, s, cfg.n_hidden, D, C, pe.levels, de.levels,
            float(pe.scale), float(alpha_pos), float(alpha_dir), float(density_scale),
            out.data_ptr(), None if weights is None else weights.data_ptr(), stream)
    cuda_build.check(code, "netpu_flagship_render")
    if return_weights:
        return out[:, 0:3], out[:, 3:4], out[:, 4:5], weights
    return out[:, 0:3], out[:, 3:4], out[:, 4:5]


def flagship_train_grads_reference(
    params: nerf_mlp.NerfMLP,
    cfg: nerf_mlp.NerfMLPConfig,
    origs: torch.Tensor,
    dirs: torch.Tensor,
    t_start: torch.Tensor,
    t_end: torch.Tensor,
    targets: torch.Tensor,
    alpha_pos,
    alpha_dir,
    loss_scale: float = 1.0,
    return_weights: bool = False,
    density_scale: float = DENSITY_SCALE,
):
    """Plain version of `flagship_train_grads`: torch autograd over
    `flagship_render_reference` and loss = loss_scale * mean((rgb -
    targets)^2). The parameters' `.grad` is left alone."""
    names, leaves = zip(*params.named_parameters())
    with torch.enable_grad():
        o = origs.detach().requires_grad_(True)
        d = dirs.detach().requires_grad_(True)
        rgb, _, _, weights = flagship_render_reference(
            params, cfg, o, d, t_start, t_end, alpha_pos, alpha_dir, density_scale,
            return_weights=True)
        loss = loss_scale * torch.mean((rgb - targets) ** 2)
        grads = torch.autograd.grad(loss, leaves + (o, d))
    out = (rgb.detach(), dict(zip(names, grads[:-2])), grads[-2], grads[-1])
    return out + (weights.detach(),) if return_weights else out


def _train_layout(cfg: nerf_mlp.NerfMLPConfig, D: int, C: int):
    """Widths of the kernel's workspaces (the `Layout` of
    `csrc/flagship_train.cu`): activations and cotangents per sample row,
    ReLU mask words per 32-row chunk."""
    P = 3 + 6 * cfg.position_encoder.levels
    Q = 3 + 6 * cfg.direction_encoder.levels
    L = cfg.n_hidden + 1
    return P + Q + 2 * L * D + C, 2 * L * D + 1 + C + 3, (2 * L - 1) * D + C


def train_workspace_bytes(cfg: nerf_mlp.NerfMLPConfig, n_rays: int, n_samples: int,
                          D: int, C: int) -> int:
    """Device memory `flagship_train_grads` allocates for its workspaces."""
    act_w, cot_w, mask_w = _train_layout(cfg, D, C)
    act_bytes = 2 if cfg.compute_dtype == torch.bfloat16 else 4
    chunks = n_rays * math.ceil(n_samples / 32)
    return n_rays * n_samples * (act_w * act_bytes + (cot_w + 6) * 4) + chunks * mask_w * 4


def flagship_train_grads(
    params: nerf_mlp.NerfMLP,
    cfg: nerf_mlp.NerfMLPConfig,
    origs: torch.Tensor,      # (N, 3)
    dirs: torch.Tensor,       # (N, 3)
    t_start: torch.Tensor,    # (N, S)
    t_end: torch.Tensor,      # (N, S)
    targets: torch.Tensor,    # (N, 3)
    alpha_pos,
    alpha_dir,
    loss_scale: float = 1.0,
    return_weights: bool = False,
    density_scale: float = DENSITY_SCALE,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], torch.Tensor, torch.Tensor]:
    """One call of the training kernel for loss = loss_scale * mean((rgb -
    targets)^2) over (N, 3), middle-point integration: (rgb (N,3), grads,
    d_origs (N,3), d_dirs (N,3)[, weights (N,S)]). `grads` maps each name of
    `params.named_parameters()` to its fp32 gradient, a view of one flat
    buffer, ready to be set as `.grad`. No gradient flows into alpha_*,
    t_start or t_end."""
    if not is_flagship(cfg):
        raise ValueError("flagship_train_grads supports the canonical BARF config only")
    pe, de = cfg.position_encoder, cfg.direction_encoder
    if origs.device.type != "cuda":
        return flagship_train_grads_reference(
            params, cfg, origs, dirs, t_start, t_end, targets, alpha_pos, alpha_dir,
            loss_scale, return_weights, density_scale)

    layers = _layers(params)
    n, s = t_start.shape
    dev = origs.device
    check_rays(n, s, dev, origs=origs, dirs=dirs, t_start=t_start, t_end=t_end,
               targets=targets)
    bf16 = is_bf16(cfg)
    lib = cuda_build.library()
    ws, bs = device_weights(layers, dev, bf16)
    wts = [w.t().contiguous() for w in ws]
    D = params.segments[0].layers[0].w.shape[1]
    C = params.color[0].w.shape[1]
    act_w, cot_w, mask_w = _train_layout(cfg, D, C)
    rows = n * s
    # phase B splits the rows into fixed partials, added in a fixed order
    splits = max(1, min(64, math.ceil(rows / 16384)))
    n_grads = sum(w.numel() + b.numel() for w, b in zip(ws, bs))
    f32 = dict(dtype=torch.float32, device=dev)
    act = torch.empty((rows, act_w), dtype=torch.bfloat16 if bf16 else torch.float32,
                      device=dev)
    cot = torch.empty((rows, cot_w), **f32)
    aux = torch.empty((rows, 6), **f32)
    masks = torch.empty((n * math.ceil(s / 32), mask_w), dtype=torch.int32, device=dev)
    part = torch.empty((splits, n_grads), **f32)
    flat = torch.empty((n_grads,), **f32)
    rgb = torch.empty((n, 3), **f32)
    d_origs = torch.empty((n, 3), **f32)
    d_dirs = torch.empty((n, 3), **f32)
    weights = torch.empty((n, s), **f32) if return_weights else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.netpu_flagship_train(
            origs.data_ptr(), dirs.data_ptr(), t_start.data_ptr(), t_end.data_ptr(),
            targets.data_ptr(), pointers(ws), pointers(bs), pointers(wts),
            len(layers), int(bf16), n, s, cfg.n_hidden, D, C, pe.levels, de.levels,
            float(pe.scale), float(alpha_pos), float(alpha_dir), float(density_scale),
            2.0 * float(loss_scale) / (n * 3.0), act.data_ptr(), cot.data_ptr(),
            aux.data_ptr(), masks.data_ptr(), act_w, cot_w, part.data_ptr(), splits,
            flat.data_ptr(),
            rgb.data_ptr(), d_origs.data_ptr(), d_dirs.data_ptr(),
            None if weights is None else weights.data_ptr(), stream)
    cuda_build.check(code, "netpu_flagship_train")
    flagship_train_grads.launches += 1

    # flat = every dW (in, out) in layer order, then every db
    grads, w_off, b_off = {}, 0, sum(w.numel() for w in ws)
    for name, w, b in zip(_layer_names(params), ws, bs):
        grads[f"{name}.w"] = flat[w_off:w_off + w.numel()].view(w.shape)
        grads[f"{name}.b"] = flat[b_off:b_off + b.numel()].view(b.shape)
        w_off += w.numel()
        b_off += b.numel()
    out = (rgb, grads, d_origs, d_dirs)
    return out + (weights,) if return_weights else out


flagship_train_grads.launches = 0
