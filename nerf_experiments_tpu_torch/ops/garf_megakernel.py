"""The GARF / GaborF / SARF radiance field's kernels:
  * `garf_radiance_render`, the wrapper of `csrc/garf_render.cu` (forward
    only), with `garf_radiance_render_reference`, its plain PyTorch version
    (`garf.radiance_apply` + `render.render_full`);
  * `garf_radiance_train_grads`, the wrapper of `csrc/garf_train.cu`
    (kernels in `garf_train.cuh`; forward, MSE gradient and full backward in one call, activation
    parameters included), with `garf_radiance_train_grads_reference`, torch
    autograd over the plain render.

Same name as the JAX package's module, whose `garf_radiance_render` and
`garf_radiance_train_grads` run the TPU kernels `_render_kernel` and
`_kernel`. Both kernels cover the fixed GARF width (`models/garf.py`) in the
three activation families, fp32 or bf16 (`GarfConfig.compute_dtype`).

A CPU tensor goes to the plain version; a CUDA tensor goes to the kernel,
or the call raises.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from nerf_experiments_tpu_torch.models import garf
from nerf_experiments_tpu_torch.ops import cuda_build, render, sampling
from nerf_experiments_tpu_torch.ops.cuda_build import (
    check_rays, device_weights, is_bf16, pointers)
from nerf_experiments_tpu_torch.ops.render import DENSITY_SCALE

ACTIVATION_IDS = {"gauss": 0, "gabor": 1, "sarf": 2}
# the kernels' activation layers follow linear layers 0, 1, 2, 3, 4, 5, 6, 8
ACT_WIDTHS = (1024, 256, 128, 128, 512, 256, 128, 256)
COT_WIDTH = 1796  # `kCotWidth` of csrc/garf_common.cuh


def _linears(params: garf.Radiance) -> List:
    """The kernels' linear-layer order: density 1, density 2, colour."""
    return [*params.density1.linear, *params.density2.linear, *params.color.linear]


def _acts(params: garf.Radiance) -> List:
    return [*params.density1.act, *params.density2.act, *params.color.act]


def _linear_names() -> List[str]:
    return ([f"density1.linear.{i}" for i in range(4)]
            + [f"density2.linear.{i}" for i in range(4)]
            + [f"color.linear.{i}" for i in range(2)])


def _act_names() -> List[str]:
    return ([f"density1.act.{i}" for i in range(4)]
            + [f"density2.act.{i}" for i in range(3)] + ["color.act.0"])


def _positions(origs, dirs, t_start, t_end):
    n, s = t_start.shape
    t_q = sampling.t_query(t_start, t_end, "middle")
    pos = origs[:, None, :] + t_q[..., None] * dirs[:, None, :]
    return pos.reshape(n * s, 3), dirs[:, None, :].expand(n, s, 3).reshape(n * s, 3)


def garf_radiance_render_reference(
    params: garf.Radiance,
    cfg: garf.GarfConfig,
    origs: torch.Tensor,
    dirs: torch.Tensor,
    t_start: torch.Tensor,
    t_end: torch.Tensor,
    act_anneal=1.0,
    density_scale: float = DENSITY_SCALE,
    return_weights: bool = False,
):
    """Plain version: middle-point positions -> `garf.radiance_apply` ->
    `render.render_full`. Returns (rgb (N,3), opacity (N,1), depth (N,1)
    [, weights (N,S)])."""
    n, s = t_start.shape
    pos, dirs_rep = _positions(origs, dirs, t_start, t_end)
    rgb_s, density_s = garf.radiance_apply(params, cfg, pos, dirs_rep, act_anneal)
    rgb, opacity, depth, extras = render.render_full(
        density_s.reshape(n, s), rgb_s.reshape(n, s, 3), t_start, t_end, density_scale)
    if return_weights:
        return rgb, opacity, depth, extras["weights"]
    return rgb, opacity, depth


def _activation_id(cfg: garf.GarfConfig) -> int:
    if cfg.activation not in ACTIVATION_IDS:
        raise ValueError(f"unknown activation {cfg.activation!r}")
    return ACTIVATION_IDS[cfg.activation]


def _kernel_params(params: garf.Radiance, cfg: garf.GarfConfig, dev, bf16: bool):
    """Weights in the compute type, fp32 biases and activation parameters,
    contiguous on `dev`; p2 (spread) is None unless gabor."""
    ws, bs = device_weights(_linears(params), dev, bf16)
    name1 = garf.ACT_PARAMS[cfg.activation][0]
    p1 = [getattr(a, name1).detach().to(dev, torch.float32).contiguous() for a in _acts(params)]
    p2 = [a.spread.detach().to(dev, torch.float32).contiguous() if cfg.activation == "gabor"
          else None for a in _acts(params)]
    return ws, bs, p1, p2


def garf_radiance_render(
    params: garf.Radiance,
    cfg: garf.GarfConfig,
    origs: torch.Tensor,      # (N, 3)
    dirs: torch.Tensor,       # (N, 3)
    t_start: torch.Tensor,    # (N, S)
    t_end: torch.Tensor,      # (N, S)
    act_anneal=1.0,
    density_scale: float = DENSITY_SCALE,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Forward-only render with middle-point integration: (rgb (N,3),
    opacity (N,1), depth (N,1)). No gradient: eval contexts (training takes
    `garf_radiance_train_grads`)."""
    if origs.device.type != "cuda":
        return garf_radiance_render_reference(params, cfg, origs, dirs, t_start, t_end,
                                              act_anneal, density_scale)
    n, s = t_start.shape
    dev = origs.device
    check_rays(n, s, dev, origs=origs, dirs=dirs, t_start=t_start, t_end=t_end)
    bf16 = is_bf16(cfg)
    act_id = _activation_id(cfg)
    lib = cuda_build.library()
    ws, bs, p1, p2 = _kernel_params(params, cfg, dev, bf16)
    out = torch.empty((n, 5), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.netpu_garf_render(
            origs.data_ptr(), dirs.data_ptr(), t_start.data_ptr(), t_end.data_ptr(),
            pointers(ws), pointers(bs), pointers(p1), pointers(p2), act_id, int(bf16),
            n, s, float(act_anneal), float(density_scale), out.data_ptr(), stream)
    cuda_build.check(code, "netpu_garf_render")
    garf_radiance_render.launches += 1
    return out[:, 0:3], out[:, 3:4], out[:, 4:5]


garf_radiance_render.launches = 0


def garf_radiance_train_grads_reference(
    params: garf.Radiance,
    cfg: garf.GarfConfig,
    origs: torch.Tensor,
    dirs: torch.Tensor,
    t_start: torch.Tensor,
    t_end: torch.Tensor,
    targets: torch.Tensor,
    act_anneal=1.0,
    density_scale: float = DENSITY_SCALE,
):
    """Plain version of `garf_radiance_train_grads`: torch autograd over
    `garf_radiance_render_reference` and loss = mean((rgb - targets)^2).
    The parameters' `.grad` is left alone."""
    names, leaves = zip(*params.named_parameters())
    with torch.enable_grad():
        o = origs.detach().requires_grad_(True)
        d = dirs.detach().requires_grad_(True)
        rgb, _, _, weights = garf_radiance_render_reference(
            params, cfg, o, d, t_start, t_end, act_anneal, density_scale, return_weights=True)
        loss = torch.mean((rgb - targets) ** 2)
        grads = torch.autograd.grad(loss, leaves + (o, d))
    return (rgb.detach(), weights.detach(), dict(zip(names, grads[:-2])), grads[-2],
            grads[-1])


def train_layout(cfg: garf.GarfConfig) -> Dict[str, int]:
    """Widths of `csrc/garf_train.cu`'s workspaces: the activation workspace
    per row (pos, dir, a and x of activation layers 1..7 plus the gabor /
    sarf factors, ci), the cotangent workspace per row, the per-ray partials
    (layer 0's dW and db, every activation parameter), phase B's per-split
    partials, and the gradient count."""
    record = 2 if cfg.activation == "gauss" else 4
    per_feature = 2 if cfg.activation == "gabor" else 1
    dims = garf.RADIANCE_D1_DIMS + garf.RADIANCE_D2_DIMS + garf.RADIANCE_COLOR_DIMS
    n_w = sum(i * o for i, o in dims)
    n_b = sum(o for _, o in dims)
    return {"act": 6 + record * sum(ACT_WIDTHS[1:]) + 128, "cot": COT_WIDTH,
            "ray_part": 4096 + per_feature * sum(ACT_WIDTHS),
            "split_part": n_w + n_b - 3 * 1024 - 1024,
            "grads": n_w + n_b + per_feature * sum(ACT_WIDTHS)}


def _splits(rows: int) -> int:
    """Phase B splits the rows into fixed partials, added in a fixed order."""
    return max(1, min(64, math.ceil(rows / 16384)))


def train_workspace_bytes(cfg: garf.GarfConfig, n_rays: int, n_samples: int) -> int:
    """Device memory `garf_radiance_train_grads` allocates for its workspaces
    and partials."""
    lay = train_layout(cfg)
    act_bytes = 2 if cfg.compute_dtype == torch.bfloat16 else 4
    rows = n_rays * n_samples
    return (rows * (lay["act"] * act_bytes + (lay["cot"] + 6) * 4)
            + n_rays * lay["ray_part"] * 4 + _splits(rows) * lay["split_part"] * 4)


def _unflatten(flat: torch.Tensor, params: garf.Radiance, cfg: garf.GarfConfig):
    """The kernel's flat gradient (every dW (in, out) in layer order, every
    db, then each activation layer's p1 [and p2]) -> {parameter name: view}."""
    grads, off = {}, 0
    lins = list(zip(_linear_names(), _linears(params)))
    for name, l in lins:
        grads[f"{name}.w"] = flat[off:off + l.w.numel()].view(l.w.shape)
        off += l.w.numel()
    for name, l in lins:
        grads[f"{name}.b"] = flat[off:off + l.b.numel()].view(l.b.shape)
        off += l.b.numel()
    for name, width in zip(_act_names(), ACT_WIDTHS):
        for pname in garf.ACT_PARAMS[cfg.activation]:
            grads[f"{name}.{pname}"] = flat[off:off + width]
            off += width
    assert off == flat.numel()
    return grads


def garf_radiance_train_grads(
    params: garf.Radiance,
    cfg: garf.GarfConfig,
    origs: torch.Tensor,      # (N, 3)
    dirs: torch.Tensor,       # (N, 3)
    t_start: torch.Tensor,    # (N, S)
    t_end: torch.Tensor,      # (N, S)
    targets: torch.Tensor,    # (N, 3)
    act_anneal=1.0,
    density_scale: float = DENSITY_SCALE,
):
    """One call of the training kernel for loss = mean((rgb - targets)^2) over
    (N, 3), middle-point integration: (rgb (N,3), weights (N,S), grads,
    d_origs (N,3), d_dirs (N,3)). `grads` maps each name of
    `params.named_parameters()` (every W, b and activation parameter) to its
    fp32 gradient, a view of one flat buffer, ready to be set as `.grad`;
    `weights` are the compositing weights for the interlevel loss. No
    gradient flows into act_anneal, t_start or t_end."""
    if origs.device.type != "cuda":
        return garf_radiance_train_grads_reference(params, cfg, origs, dirs, t_start, t_end,
                                                   targets, act_anneal, density_scale)
    n, s = t_start.shape
    dev = origs.device
    check_rays(n, s, dev, origs=origs, dirs=dirs, t_start=t_start, t_end=t_end,
               targets=targets)
    bf16 = is_bf16(cfg)
    act_id = _activation_id(cfg)
    lib = cuda_build.library()
    ws, bs, p1, p2 = _kernel_params(params, cfg, dev, bf16)
    wts = [w.t().contiguous() for w in ws]
    lay = train_layout(cfg)
    rows = n * s
    splits = _splits(rows)
    f32 = dict(dtype=torch.float32, device=dev)
    act = torch.empty((rows, lay["act"]), dtype=torch.bfloat16 if bf16 else torch.float32,
                      device=dev)
    cot = torch.empty((rows, lay["cot"]), **f32)
    aux = torch.empty((rows, 6), **f32)
    ray_part = torch.empty((n, lay["ray_part"]), **f32)
    part = torch.empty((splits, lay["split_part"]), **f32)
    flat = torch.empty((lay["grads"],), **f32)
    rgb = torch.empty((n, 3), **f32)
    weights = torch.empty((n, s), **f32)
    d_origs = torch.empty((n, 3), **f32)
    d_dirs = torch.empty((n, 3), **f32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.netpu_garf_train(
            origs.data_ptr(), dirs.data_ptr(), t_start.data_ptr(), t_end.data_ptr(),
            targets.data_ptr(), pointers(ws), pointers(bs), pointers(wts), pointers(p1),
            pointers(p2), act_id, int(bf16), n, s, float(act_anneal), float(density_scale),
            2.0 / (n * 3.0), act.data_ptr(), cot.data_ptr(), aux.data_ptr(),
            ray_part.data_ptr(), lay["act"], lay["cot"], lay["ray_part"], part.data_ptr(),
            splits, flat.data_ptr(), rgb.data_ptr(), weights.data_ptr(), d_origs.data_ptr(),
            d_dirs.data_ptr(), stream)
    cuda_build.check(code, "netpu_garf_train")
    garf_radiance_train_grads.launches += 1
    return rgb, weights, _unflatten(flat, params, cfg), d_origs, d_dirs


garf_radiance_train_grads.launches = 0
