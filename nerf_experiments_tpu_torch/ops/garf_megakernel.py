"""The GARF / GaborF / SARF radiance field's kernels:
  * `garf_radiance_render`, the wrapper of `csrc/garf_render.cu` (K6,
    forward only), with `garf_radiance_render_reference`, its plain PyTorch
    version (`garf.radiance_apply` + `render.render_full`);
  * `garf_radiance_train_grads`, the wrapper of `csrc/garf_train.cu` (K5,
    kernels in `garf_train.cuh`; forward, MSE gradient and full backward in
    one call, activation parameters included), with
    `garf_radiance_train_grads_reference`, torch autograd over the plain
    render.

Same name as the JAX package's module, whose `garf_radiance_render` and
`garf_radiance_train_grads` run the TPU kernels `_render_kernel` and
`_kernel`. Both kernels cover the fixed GARF width (`models/garf.py`) in the
three activation families, fp32 or bf16 (`GarfConfig.compute_dtype`), and
run their products on the tensor cores (bf16, or 3xTF32 in fp32) in row
tiles of `tile_rows` samples: they take linears 1..9 packed in mma fragment
order (`packed_weights`, one gather by `train_megakernel._pack_plan`), and
the render wrapper keeps its packed weights across calls (`render_weights`).

A CPU tensor goes to the plain version; a CUDA tensor goes to the kernel,
or the call raises.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from nerf_experiments_tpu_torch.models import garf
from nerf_experiments_tpu_torch.ops import cuda_build, render, sampling
from nerf_experiments_tpu_torch.ops.cuda_build import check_rays, is_bf16, pointers
from nerf_experiments_tpu_torch.ops.render import DENSITY_SCALE
from nerf_experiments_tpu_torch.ops.train_megakernel import (
    SMEM_LIMIT, cached_packs, pack_layers)

ACTIVATION_IDS = {"gauss": 0, "gabor": 1, "sarf": 2}
# the kernels' activation layers follow linear layers 0, 1, 2, 3, 4, 5, 6, 8
ACT_WIDTHS = (1024, 256, 128, 128, 512, 256, 128, 256)
COT_WIDTH = 1798  # `kCotWidth` of csrc/garf_common.cuh
# (input parts, output width) of the ten linears in the kernels' order; linear
# 0 (K = 3) runs on the CUDA cores and linear 7's column 128 is the density
LAYER_PARTS = (((3,), 1024), ((1024,), 256), ((256,), 128), ((128,), 128), ((128, 3), 512),
               ((512,), 256), ((256,), 128), ((128,), 129), ((128, 3), 256), ((256,), 3))
DENSITY_LAYER = 7
TILE_ROWS = (64, 32)  # the kernels' row tiles, in the order they are tried


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


def tile_smem_bytes(cfg: garf.GarfConfig, rows: int) -> int:
    """Shared memory of a block of either kernel with a `rows`-row tile
    (`GarfSmem` in csrc/garf_common.cuh): compute-type tiles of widths 512,
    256, 128, two layer-0 chunks of 64 and the positions and directions
    padded to 16 (each row padded by 16 bytes), the warps' weight rings,
    then 60 fp32 values a row."""
    bf16 = is_bf16(cfg)
    pad, elem, ring = (8, 2, 8 * 4 * 4 * 32 * 8) if bf16 else (4, 4, 8 * 3 * 4 * 32 * 16)
    tiles = rows * ((512 + pad) + (256 + pad) + (128 + pad) + 2 * (64 + pad)
                    + 2 * (16 + pad)) * elem
    return (tiles + 15) // 16 * 16 + ring + 4 * rows * 60


def tile_rows(cfg: garf.GarfConfig) -> int:
    """The row tile of both kernels: the first of `TILE_ROWS` whose block
    fits in the H100's shared memory (64 in bf16; 32 in fp32, whose 3xTF32
    operands stay fp32 in shared memory)."""
    return next(rows for rows in TILE_ROWS if tile_smem_bytes(cfg, rows) <= SMEM_LIMIT)


def _act_params(params: garf.Radiance, cfg: garf.GarfConfig, dev):
    """The activation layers' p1 (isd or freq) and p2 (gabor's spread, else
    None), fp32 and contiguous on `dev`."""
    name1 = garf.ACT_PARAMS[cfg.activation][0]
    p1 = [getattr(a, name1).detach().to(dev, torch.float32).contiguous() for a in _acts(params)]
    p2 = [a.spread.detach().to(dev, torch.float32).contiguous() if cfg.activation == "gabor"
          else None for a in _acts(params)]
    return p1, p2


def packed_weights(params: garf.Radiance, cfg: garf.GarfConfig, dev, backward: bool = False):
    """The kernels' weights on `dev`: per linear 1..9 the forward product's B
    (W, without linear 7's density column) and, with `backward`, the
    backward product's B (W^T), as `train_megakernel.pack_b` packs them
    (bf16, or fp32 TF32 hi / lo pairs), all in one gather; entry 0 is None
    (linear 0 runs on the CUDA cores). Also the fp32 biases, and linear 0's W
    and the density column W7[:, 128] in the compute type. Returns (fwd, bwd
    or None, biases, w0, w_density)."""
    bf16 = is_bf16(cfg)
    lins = _linears(params)
    fwd, bwd = pack_layers([l.w for l in lins], LAYER_PARTS, DENSITY_LAYER, bf16, backward, dev,
                           first=1)
    wdt = torch.bfloat16 if bf16 else torch.float32
    biases = [l.b.detach().to(dev, torch.float32).contiguous() for l in lins]
    w0 = lins[0].w.detach().to(dev, wdt).contiguous()
    w_density = lins[DENSITY_LAYER].w.detach()[:, 128].to(dev, wdt).contiguous()
    return [None] + fwd, ([None] + bwd if backward else None), biases, w0, w_density


# The render kernel's last packed weights, by the parameters they came from:
# the image logger and validation render an image in many calls with the
# same weights.
_render_pack: dict = {}


def render_weights(params: garf.Radiance, cfg: garf.GarfConfig, dev):
    """`packed_weights(params, cfg, dev)`, kept across calls by
    `train_megakernel.cached_packs` until a linear changes."""
    leaves = [t for l in _linears(params) for t in (l.w, l.b)]
    return cached_packs(_render_pack, leaves, (is_bf16(cfg), str(torch.device(dev))),
                        lambda: packed_weights(params, cfg, dev))


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
    wf, _, bs, w0, w_density = render_weights(params, cfg, dev)
    p1, p2 = _act_params(params, cfg, dev)
    out = torch.empty((n, 5), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.netpu_garf_render(
            origs.data_ptr(), dirs.data_ptr(), t_start.data_ptr(), t_end.data_ptr(),
            pointers(wf), pointers(bs), w0.data_ptr(), w_density.data_ptr(), pointers(p1),
            pointers(p2), act_id, int(bf16), tile_rows(cfg), n, s, float(act_anneal),
            float(density_scale), out.data_ptr(), stream)
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
    per row (pos, dir, then a and x of activation layers 1..7, then ci), the
    cotangent workspace per row, the per-block partials (layer 0's dW and db,
    every activation parameter), phase B's per-split partials, and the
    gradient count."""
    per_feature = 2 if cfg.activation == "gabor" else 1
    dims = garf.RADIANCE_D1_DIMS + garf.RADIANCE_D2_DIMS + garf.RADIANCE_COLOR_DIMS
    n_w = sum(i * o for i, o in dims)
    n_b = sum(o for _, o in dims)
    return {"act": 6 + 2 * sum(ACT_WIDTHS[1:]) + 128, "cot": COT_WIDTH,
            "block_part": 4096 + per_feature * sum(ACT_WIDTHS),
            "split_part": n_w + n_b - 3 * 1024 - 1024,
            "grads": n_w + n_b + per_feature * sum(ACT_WIDTHS)}


def _splits(rows: int) -> int:
    """Phase B splits the rows into fixed partials, added in a fixed order."""
    return max(1, min(64, math.ceil(rows / 16384)))


def _blocks(n_rays: int, n_samples: int, rows: int) -> int:
    """Blocks of the train kernel: rows // S rays a block when S <= rows,
    else one (`rays_per_block`)."""
    rays = max(1, rows // n_samples)
    return math.ceil(n_rays / rays)


def train_workspace_bytes(cfg: garf.GarfConfig, n_rays: int, n_samples: int) -> int:
    """Device memory `garf_radiance_train_grads` allocates for its workspaces
    and partials."""
    lay = train_layout(cfg)
    act_bytes = 2 if is_bf16(cfg) else 4
    rows = n_rays * n_samples
    return (rows * (lay["act"] * act_bytes + (lay["cot"] + 6) * 4)
            + _blocks(n_rays, n_samples, tile_rows(cfg)) * lay["block_part"] * 4
            + _splits(rows) * lay["split_part"] * 4)


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
    wf, wb, bs, w0, w_density = packed_weights(params, cfg, dev, backward=True)
    p1, p2 = _act_params(params, cfg, dev)
    lay = train_layout(cfg)
    rows = n * s
    tile = tile_rows(cfg)
    splits = _splits(rows)
    f32 = dict(dtype=torch.float32, device=dev)
    act = torch.empty((rows, lay["act"]), dtype=torch.bfloat16 if bf16 else torch.float32,
                      device=dev)
    cot = torch.empty((rows, lay["cot"]), **f32)
    aux = torch.empty((rows, 6), **f32)
    block_part = torch.empty((_blocks(n, s, tile), lay["block_part"]), **f32)
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
            targets.data_ptr(), pointers(wf), pointers(wb), pointers(bs), w0.data_ptr(),
            w_density.data_ptr(), pointers(p1), pointers(p2), act_id, int(bf16), tile, n, s,
            float(act_anneal), float(density_scale), 2.0 / (n * 3.0), act.data_ptr(),
            cot.data_ptr(), aux.data_ptr(), block_part.data_ptr(), lay["act"], lay["cot"],
            lay["block_part"], part.data_ptr(), splits, flat.data_ptr(), rgb.data_ptr(),
            weights.data_ptr(), d_origs.data_ptr(), d_dirs.data_ptr(), stream)
    cuda_build.check(code, "netpu_garf_train")
    garf_radiance_train_grads.launches += 1
    return rgb, weights, _unflatten(flat, params, cfg), d_origs, d_dirs


garf_radiance_train_grads.launches = 0
