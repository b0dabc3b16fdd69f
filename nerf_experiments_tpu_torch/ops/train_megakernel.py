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
or the call raises. The render kernel runs its products on the tensor cores
in both compute types; they take each layer's B operand packed in fragment
order (`pack_b`): bf16, or fp32 split into TF32 hi / lo pairs for the 3xTF32
products. The train kernel has two routes (`train_route`), chosen by the
compute type: the bf16 tile (every product on the tensor cores) and the
fp32 tile (the forward on the CUDA cores in a plain fp32 GEMM's order of
adds, with W as it is at a row stride of a multiple of 4; the backward's g
W^T as 3xTF32 on the tensor cores).

The kernels serve any hidden width D and colour width C (padded to 16
inside); their row tile is 64 sample rows, or 32 where a 64-row tile's
shared memory would pass the block's 227 KB (`tile_rows`). Layers wider
than a 32-row tile holds (at the flagship encodings, to train D > 623 in
fp32 and D > 672 in bf16; to render D > 639 in fp32) take no kernel:
`kernels_fit` is False and `systems.barf.can_fuse_train_step` /
`use_fused_render` send such configs down the plain route.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import torch

from nerf_experiments_tpu_torch.encodings.fourier import Barf
from nerf_experiments_tpu_torch.models import nerf_mlp
from nerf_experiments_tpu_torch.ops import cuda_build, render, sampling
from nerf_experiments_tpu_torch.ops.cuda_build import (
    check_rays, is_bf16, pointers)
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


TILE_ROWS = (64, 32)  # the kernels' row tiles kR, in the order they are tried
SMEM_LIMIT = 232_448  # the H100's dynamic shared memory a block (`kMaxSmemBytes`)


def _round16(x: int) -> int:
    return (x + 15) // 16 * 16


def _round4(x: int) -> int:
    return (x + 3) // 4 * 4


def tile_smem_bytes(cfg: nerf_mlp.NerfMLPConfig, D: int, C: int, rows: int,
                    train: bool = False) -> int:
    """Shared memory of a block of the render kernel (train=False) or of the
    train kernel (train=True) with a `rows`-row tile: `TileSmem`
    (two activation tiles, the two encodings, the warps' weight rings) and
    the kernel's fp32 arrays (`render_floats`, `train_floats` in csrc/). The
    fp32 train tile keeps its cotangents in its own tiles, so its fp32 arrays
    are the compositing's, the geometry gradients, the lanes' rgb sums and a
    layer's ReLU mask words."""
    lp, ld = cfg.position_encoder.levels, cfg.direction_encoder.levels
    P, Q = 3 + 6 * lp, 3 + 6 * ld
    bf16 = is_bf16(cfg)
    pad, elem, ring = (8, 2, 8 * 4 * 4 * 32 * 8) if bf16 else (4, 4, 8 * 3 * 4 * 32 * 16)
    ldb = _round16(max(D + 1, C)) + pad
    tiles = _round16(rows * (2 * ldb + _round16(P) + _round16(Q) + 2 * pad) * elem)
    if train and bf16:
        floats = (rows * (6 + 16 + _round16(P) + _round16(Q) + 6 + max(_round16(D), _round16(C))
                          + 4) + _round4(lp + ld))
    elif train:
        floats = rows * (6 + 16 + 6) + 3 * 32 + rows // 32 * max(D, C) + _round4(lp + ld)
    else:
        floats = rows * (6 + 8) + _round4(lp + ld)
    return tiles + ring + 4 * floats


def tile_rows(cfg: nerf_mlp.NerfMLPConfig, D: int, C: int, train: bool = False) -> Optional[int]:
    """The row tile of the render kernel (with `train`, the train kernel's):
    the first of `TILE_ROWS` whose block fits in `SMEM_LIMIT`, else None (no
    tile for these widths)."""
    for rows in TILE_ROWS:
        if tile_smem_bytes(cfg, D, C, rows, train) <= SMEM_LIMIT:
            return rows
    return None


TRAIN_ROUTES = ("tile_bf16", "tile_fp32")


def train_route(cfg: nerf_mlp.NerfMLPConfig, D: int, C: int) -> Optional[Tuple[str, int]]:
    """The train kernel's route for these widths: ("tile_bf16" or
    "tile_fp32", by cfg's compute type, and the row tile `tile_rows` gives),
    else None (no tile fits: the plain route)."""
    rows = tile_rows(cfg, D, C, train=True)
    if rows is None:
        return None
    return ("tile_bf16" if is_bf16(cfg) else "tile_fp32"), rows


def kernels_fit(cfg: nerf_mlp.NerfMLPConfig, train: bool = False) -> bool:
    """Whether the render kernel (and with `train` the train kernel, in the
    config's compute type) has a block that fits for cfg's widths."""
    D, C = cfg.hidden_dim, cfg.hidden_dim // 2
    if tile_rows(cfg, D, C) is None:
        return False
    return not train or train_route(cfg, D, C) is not None


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x (fp32) rounded to TF32, 10 explicit mantissa bits, to nearest with
    ties away from zero: the kernels' `cvt.rna.tf32.f32`."""
    bits = x.float().contiguous().view(torch.int32).to(torch.int64)
    return ((bits + 0x1000) & ~0x1FFF).to(torch.int32).view(torch.float32)


def _pad_parts(mat: torch.Tensor, k_parts, n_parts, fill=0) -> torch.Tensor:
    """mat (K, N) with each of its K parts and N parts padded to a multiple of
    16 by `fill`."""
    kp, np_ = sum(map(_round16, k_parts)), sum(map(_round16, n_parts))
    pad = torch.full((kp, np_), fill, dtype=mat.dtype, device=mat.device)
    k_src = k_dst = 0
    for k in k_parts:
        n_src = n_dst = 0
        for n in n_parts:
            pad[k_dst:k_dst + k, n_dst:n_dst + n] = mat[k_src:k_src + k, n_src:n_src + n]
            n_src, n_dst = n_src + n, n_dst + _round16(n)
        k_src, k_dst = k_src + k, k_dst + _round16(k)
    return pad


def _fragment_order(pad: torch.Tensor, bf16: bool) -> torch.Tensor:
    """A padded B (K, N), or for fp32 its (hi, lo) pair (2, K, N), in fragment
    order (a view; see `pack_b`)."""
    if bf16:  # k = 16 ks + 8 h + 2 t + e, n = 8 nt + g -> (nt, ks, g, t, h, e)
        kp, np_ = pad.shape
        b = pad.view(kp // 16, 2, 4, 2, np_ // 8, 8)
        return b.permute(4, 0, 5, 2, 1, 3).reshape(np_ // 8, kp // 16, 32, 4)
    _, kp, np_ = pad.shape  # k = 8 ks + 4 h + t -> (nt, ks, g, t, hl, h)
    b = pad.view(2, kp // 8, 2, 4, np_ // 8, 8)
    return b.permute(4, 1, 5, 3, 0, 2).reshape(np_ // 8, kp // 8, 32, 4)


def pack_b(mat: torch.Tensor, k_parts, n_parts, bf16: bool) -> torch.Tensor:
    """The B operand (K, N) of a tile product, in the kernels' fragment order.

    K is the reduction. `k_parts` / `n_parts` split K and N into parts (a
    layer's inputs [z | pos_enc], say), each zero-padded to a multiple of 16.
    bf16 (mma m16n8k16): (N/8, K/16, 32, 4); lane 4 g + t holds B[k][8 nt + g]
    for k = 16 ks + 2 t + e (e = 0, 1) then + 8. fp32 (3xTF32, m16n8k8): (N/8,
    K/8, 32, 4) with hi = tf32(B), lo = tf32(B - hi); lane 4 g + t holds hi at
    k = 8 ks + t and + 4, then lo at the same two. `packed_weights` packs
    every layer in one gather by the same order."""
    pad = _pad_parts(mat.float(), k_parts, n_parts)
    if bf16:
        return _fragment_order(pad.to(torch.bfloat16), True).contiguous()
    hi = tf32_round(pad)
    return _fragment_order(torch.stack([hi, tf32_round(pad - hi)]), False).contiguous()


def _layer_parts(cfg: nerf_mlp.NerfMLPConfig, D: int, C: int):
    """(input parts, output width) of every layer in the kernels' order."""
    P = 3 + 6 * cfg.position_encoder.levels
    Q = 3 + 6 * cfg.direction_encoder.levels
    L = cfg.n_hidden + 1
    return ([((P,), D)] + [((D,), D)] * (L - 1) + [((D, P), D)] + [((D,), D)] * (L - 2)
            + [((D,), D + 1), ((D, Q), C), ((C,), 3)])


@functools.lru_cache(maxsize=8)
def _pack_plan(layer_parts, last: int, bf16: bool, backward: bool, device: str,
               first: int = 0, forward: bool = True):
    """Where every packed element comes from: an index into the layers'
    weights (in, out) flattened in layer order with one zero after them (fp32:
    their TF32 hi parts, then the lo parts, each so), and per packed operand
    of layers first.. its (offset, shape) in the result (the layers before
    `first` run on the CUDA cores and are not packed; without `forward`, only
    the backward operands are). Built once per layout and device."""
    offsets, n_src = [], 0
    for parts, out in layer_parts:
        offsets.append(n_src)
        n_src += sum(parts) * out
    zero = n_src
    pieces, fwd, bwd, at = [], [], [], 0

    def add(idx, k_parts, n_parts, into):
        nonlocal at
        pad = _pad_parts(idx, k_parts, n_parts, fill=zero)
        if not bf16:  # (hi, lo): the lo copy of the source follows the hi one
            pad = torch.stack([pad, pad + (n_src + 1)])
        order = _fragment_order(pad, bf16)
        pieces.append(order.reshape(-1))
        into.append((at, tuple(order.shape)))
        at += order.numel()

    for i, ((parts, out), off) in enumerate(zip(layer_parts, offsets)):
        if i < first:
            continue
        w = torch.arange(off, off + sum(parts) * out).view(sum(parts), out)
        n_fwd = out - 1 if i == last else out  # the density column goes apart
        if forward:
            add(w[:, :n_fwd], parts, (n_fwd,), fwd)
        if backward:
            add(w.t(), (out,), parts, bwd)
    return torch.cat(pieces).to(device), fwd, bwd


def packed_weights(params: nerf_mlp.NerfMLP, cfg: nerf_mlp.NerfMLPConfig, dev,
                   backward: bool = False):
    """The kernels' weights on `dev`: per layer the forward product's B (W,
    without the density column of the last segment layer) and, with
    `backward`, the backward product's B (W^T, whose columns are the layer's
    input parts), each as `pack_b` packs it, all gathered in one call from the
    flattened weights by `_pack_plan`; the fp32 biases; the density column
    W[:, D] in the compute type. Returns (fwd, bwd or None, biases, w_density)."""
    bf16 = is_bf16(cfg)
    layers = _layers(params)
    D = params.segments[0].layers[0].w.shape[1]
    C = params.color[0].w.shape[1]
    last = 2 * cfg.n_hidden + 1  # the last segment layer: D hidden columns + density
    fwd, bwd = pack_layers([l.w for l in layers], _layer_parts(cfg, D, C), last, bf16,
                           backward, dev)
    biases = [l.b.detach().to(dev, torch.float32).contiguous() for l in layers]
    w_density = layers[last].w.detach()[:, D].to(
        dev, torch.bfloat16 if bf16 else torch.float32).contiguous()
    return fwd, bwd, biases, w_density


def pack_layers(weights, layer_parts, last: int, bf16: bool, backward: bool, dev,
                first: int = 0, forward: bool = True):
    """Every layer's forward B (W, without the density column of layer
    `last`; with `forward`) and with `backward` its backward B (W^T), for
    layers first.., each as `pack_b` packs it, gathered in one call from the
    weights flattened in layer order by `_pack_plan`. Returns (fwd or None,
    bwd or None)."""
    index, fwd_at, bwd_at = _pack_plan(tuple(layer_parts), last, bf16, backward,
                                       str(torch.device(dev)), first, forward)
    ws = [w.detach().to(dev, torch.float32).reshape(-1) for w in weights]
    flat = torch.cat(ws + [ws[0].new_zeros(1)])
    if bf16:
        src = flat.to(torch.bfloat16)
    else:
        hi = tf32_round(flat)
        src = torch.cat([hi, tf32_round(flat - hi)])
    packed = src[index]
    views = lambda at: [packed[o:o + math.prod(shape)].view(shape) for o, shape in at]
    return (views(fwd_at) if forward else None), (views(bwd_at) if backward else None)


# The render kernel's last packed weights, by the parameters they came from:
# serving and validation render an image in many calls with the same weights.
_render_pack: dict = {}


def render_weights(params: nerf_mlp.NerfMLP, cfg: nerf_mlp.NerfMLPConfig, dev):
    """`packed_weights(params, cfg, dev)`, kept across calls by
    `cached_packs`."""
    leaves = [t for l in _layers(params) for t in (l.w, l.b)]
    return cached_packs(_render_pack, leaves, (is_bf16(cfg), str(torch.device(dev))),
                        lambda: packed_weights(params, cfg, dev))


def cached_packs(cache: dict, leaves, extra, pack):
    """`pack()`, computed again only when a tensor of `leaves` (its id,
    storage or version: bumped by every in-place write, as optimizer steps,
    `copy_` and `load_state_dict` do) or `extra` changed since the last call
    with this cache. The entry holds the tensors, so their ids cannot pass to
    others."""
    key = (tuple((id(t), t.data_ptr(), t._version) for t in leaves), extra)
    hit = cache.get("last")
    if hit is not None and hit[0] == key:
        return hit[2]
    packed = pack()
    cache["last"] = (key, leaves, packed)
    return packed


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
    D = params.segments[0].layers[0].w.shape[1]
    C = params.color[0].w.shape[1]
    rows = tile_rows(cfg, D, C)
    if rows is None:
        raise ValueError(f"the flagship render kernel has no row tile for hidden width {D} "
                         f"(colour {C}): such configs take the plain route")
    lib = cuda_build.library()
    wf, _, bs, w_density = render_weights(params, cfg, dev)

    out = torch.empty((n, 5), dtype=torch.float32, device=dev)
    weights = torch.empty((n, s), dtype=torch.float32, device=dev) if return_weights else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.netpu_flagship_render(
            origs.data_ptr(), dirs.data_ptr(), t_start.data_ptr(), t_end.data_ptr(),
            pointers(wf), pointers(bs), w_density.data_ptr(),
            len(layers), int(bf16), rows, n, s, cfg.n_hidden, D, C, pe.levels, de.levels,
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
    `csrc/flagship_common.cuh`): activations and cotangents per sample row,
    ReLU mask words per 32-row half tile."""
    P = 3 + 6 * cfg.position_encoder.levels
    Q = 3 + 6 * cfg.direction_encoder.levels
    L = cfg.n_hidden + 1
    return P + Q + 2 * L * D + C, 2 * L * D + 1 + C + 3, (2 * L - 1) * D + C


def _mask_halves(n_rays: int, n_samples: int, rows: int) -> int:
    """32-row groups of the ReLU mask words: the 32-row parts of the row
    tiles (`rows` rows each), a block taking rows // S rays (one when S >
    rows) in ceil(rays * S / rows) tiles."""
    rays = max(1, rows // n_samples)
    return math.ceil(n_rays / rays) * math.ceil(rays * n_samples / rows) * (rows // 32)


def train_workspace_bytes(cfg: nerf_mlp.NerfMLPConfig, n_rays: int, n_samples: int,
                          D: int, C: int) -> int:
    """Device memory `flagship_train_grads` allocates for its workspaces:
    activations (compute type), cotangents and the compositing record (fp32)
    per sample row, and ReLU mask words per 32 rows (`_mask_halves`, on
    the row tile of `tile_rows`; widths with no tile are counted as a
    64-row tile)."""
    act_w, cot_w, mask_w = _train_layout(cfg, D, C)
    rows = tile_rows(cfg, D, C, train=True) or TILE_ROWS[0]
    return (n_rays * n_samples * (act_w * (2 if is_bf16(cfg) else 4) + (cot_w + 6) * 4)
            + _mask_halves(n_rays, n_samples, rows) * mask_w * 4)


def _fp32_tile_weights(layers, last: int, D: int, dev):
    """The fp32 tile's forward weights: every layer's W (in, out) fp32 with
    its row stride padded to a multiple of 4 (the CUDA cores' forward reads
    rows as float4), the last segment layer's without its density column,
    and that column W[:, D]."""
    ws = [l.w.detach().to(dev, torch.float32) for l in layers]
    w_density = ws[last][:, D].contiguous()
    ws[last] = ws[last][:, :D]
    fwd = [w if w.shape[1] % 4 == 0 and w.is_contiguous() and w.data_ptr() % 16 == 0
           else torch.nn.functional.pad(w, (0, -w.shape[1] % 4)).contiguous() for w in ws]
    return fwd, w_density


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
    D = params.segments[0].layers[0].w.shape[1]
    C = params.color[0].w.shape[1]
    route = train_route(cfg, D, C)
    if route is None:
        raise ValueError(f"the flagship train kernel has no block for hidden width {D} "
                         f"(colour {C}): such configs take the plain route")
    _, tile = route
    lib = cuda_build.library()
    if bf16:  # packed B operands
        wf, wb, bs, w_density = packed_weights(params, cfg, dev, backward=True)
    else:  # W as it is for the CUDA cores, W^T packed (TF32 hi / lo)
        last = 2 * cfg.n_hidden + 1
        wf, w_density = _fp32_tile_weights(layers, last, D, dev)
        wb = pack_layers([l.w for l in layers], _layer_parts(cfg, D, C), last, False, True,
                         dev, forward=False)[1]
        bs = [l.b.detach().to(dev, torch.float32).contiguous() for l in layers]
    act_w, cot_w, mask_w = _train_layout(cfg, D, C)
    rows = n * s
    # phase B splits the rows into fixed partials, added in a fixed order
    splits = max(1, min(64, math.ceil(rows / 16384)))
    n_grads = sum(l.w.numel() + l.b.numel() for l in layers)
    f32 = dict(dtype=torch.float32, device=dev)
    act = torch.empty((rows, act_w), dtype=torch.bfloat16 if bf16 else torch.float32,
                      device=dev)
    cot = torch.empty((rows, cot_w), **f32)
    aux = torch.empty((rows, 6), **f32)
    masks = torch.empty((_mask_halves(n, s, tile), mask_w), dtype=torch.int32,
                        device=dev)
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
            targets.data_ptr(), pointers(wf), pointers(wb), pointers(bs),
            w_density.data_ptr(), len(layers), int(bf16), tile, n, s, cfg.n_hidden, D, C, pe.levels, de.levels,
            float(pe.scale), float(alpha_pos), float(alpha_dir), float(density_scale),
            2.0 * float(loss_scale) / (n * 3.0), act.data_ptr(), cot.data_ptr(),
            aux.data_ptr(), masks.data_ptr(), act_w, cot_w, part.data_ptr(), splits,
            flat.data_ptr(),
            rgb.data_ptr(), d_origs.data_ptr(), d_dirs.data_ptr(),
            None if weights is None else weights.data_ptr(), stream)
    cuda_build.check(code, "netpu_flagship_train")
    flagship_train_grads.launches += 1

    # flat = every dW (in, out) in layer order, then every db
    grads, w_off, b_off = {}, 0, sum(l.w.numel() for l in layers)
    for name, l in zip(_layer_names(params), layers):
        grads[f"{name}.w"] = flat[w_off:w_off + l.w.numel()].view(l.w.shape)
        grads[f"{name}.b"] = flat[b_off:b_off + l.b.numel()].view(l.b.shape)
        w_off += l.w.numel()
        b_off += l.b.numel()
    out = (rgb, grads, d_origs, d_dirs)
    return out + (weights,) if return_weights else out


flagship_train_grads.launches = 0
