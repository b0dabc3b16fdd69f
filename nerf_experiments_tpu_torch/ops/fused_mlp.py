"""The fused ReLU MLP chain y = W_L(...relu(W_1 x + b_1)...) + b_L, no ReLU
after the last layer: the counterpart of the JAX package's `ops/fused_mlp.py`.

  * `fused_chain(x, layers, compute_dtype)`, the entry: a CPU tensor goes to
    the plain version `fused_chain_reference` (torch autograd), a CUDA tensor
    to `FusedChain`, the autograd function over the two kernels of
    `csrc/fused_mlp.cu`, or the call raises;
  * `fused_mlp_fwd_cuda` (K9, replacing the TPU kernel `_fwd_kernel`) and
    `fused_mlp_bwd_cuda` (K10, replacing `_bwd_kernel`), the kernels'
    wrappers, each counting its launches.

With `compute_dtype=torch.bfloat16` every product rounds both operands to bf16
and accumulates in fp32; the output, the biases and the running cotangent stay
fp32, and the backward rounds the cotangent only inside its two products (the
TPU kernel's `_dot_general`). The JAX package's custom VJP returns each db as
(D,) for a (1, D) primal and so raises under `jax.grad`; the port computes
the true gradient.

The kernels work on row tiles of `tile_rows` rows. In bf16 every product
runs on the tensor cores (mma.sync); in fp32 the forward products run on the
CUDA cores in a plain GEMM's order, so that each ReLU falls as the plain
chain's does, and the backward's g W^T on the tensor cores as 3xTF32. The
tensor-core products take their weights packed in mma fragment order (W for
the forward, W^T for the backward, all layers in one gather: `pack_chain`);
`FusedChain` packs once per forward and hands the packs to its backward. A
chain whose widest layer leaves no row tile within the block's shared
memory (`tile_rows` is None) is refused on the card.
"""
from __future__ import annotations

import ctypes
import math
from types import SimpleNamespace
from typing import List, Optional, Sequence, Tuple

import torch

from nerf_experiments_tpu_torch.ops import cuda_build
from nerf_experiments_tpu_torch.ops.cuda_build import check_tensor, pointers
from nerf_experiments_tpu_torch.ops.train_megakernel import SMEM_LIMIT, TILE_ROWS, pack_layers


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


class _Bf16Matmul(torch.autograd.Function):
    """a @ w on operands rounded to bf16, in fp32; the backward rounds the
    cotangent and the operands the same way in both of its products."""

    @staticmethod
    def forward(ctx, a, w):
        a, w = _bf16(a), _bf16(w)
        ctx.save_for_backward(a, w)
        return a @ w

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        g = _bf16(g)
        return g @ w.t(), a.t() @ g


def _matmul(a: torch.Tensor, w: torch.Tensor, bf16: bool) -> torch.Tensor:
    """One product of the plain chain: fp32, or on operands rounded to bf16."""
    return _Bf16Matmul.apply(a, w) if bf16 else a @ w


def _check_dtype(compute_dtype) -> bool:
    if compute_dtype not in (None, torch.bfloat16):
        raise ValueError(f"compute_dtype {compute_dtype} is not supported")
    return compute_dtype == torch.bfloat16


def fused_chain_reference(x: torch.Tensor, layers: Sequence, compute_dtype=None) -> torch.Tensor:
    """Plain version of the chain (and, through torch autograd, of its
    backward): x (B, D_0), layers with `w` (D_i, D_i+1) and `b` (D_i+1,) ->
    (B, D_L) fp32. A hidden activation's bf16 rounding is left to the next
    product, which rounds its input anyway."""
    bf16 = _check_dtype(compute_dtype)
    h = x.float()
    for i, layer in enumerate(layers):
        h = _matmul(h, layer.w, bf16) + layer.b
        if i < len(layers) - 1:
            h = torch.relu(h)
    return h


def fused_chain_bwd_reference(x: torch.Tensor, layers: Sequence, g: torch.Tensor,
                              compute_dtype=None
                              ) -> Tuple[torch.Tensor, List[torch.Tensor], List[torch.Tensor]]:
    """Plain version of the backward (K10): torch autograd through
    `fused_chain_reference`, the forward recomputed as K10 does -> (dx,
    [dW_i], [db_i]) for the output cotangent g."""
    leaves = [x.detach().requires_grad_(True)]
    leaves += [t.detach().requires_grad_(True) for layer in layers for t in (layer.w, layer.b)]
    with torch.enable_grad():
        y = fused_chain_reference(leaves[0], _layers(leaves[1:]), compute_dtype)
        grads = torch.autograd.grad(y, leaves, g)
    return grads[0], list(grads[1::2]), list(grads[2::2])


def _layers(wb: Sequence[torch.Tensor]) -> List[SimpleNamespace]:
    """Layers from the flat list w_0, b_0, w_1, b_1, ..."""
    return [SimpleNamespace(w=w, b=b) for w, b in zip(wb[0::2], wb[1::2])]


def _dims(x: torch.Tensor, layers: Sequence) -> List[int]:
    dims = [x.shape[1]] + [layer.w.shape[1] for layer in layers]
    for i, layer in enumerate(layers):
        if tuple(layer.w.shape) != (dims[i], dims[i + 1]):
            raise ValueError(
                f"layer {i}: weight {tuple(layer.w.shape)} does not follow width {dims[i]}")
    return dims


def _round16(x: int) -> int:
    return (x + 15) // 16 * 16


def tile_smem_bytes(dims: Sequence[int], bf16: bool, rows: int, backward: bool = False) -> int:
    """Shared memory of a block of K9 (or, with `backward`, of K10's phase A)
    with a `rows`-row tile (`ChainSmem` in csrc/fused_mlp.cu): two
    compute-type tiles as wide as the widest layer padded to 16, each row
    padded by 16 bytes, and the warps' weight rings of the tensor-core
    products (in fp32's forward, the staging of W); the backward adds the
    fp32 staging tile of a hidden cotangent (bf16 only) and one 32-bit mask
    word per hidden column and 32-row half."""
    pad, elem, ring = (8, 2, 8 * 4 * 4 * 32 * 8) if bf16 else (4, 4, 8 * 3 * 4 * 32 * 16)
    ld = max(map(_round16, dims)) + pad
    total = _round16(2 * rows * ld * elem) + ring
    hidden = list(dims[1:-1])
    if backward:
        if bf16 and hidden:
            total += rows * (max(map(_round16, hidden)) + 4) * 4
        total += rows // 32 * sum(hidden) * 4
    return total


def tile_rows(dims: Sequence[int], bf16: bool, backward: bool = False) -> Optional[int]:
    """The row tile of K9 (K10 with `backward`): the first of `TILE_ROWS`
    whose block fits in `SMEM_LIMIT`, else None (no kernel for this chain)."""
    for rows in TILE_ROWS:
        if tile_smem_bytes(dims, bf16, rows, backward) <= SMEM_LIMIT:
            return rows
    return None


def _tile_or_raise(dims: Sequence[int], bf16: bool, backward: bool) -> int:
    rows = tile_rows(dims, bf16, backward)
    if rows is None:
        raise ValueError(f"fused_chain: a chain of widths {list(dims)} leaves no row tile "
                         f"within {SMEM_LIMIT} bytes of shared memory")
    return rows


def pack_chain(layers: Sequence, bf16: bool, backward: bool, dev
               ) -> Tuple[List[torch.Tensor], Optional[List[torch.Tensor]]]:
    """The kernels' weights on `dev`: each layer's forward W, in bf16 packed
    as `train_megakernel.pack_b` packs it for the tensor cores, in fp32 as
    it is with its rows padded to a multiple of 4 (the CUDA cores' forward
    reads them as float4); with `backward`, each layer's W^T packed by
    `pack_b` for the tensor cores' g W^T (bf16, or fp32 TF32 hi / lo). The
    packs come from one gather. Returns (forward, backward or None)."""
    dims = [layers[0].w.shape[0]] + [layer.w.shape[1] for layer in layers]
    parts = [((dims[i],), dims[i + 1]) for i in range(len(layers))]
    weights = [layer.w for layer in layers]
    if bf16:
        return pack_layers(weights, parts, -1, True, backward, dev)
    fwd = [w if w.shape[1] % 4 == 0 and w.data_ptr() % 16 == 0
           else torch.nn.functional.pad(w, (0, -w.shape[1] % 4)) for w in _fp32(weights, dev)]
    if not backward:
        return fwd, None
    return fwd, pack_layers(weights, parts, -1, False, True, dev, forward=False)[1]


def _fp32(tensors, dev) -> List[torch.Tensor]:
    return [t.detach().to(dev, torch.float32).contiguous() for t in tensors]


def _c_ints(values) -> ctypes.Array:
    return (ctypes.c_int * len(values))(*values)


def fused_mlp_fwd_cuda(x: torch.Tensor, layers: Sequence, bf16: bool,
                       packed: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
    """One launch of K9: x (B, D_0) fp32 -> y (B, D_L) fp32. `packed`: the
    forward weights of `pack_chain`, packed here when not given."""
    n, dev = x.shape[0], x.device
    dims = _dims(x, layers)
    check_tensor("x", x, (n, dims[0]), dev)
    rows = _tile_or_raise(dims, bf16, False)
    lib = cuda_build.library()
    if packed is None:
        packed = pack_chain(layers, bf16, False, dev)[0]
    biases = _fp32([layer.b for layer in layers], dev)
    y = torch.empty((n, dims[-1]), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.netpu_fused_mlp_fwd(x.data_ptr(), pointers(packed), pointers(biases),
                                       _c_ints(dims), len(layers), int(bf16), rows, n,
                                       y.data_ptr(), stream)
    cuda_build.check(code, "netpu_fused_mlp_fwd")
    fused_mlp_fwd_cuda.launches += 1
    return y


fused_mlp_fwd_cuda.launches = 0


def bwd_workspace_bytes(n_rows: int, dims: Sequence[int], bf16: bool) -> int:
    """Device memory `fused_mlp_bwd_cuda` allocates for its workspaces: every
    layer's input in the compute type and every output cotangent in fp32."""
    return n_rows * (sum(dims[:-1]) * (2 if bf16 else 4) + sum(dims[1:]) * 4)


SM_COUNT = 132  # the H100's SMs


def dw_splits(n_rows: int, dims: Sequence[int]) -> int:
    """The row splits of K10's dW GEMM, whose partials are added in a fixed
    order: enough that its blocks (128 x 128 output tiles x splits) fill the
    card's SMs ~4 times over, with at least 4,096 rows and at most 64 splits.
    A function of the shapes alone, so two launches sum alike."""
    tiles = sum(math.ceil(a / 128) * math.ceil(b / 128) for a, b in zip(dims[:-1], dims[1:]))
    return max(1, min(64, math.ceil(n_rows / 4096), math.ceil(4 * SM_COUNT / tiles)))


def fused_mlp_bwd_cuda(x: torch.Tensor, layers: Sequence, g: torch.Tensor, bf16: bool,
                       packed=None, act: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, List[torch.Tensor], List[torch.Tensor]]:
    """One launch of K10 (its row pass, the dW GEMM and the fixed-order
    reduction): (dx (B, D_0), [dW_i (D_i, D_i+1)], [db_i (D_i+1,)]), fp32;
    the gradients are views of one flat buffer. `packed`: both packs of
    `pack_chain(..., backward=True)`, packed here when not given. `act`: the
    activation workspace (B, D_0 + ... + D_L-1) in the compute type, every
    layer's input as the row pass recomputed it; allocated here when not
    given."""
    n, dev = x.shape[0], x.device
    dims = _dims(x, layers)
    check_tensor("x", x, (n, dims[0]), dev)
    check_tensor("g", g, (n, dims[-1]), dev)
    rows = _tile_or_raise(dims, bf16, True)
    lib = cuda_build.library()
    if packed is None:
        packed = pack_chain(layers, bf16, True, dev)
    fwd, bwd = packed
    biases = _fp32([layer.b for layer in layers], dev)
    act_w, cot_w = sum(dims[:-1]), sum(dims[1:])
    splits = dw_splits(n, dims)
    shapes = [(dims[i], dims[i + 1]) for i in range(len(layers))]
    n_grads = sum(a * b + b for a, b in shapes)
    f32 = dict(dtype=torch.float32, device=dev)
    act_dtype = torch.bfloat16 if bf16 else torch.float32
    if act is None:
        act = torch.empty((n, act_w), dtype=act_dtype, device=dev)
    elif (act.dtype != act_dtype or act.device != dev or tuple(act.shape) != (n, act_w)
          or not act.is_contiguous()):
        raise ValueError(f"act: need a contiguous {act_dtype} ({n}, {act_w}) tensor on {dev}")
    cot = torch.empty((n, cot_w), **f32)
    part = torch.empty((splits, n_grads), **f32)
    flat = torch.empty((n_grads,), **f32)
    dx = torch.empty((n, dims[0]), **f32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.netpu_fused_mlp_bwd(
            x.data_ptr(), g.data_ptr(), pointers(fwd), pointers(bwd), pointers(biases),
            _c_ints(dims), len(layers), int(bf16), rows, n, act.data_ptr(), cot.data_ptr(),
            act_w, cot_w, part.data_ptr(), splits, dx.data_ptr(), flat.data_ptr(), stream)
    cuda_build.check(code, "netpu_fused_mlp_bwd")
    fused_mlp_bwd_cuda.launches += 1

    # flat = every dW (in, out) in layer order, then every db
    dws, dbs, off = [], [], 0
    for a, b in shapes:
        dws.append(flat[off:off + a * b].view(a, b))
        off += a * b
    for _, b in shapes:
        dbs.append(flat[off:off + b])
        off += b
    return dx, dws, dbs


fused_mlp_bwd_cuda.launches = 0


class FusedChain(torch.autograd.Function):
    """The chain on the card: K9 forward, K10 backward. Arguments: x, bf16,
    whether a backward will follow (then W^T is packed too, once), then w_0,
    b_0, w_1, b_1, ..."""

    @staticmethod
    def forward(ctx, x, bf16, backward, *wb):
        layers = _layers(wb)
        packed = pack_chain(layers, bf16, backward, x.device)
        ctx.bf16, ctx.packed = bf16, packed
        ctx.save_for_backward(x, *wb)
        return fused_mlp_fwd_cuda(x, layers, bf16, packed=packed[0])

    @staticmethod
    def backward(ctx, g):
        x, *wb = ctx.saved_tensors
        dx, dws, dbs = fused_mlp_bwd_cuda(x, _layers(wb), g.contiguous(), ctx.bf16,
                                          packed=ctx.packed)
        grads = [None] * len(wb)
        grads[0::2], grads[1::2] = dws, dbs
        return (dx, None, None, *grads)


def fused_chain(x: torch.Tensor, layers: Sequence, compute_dtype=None) -> torch.Tensor:
    """ReLU dense chain y = W_L(...relu(W_1 x + b_1)...) + b_L: x (B, D_0),
    layers with `w` (D_i, D_i+1) and `b` (D_i+1,) -> (B, D_L) fp32,
    differentiable in x and every w, b. On a CUDA tensor through K9 / K10."""
    bf16 = _check_dtype(compute_dtype)
    if x.device.type != "cuda":
        return fused_chain_reference(x, layers, compute_dtype)
    wb = [t for layer in layers for t in (layer.w, layer.b)]
    backward = torch.is_grad_enabled() and any(t.requires_grad for t in [x, *wb])
    _tile_or_raise(_dims(x, layers), bf16, backward)
    cuda_build.library()  # builds the kernels before the packing, or raises naming nvcc
    return FusedChain.apply(x.float().contiguous(), bf16, backward, *wb)
