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
"""
from __future__ import annotations

import ctypes
import math
from types import SimpleNamespace
from typing import List, Sequence, Tuple

import torch

from nerf_experiments_tpu_torch.ops import cuda_build
from nerf_experiments_tpu_torch.ops.cuda_build import check_tensor, device_weights, pointers


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
        h = (_Bf16Matmul.apply(h, layer.w) if bf16 else h @ layer.w) + layer.b
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


def _c_ints(values) -> ctypes.Array:
    return (ctypes.c_int * len(values))(*values)


def fused_mlp_fwd_cuda(x: torch.Tensor, layers: Sequence, bf16: bool) -> torch.Tensor:
    """One launch of K9: x (B, D_0) fp32 -> y (B, D_L) fp32."""
    n, dev = x.shape[0], x.device
    dims = _dims(x, layers)
    check_tensor("x", x, (n, dims[0]), dev)
    lib = cuda_build.library()
    w_dev, b_dev = device_weights(layers, dev, bf16)
    y = torch.empty((n, dims[-1]), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.netpu_fused_mlp_fwd(x.data_ptr(), pointers(w_dev), pointers(b_dev),
                                       _c_ints(dims), len(layers), int(bf16), n, y.data_ptr(),
                                       stream)
    cuda_build.check(code, "netpu_fused_mlp_fwd")
    fused_mlp_fwd_cuda.launches += 1
    return y


fused_mlp_fwd_cuda.launches = 0


def bwd_workspace_bytes(n_rows: int, dims: Sequence[int], bf16: bool) -> int:
    """Device memory `fused_mlp_bwd_cuda` allocates for its workspaces: every
    layer's input in the compute type and every output cotangent in fp32."""
    return n_rows * (sum(dims[:-1]) * (2 if bf16 else 4) + sum(dims[1:]) * 4)


def fused_mlp_bwd_cuda(x: torch.Tensor, layers: Sequence, g: torch.Tensor, bf16: bool
                       ) -> Tuple[torch.Tensor, List[torch.Tensor], List[torch.Tensor]]:
    """One launch of K10 (its row pass, the dW GEMM and the fixed-order
    reduction): (dx (B, D_0), [dW_i (D_i, D_i+1)], [db_i (D_i+1,)]), fp32;
    the gradients are views of one flat buffer."""
    n, dev = x.shape[0], x.device
    dims = _dims(x, layers)
    check_tensor("x", x, (n, dims[0]), dev)
    check_tensor("g", g, (n, dims[-1]), dev)
    lib = cuda_build.library()
    w_dev, b_dev = device_weights(layers, dev, bf16)
    wts = [w.t().contiguous() for w in w_dev]
    act_w, cot_w = sum(dims[:-1]), sum(dims[1:])
    # the dW GEMM splits the rows into fixed partials, added in a fixed order
    splits = max(1, min(64, math.ceil(n / 16384)))
    n_grads = sum(w.numel() + b.numel() for w, b in zip(w_dev, b_dev))
    f32 = dict(dtype=torch.float32, device=dev)
    act = torch.empty((n, act_w), dtype=torch.bfloat16 if bf16 else torch.float32, device=dev)
    cot = torch.empty((n, cot_w), **f32)
    part = torch.empty((splits, n_grads), **f32)
    flat = torch.empty((n_grads,), **f32)
    dx = torch.empty((n, dims[0]), **f32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.netpu_fused_mlp_bwd(
            x.data_ptr(), g.data_ptr(), pointers(w_dev), pointers(wts), pointers(b_dev),
            _c_ints(dims), len(layers), int(bf16), n, act.data_ptr(), cot.data_ptr(), act_w, cot_w,
            part.data_ptr(), splits, dx.data_ptr(), flat.data_ptr(), stream)
    cuda_build.check(code, "netpu_fused_mlp_bwd")
    fused_mlp_bwd_cuda.launches += 1

    # flat = every dW (in, out) in layer order, then every db
    dws, dbs, off = [], [], 0
    for w in w_dev:
        dws.append(flat[off:off + w.numel()].view(w.shape))
        off += w.numel()
    for b in b_dev:
        dbs.append(flat[off:off + b.numel()])
        off += b.numel()
    return dx, dws, dbs


fused_mlp_bwd_cuda.launches = 0


class FusedChain(torch.autograd.Function):
    """The chain on the card: K9 forward, K10 backward. Arguments: x, bf16,
    then w_0, b_0, w_1, b_1, ..."""

    @staticmethod
    def forward(ctx, x, bf16, *wb):
        ctx.bf16 = bf16
        ctx.save_for_backward(x, *wb)
        return fused_mlp_fwd_cuda(x, _layers(wb), bf16)

    @staticmethod
    def backward(ctx, g):
        x, *wb = ctx.saved_tensors
        dx, dws, dbs = fused_mlp_bwd_cuda(x, _layers(wb), g.contiguous(), ctx.bf16)
        grads = [None] * len(wb)
        grads[0::2], grads[1::2] = dws, dbs
        return (dx, None, *grads)


def fused_chain(x: torch.Tensor, layers: Sequence, compute_dtype=None) -> torch.Tensor:
    """ReLU dense chain y = W_L(...relu(W_1 x + b_1)...) + b_L: x (B, D_0),
    layers with `w` (D_i, D_i+1) and `b` (D_i+1,) -> (B, D_L) fp32,
    differentiable in x and every w, b. On a CUDA tensor through K9 / K10."""
    bf16 = _check_dtype(compute_dtype)
    if x.device.type != "cuda":
        return fused_chain_reference(x, layers, compute_dtype)
    wb = [t for layer in layers for t in (layer.w, layer.b)]
    return FusedChain.apply(x.float().contiguous(), bf16, *wb)
