"""Shared building blocks of the model layer.

Weights keep the JAX package's (in, out) layout, so `x @ w + b` matches
`nerf_experiments_tpu/models/common.py` and converted weights need no
transpose. Param groups reproduce `NerfBaseModel._add_param_group`
(`barf/model_interpolation_architecture.py:11-29`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F


@dataclasses.dataclass(frozen=True)
class ParamGroup:
    """Hyperparameters of one optimizer param group (LeNice schedule knobs)."""

    learning_rate_start: float
    learning_rate_stop: float
    learning_rate_decay_end: int  # in steps; <=0 disables decay
    weight_decay: float = 0.0
    # None -> optimizer default; a large eps makes Adam updates
    # gradient-proportional (camera extrinsics)
    adam_eps: Optional[float] = None
    # LR forced to 0 for steps in [freeze_start_step, freeze_end_step)
    freeze_start_step: int = 0
    freeze_end_step: int = 0


class Dense(nn.Module):
    """One affine layer with parameters `w` (in, out) and `b` (out,)."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b)


def linear_init(generator: torch.Generator, in_features: int, out_features: int,
                dtype=torch.float32, device=None) -> Dense:
    """torch nn.Linear's default bounds: W, b ~ U(-1/sqrt(in), 1/sqrt(in)),
    drawn from `generator`, stored (in, out)."""
    bound = 1.0 / math.sqrt(in_features)

    def uniform(shape):
        u = torch.rand(shape, generator=generator, dtype=dtype, device=device)
        return u * (2.0 * bound) - bound

    return Dense(uniform((in_features, out_features)), uniform((out_features,)))


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of bf16 CUDA operands, accumulated and returned in fp32 by one
    tensor-core GEMM (`aten::mm.dtype`)."""
    return torch.mm(a, b, out_dtype=torch.float32)


class _Bf16Linear(torch.autograd.Function):
    """x @ W + b on CUDA with bf16 operands in one GEMM that returns fp32, then
    + b and the round to bf16. The gradients are the ones autograd gives the
    CPU path below: dx and dW are fp32 products of the bf16 operands rounded
    to bf16, db sums the fp32 cotangent. `aten::mm.dtype` has no derivative
    formula, hence this Function."""

    @staticmethod
    def forward(ctx, x2, w, b):
        xb, wb = x2.to(torch.bfloat16), w.to(torch.bfloat16)
        ctx.save_for_backward(xb, wb)
        ctx.dtypes = (x2.dtype, w.dtype)
        return (_mm_f32(xb, wb) + b).to(torch.bfloat16)

    @staticmethod
    def backward(ctx, gy):
        xb, wb = ctx.saved_tensors
        gb = gy.to(torch.bfloat16)
        gx = None
        if ctx.needs_input_grad[0]:
            gx = _mm_f32(gb, wb.t()).to(torch.bfloat16).to(ctx.dtypes[0])
        gw = _mm_f32(xb.t(), gb).to(torch.bfloat16).to(ctx.dtypes[1])
        return gx, gw, gy.float().sum(0)


def linear_apply(layer: Dense, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """x @ W + b. With a compute dtype (bf16) the operands are rounded to it,
    the products are accumulated in fp32, and the output is stored in the
    compute dtype, as `jax.lax.dot_general(..., preferred_element_type=f32)`
    followed by `.astype(compute_dtype)` does in the JAX package. On CUDA the
    bf16 operands go into one tensor-core GEMM that returns fp32
    (`_Bf16Linear`); elsewhere the rounded operands are multiplied as fp32,
    so the accumulation is fp32 on every device."""
    w, b = layer.w, layer.b
    if compute_dtype is None:
        return x @ w + b
    if x.is_cuda and compute_dtype == torch.bfloat16:
        y = _Bf16Linear.apply(x.reshape(-1, x.shape[-1]), w, b)
        return y.reshape(*x.shape[:-1], w.shape[1])
    y = x.to(compute_dtype).float() @ w.to(compute_dtype).float() + b
    return y.to(compute_dtype)


def softplus8(x: torch.Tensor) -> torch.Tensor:
    """torch nn.Softplus(threshold=8): linear above 8 for stability."""
    return torch.where(x > 8.0, x, F.softplus(torch.clamp(x, max=8.0)))

