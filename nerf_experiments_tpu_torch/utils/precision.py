"""Scoped fp32 arithmetic for the few places that must not run in TF32.

`torch.backends.cuda.matmul.allow_tf32` and `torch.backends.cudnn.allow_tf32`
are process-wide. A module that needs true fp32 products (the target blur,
the scene generator's camera rotation) turns TF32 off for its own call only,
as the JAX package scopes `jax.default_matmul_precision("highest")`, and
restores the caller's settings afterwards.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_fp32():
    """TF32 off for matmuls and cuDNN inside the block; the previous flags
    come back on exit."""
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn
