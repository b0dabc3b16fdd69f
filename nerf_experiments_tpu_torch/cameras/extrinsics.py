"""Learnable per-train-image camera extrinsics (so3 rotation + translation).

Semantics from `barf/model_camera_extrinsics.py:7-85` (`CameraExtrinsics`):
one so3 vector and one translation per training image, initialized to zero;
`forward(i, o, d)` translates ray origins by t[i] and rotates ray directions
by exp(hat(so3[i])). The translation is divided by MAGIC_NUMBER_THE_SECOND.
Parameters keep the JAX package's names: `rotation` (N, 3), `translation` (N, 3).
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from nerf_experiments_tpu_torch.ops.lie import so3_exp
from nerf_experiments_tpu_torch.utils.magic import MAGIC_NUMBER_THE_SECOND


class Extrinsics(nn.Module):
    def __init__(self, rotation: torch.Tensor, translation: torch.Tensor):
        super().__init__()
        self.rotation = nn.Parameter(rotation)
        self.translation = nn.Parameter(translation)


def init(n_train_images: int, dtype=torch.float32, device=None) -> Extrinsics:
    zeros = lambda: torch.zeros((n_train_images, 3), dtype=dtype, device=device)
    return Extrinsics(zeros(), zeros())


def rotations(params: Extrinsics, img_idx: torch.Tensor) -> torch.Tensor:
    """SO(3) matrices for the given image indices: (B,) -> (B, 3, 3)."""
    return so3_exp(params.rotation)[img_idx]


def forward_origins(
    params: Extrinsics, img_idx: torch.Tensor, origins: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Translate origins into the predicted camera space (`:61-74`)."""
    t = params.translation[img_idx] / MAGIC_NUMBER_THE_SECOND
    return origins + t, t


def forward(
    params: Extrinsics, img_idx: torch.Tensor, origins: torch.Tensor,
    directions: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(new_origins, new_directions, R, t) (`forward:77-85`)."""
    new_o, t = forward_origins(params, img_idx, origins)
    R = rotations(params, img_idx)
    new_d = torch.einsum("bij,bj->bi", R, directions)
    return new_o, new_d, R, t
