"""Camera self-calibration: gauge alignment + batch transforms + pose error.

Semantics from `barf/model_camera_calibration.py:19-346`:
  * training_transform: noisy rays -> predicted space via the learnable
    extrinsics (`:296-337`);
  * validation_transform: ground-truth rays -> predicted model space via the
    Kabsch similarity from true train origins to predicted train origins
    (`:254-293`, `:159-193`, `:196-249`);
  * compute_pose_error: mean distance between true origins and the
    (pred -> raw)-aligned predicted origins (`:340-346`).

Ground-truth poses enter only through the gauge transform, never a loss.
"""
from __future__ import annotations

from typing import Tuple

import torch

from nerf_experiments_tpu_torch.cameras import extrinsics as ext
from nerf_experiments_tpu_torch.ops.kabsch import apply_similarity, kabsch


def predicted_train_origins(
    extrinsics_params: ext.Extrinsics, camera_origins_noisy: torch.Tensor
) -> torch.Tensor:
    """Extrinsics applied to every training camera's noisy origin."""
    idx = torch.arange(camera_origins_noisy.shape[0], device=camera_origins_noisy.device)
    origs_pred, _ = ext.forward_origins(extrinsics_params, idx, camera_origins_noisy)
    return origs_pred


def post_transform_params(
    extrinsics_params: ext.Extrinsics,
    camera_origins_raw: torch.Tensor,
    camera_origins_noisy: torch.Tensor,
    from_raw_to_pred: bool = True,
    remove_outliers: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(R, t, c) aligning raw <-> predicted train origins (`:196-249`)."""
    origs_pred = predicted_train_origins(extrinsics_params, camera_origins_noisy)
    if from_raw_to_pred:
        return kabsch(camera_origins_raw, origs_pred, remove_outliers=remove_outliers)
    return kabsch(origs_pred, camera_origins_raw, remove_outliers=remove_outliers)


def validation_transform_rays(
    origs_val: torch.Tensor,
    dirs_val: torch.Tensor,
    post_params: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ground-truth validation rays -> predicted model space (`:159-193`)."""
    R, t, c = post_params
    origs_model = apply_similarity(R, t, c, origs_val)
    dirs_model = torch.einsum("ij,...j->...i", R, dirs_val)
    return origs_model, dirs_model


def training_transform_rays(
    extrinsics_params: ext.Extrinsics,
    img_idx: torch.Tensor,
    origs_noisy: torch.Tensor,
    dirs_noisy: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Noisy training rays -> predicted space via extrinsics (`:296-337`)."""
    new_o, new_d, _, _ = ext.forward(extrinsics_params, img_idx, origs_noisy, dirs_noisy)
    return new_o, new_d


def compute_pose_error(
    extrinsics_params: ext.Extrinsics,
    camera_origins_raw: torch.Tensor,
    camera_origins_noisy: torch.Tensor,
) -> torch.Tensor:
    """Mean aligned-origin distance (`compute_pose_error:340-346`)."""
    origs_pred = predicted_train_origins(extrinsics_params, camera_origins_noisy)
    R, t, c = kabsch(origs_pred, camera_origins_raw, remove_outliers=True)
    aligned = apply_similarity(R, t, c, origs_pred)
    return torch.mean(torch.linalg.norm(camera_origins_raw - aligned, dim=-1))
