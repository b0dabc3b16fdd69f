"""Scalar metrics.

PSNR definition from `barf/model_interpolation.py:588-597` (-10·log10(mse));
pose error from `barf/model_camera_calibration.py:340-346` (mean L2 between
Kabsch-aligned predicted camera origins and true origins).
"""
from __future__ import annotations

import torch

from nerf_experiments_tpu_torch.ops.kabsch import apply_similarity, kabsch


def psnr(mse: torch.Tensor) -> torch.Tensor:
    """PSNR = -10 * log10(mse). NaN below the reference's 1e-7 guard."""
    mse = torch.as_tensor(mse, dtype=torch.float32)
    value = -10.0 * torch.log10(torch.clamp(mse, min=1e-12))
    return torch.where(mse <= 1e-7, torch.full_like(value, float("nan")), value)


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


def pose_error(origs_raw: torch.Tensor, origs_pred: torch.Tensor) -> torch.Tensor:
    """Mean distance between true origins and aligned predicted origins
    (predicted -> raw, outlier-rejected Kabsch)."""
    R, t, c = kabsch(origs_pred, origs_raw, remove_outliers=True)
    aligned = apply_similarity(R, t, c, origs_pred)
    return torch.mean(torch.linalg.norm(origs_raw - aligned, dim=-1))
