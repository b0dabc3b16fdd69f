"""Kabsch alignment with scale and fixed-shape outlier rejection.

Semantics from `barf/model_camera_calibration.py:69-156`: align
point_cloud_from to point_cloud_to with R, t, c such that
``to_hat = (R @ from) * c + t``; with ``remove_outliers=True`` the algorithm
runs once, drops the top-10% largest-residual points, and re-runs. The drop is
a 0/1 weight over all points (weighted Kabsch), which equals removing them.
"""
from __future__ import annotations

from typing import Tuple

import torch


def _weighted_kabsch(
    pts_from: torch.Tensor, pts_to: torch.Tensor, w: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Weighted similarity alignment: min ||(R @ from_i) * c + t - to_i||^2
    over rotations R, scale c, translation t, weighted by w (N,).

    Returns (R (3,3), t (1,3), c scalar)."""
    w = w.to(pts_from.dtype)
    w_sum = torch.sum(w) + 1e-12
    wn = (w / w_sum)[:, None]

    mean_from = torch.sum(wn * pts_from, dim=0, keepdim=True)
    mean_to = torch.sum(wn * pts_to, dim=0, keepdim=True)
    cf = pts_from - mean_from
    ct = pts_to - mean_to

    c = torch.sqrt(torch.sum(wn * ct * ct)) / (torch.sqrt(torch.sum(wn * cf * cf)) + 1e-12)

    H = (wn * cf).T @ ct  # (3, 3)
    U, _, Vt = torch.linalg.svd(H.float())
    d = torch.linalg.det(Vt.T @ U.T)
    K = torch.diag(torch.stack([torch.ones_like(d), torch.ones_like(d), d]))
    R = (Vt.T @ K @ U.T).to(pts_from.dtype)

    t = mean_to - (R @ mean_from.T).T * c
    return R, t, c


def kabsch(
    pts_from: torch.Tensor,
    pts_to: torch.Tensor,
    remove_outliers: bool = True,
    outlier_quantile: float = 0.9,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kabsch + scale, optionally re-run without the top-(1-q) residuals:
    keep points whose distance is strictly below the quantile."""
    ones = torch.ones(pts_from.shape[0], dtype=pts_from.dtype, device=pts_from.device)
    R, t, c = _weighted_kabsch(pts_from, pts_to, ones)
    if not remove_outliers:
        return R, t, c

    pred = (pts_from @ R.T) * c + t
    dist = torch.linalg.norm(pred - pts_to, dim=1)
    thresh = torch.quantile(dist, outlier_quantile)
    keep = (dist < thresh).to(pts_from.dtype)
    # degenerate guard: if everything is an "outlier", use uniform weights
    keep = torch.where(torch.sum(keep) < 3, ones, keep)
    return _weighted_kabsch(pts_from, pts_to, keep)


def apply_similarity(
    R: torch.Tensor, t: torch.Tensor, c: torch.Tensor, pts: torch.Tensor
) -> torch.Tensor:
    """Apply (R, t, c): pts (..., 3) -> (R @ pts) * c + t."""
    return torch.einsum("ij,...j->...i", R, pts) * c + t
