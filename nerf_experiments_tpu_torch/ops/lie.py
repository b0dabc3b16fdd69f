"""so(3)/SO(3) and se(3)/SE(3) exponential maps.

Closed-form Rodrigues maps with Taylor fallbacks near theta = 0, so the maps
have no data-dependent branch and stay exactly differentiable (`torch.where`
on both branches with safe arguments). Semantics of
`barf/model_camera_extrinsics.py:22-43` and `barf/Lie_barf.py:3-82`.
"""
from __future__ import annotations

import torch

_TAYLOR_EPS = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    """Cross-product (skew-symmetric) matrix of w: (..., 3) -> (..., 3, 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zeros = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zeros, -wz, wy], dim=-1),
            torch.stack([wz, zeros, -wx], dim=-1),
            torch.stack([-wy, wx, zeros], dim=-1),
        ],
        dim=-2,
    )


def _sin_t_over_t(t2: torch.Tensor) -> torch.Tensor:
    """sin(t)/t with Taylor fallback, as a function of t^2 (smooth at 0)."""
    t = torch.sqrt(torch.clamp(t2, min=_TAYLOR_EPS))
    taylor = 1.0 - t2 / 6.0 + t2 * t2 / 120.0
    return torch.where(t2 < _TAYLOR_EPS, taylor, torch.sin(t) / t)


def _one_minus_cos_over_t2(t2: torch.Tensor) -> torch.Tensor:
    """(1-cos(t))/t^2 with Taylor fallback."""
    t2_safe = torch.clamp(t2, min=_TAYLOR_EPS)
    t = torch.sqrt(t2_safe)
    taylor = 0.5 - t2 / 24.0 + t2 * t2 / 720.0
    return torch.where(t2 < _TAYLOR_EPS, taylor, (1.0 - torch.cos(t)) / t2_safe)


def _t_minus_sin_over_t3(t2: torch.Tensor) -> torch.Tensor:
    """(t-sin(t))/t^3 with Taylor fallback (for the SE(3) V matrix)."""
    t2_safe = torch.clamp(t2, min=_TAYLOR_EPS)
    t = torch.sqrt(t2_safe)
    taylor = 1.0 / 6.0 - t2 / 120.0 + t2 * t2 / 5040.0
    return torch.where(t2 < _TAYLOR_EPS, taylor, (t - torch.sin(t)) / (t2_safe * t))


def _rodrigues(w: torch.Tensor):
    theta2 = torch.sum(w * w, dim=-1)[..., None, None]
    W = hat(w)
    W2 = W @ W
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return theta2, W, W2, eye


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Exponential map so(3) -> SO(3) (Rodrigues). (..., 3) -> (..., 3, 3)."""
    theta2, W, W2, eye = _rodrigues(w)
    return eye + _sin_t_over_t(theta2) * W + _one_minus_cos_over_t2(theta2) * W2


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Logarithm map SO(3) -> so(3). (..., 3, 3) -> (..., 3).

    Stable away from theta = pi (enough for pose-noise scales)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) / 2.0, -1.0 + 1e-7, 1.0 - 1e-7)
    theta = torch.arccos(cos_theta)
    vee = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )
    # vee = 2 sin(theta)/theta * w  =>  w = vee / (2 sinc(theta))
    return vee / (2.0 * _sin_t_over_t(theta * theta)[..., None] + 1e-12)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """Exponential map se(3) -> SE(3). xi = (w, v): (..., 6) -> (..., 4, 4)."""
    w, v = xi[..., :3], xi[..., 3:]
    theta2, W, W2, eye = _rodrigues(w)
    R = eye + _sin_t_over_t(theta2) * W + _one_minus_cos_over_t2(theta2) * W2
    V = eye + _one_minus_cos_over_t2(theta2) * W + _t_minus_sin_over_t3(theta2) * W2
    t = (V @ v[..., None])[..., 0]
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=xi.dtype, device=xi.device)
    bottom = bottom.expand(top.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def rotate(R: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Apply rotation matrices to vectors: (..., 3, 3) @ (..., 3) -> (..., 3)."""
    return torch.einsum("...ij,...j->...i", R, x)
