"""Learnable-bandwidth activations: Gaussian (GARF), Gabor (GaborF), SARF.

Port of `nerf_experiments_tpu/encodings/activations.py`. The reference writes
each with a hand-written `th.autograd.Function` backward (`barf/gaussian.py`,
`gaborf/gabor.py`) to save memory; the gradients are exact. Here the Gauss
and Gabor activations are `torch.autograd.Function`s that save only their
inputs and recompute the transcendentals in the backward, as the JAX
package's custom VJPs do. `sarf_act` is plain autograd, as in JAX.

  * gauss: exp(-x^2 v), v = isd^2 + 1e-6 (`barf/gaussian.py:57-63`);
  * gabor: exp(-v x^2) cos(s x), s = spread * anneal;
  * sarf (live forward, `sarf/activation.py:62-65`): cos(anneal f / (x'^2 +
    1/f^2)) exp(-x'^2) with x' the sign-safe shift of x.

A parameter vector broadcasts over the last (feature) axis; its gradient is
summed over the leading axes. SIREN comes with `models/siren.py` (ROADMAP).
"""
from __future__ import annotations

import torch


def _sum_to(g: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Sum a broadcast gradient back to the shape of `like` (features last)."""
    if g.dim() > like.dim():
        g = g.reshape(-1, like.shape[-1]).sum(dim=0)
    return g.reshape(like.shape)


# ---------------------------------------------------------------- Gaussian
class GaussAct(torch.autograd.Function):
    """exp(-x^2 v); saves (x, v), recomputes the exponential backward."""

    @staticmethod
    def forward(ctx, x, inv_variance):
        ctx.save_for_backward(x, inv_variance)
        return torch.exp(-(x**2) * inv_variance)

    @staticmethod
    def backward(ctx, g):
        x, v = ctx.saved_tensors
        x2 = x**2
        g_exp = g * torch.exp(-x2 * v)
        dx = -g_exp * 2.0 * x * v
        dv = _sum_to(-g_exp * x2, v)
        return dx, dv


def gauss_act(x: torch.Tensor, inv_variance: torch.Tensor) -> torch.Tensor:
    """exp(-x^2 * v). v broadcasts over the feature (last) axis."""
    return GaussAct.apply(x, inv_variance)


def gauss_from_isd(x: torch.Tensor, inv_standard_deviation: torch.Tensor) -> torch.Tensor:
    """GaussAct.forward parity: v = isd^2 + 1e-6."""
    return gauss_act(x, inv_standard_deviation**2 + 1e-6)


# ------------------------------------------------------------------- Gabor
class GaborAct(torch.autograd.Function):
    """exp(-v x^2) cos(s x); saves (x, v, s), recomputes backward."""

    @staticmethod
    def forward(ctx, x, inv_variance, spread):
        ctx.save_for_backward(x, inv_variance, spread)
        return torch.exp(-inv_variance * x**2) * torch.cos(spread * x)

    @staticmethod
    def backward(ctx, g):
        x, v, s = ctx.saved_tensors
        go_mevx2 = -torch.exp(-v * x**2) * g
        cos_sx, sin_sx = torch.cos(s * x), torch.sin(s * x)
        dx = go_mevx2 * (2.0 * cos_sx * v * x + s * sin_sx)
        dv = _sum_to(go_mevx2 * x**2 * cos_sx, v)
        ds = _sum_to(go_mevx2 * x * sin_sx, s)
        return dx, dv, ds


def gabor_act(x: torch.Tensor, inv_variance: torch.Tensor,
              spread: torch.Tensor) -> torch.Tensor:
    """exp(-v x^2) cos(s x)."""
    return GaborAct.apply(x, inv_variance, spread)


def gabor_from_isd(x, inv_standard_deviation, spread, anneal=1.0):
    """anneal in [0, 1] scales the oscillation frequency (spread): at 0 the
    activation is exactly the Gaussian, at 1 the full Gabor."""
    return gabor_act(x, inv_standard_deviation**2 + 1e-6, spread * anneal)


# -------------------------------------------------------------------- SARF
def _sign_safe(x: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """(signbit(x)*2-1) * (|x| + eps): the reference's zero-avoidance shift.
    It maps x >= 0 to -(x + eps) and x < 0 to |x| + eps (a sign flip that
    only reaches the live formula through even powers). |x| is written as
    x * (+1 for x >= 0, else -1) so that its gradient at +-0 is 1, JAX's
    (torch.abs has 0 there)."""
    abs_x = x * torch.where(x >= 0, 1.0, -1.0).to(x.dtype)
    return (torch.signbit(x).to(x.dtype) * 2.0 - 1.0) * (abs_x + eps)


def sarf_act(x: torch.Tensor, frequency: torch.Tensor, anneal=1.0) -> torch.Tensor:
    """Live SARF forward: cos(anneal f / (x'^2 + 1/f^2)) exp(-x'^2), x'
    sign-safe shifted; at anneal 0 the pure Gaussian bump exp(-x'^2)."""
    xs = _sign_safe(x)
    theta = frequency / (xs**2 + 1.0 / frequency**2)
    return torch.cos(anneal * theta) * torch.exp(-(xs**2))


def sarf_sinc_act(x: torch.Tensor, frequency: torch.Tensor) -> torch.Tensor:
    """The dead-code sin(fx)/x variant (`sarf/activation.py:8-37`), kept for
    ablation parity."""
    xs = _sign_safe(x)
    return torch.sin(frequency * xs) / xs
