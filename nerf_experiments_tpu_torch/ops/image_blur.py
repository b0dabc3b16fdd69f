"""Separable Gaussian blur of the training targets, with a decaying sigma.

Port of the JAX package's `ops/image_blur.py`: the gaborf / mip_barf
at-fetch-time conv blur (`gaborf/dataset.py:324-440`) rebuilt as a blur of
the whole device-resident image stack. The trainer re-blurs the raw train
images whenever sigma decays and swaps the flat colours into its train
arrays (`Trainer.swap_train_colors`).

Taps: exp(-x^2 / (2 (relative_sigma max_side)^2)) at linspace(-K/2, K/2, K)
(the reference's half-integer positions), normalised; a Dirac once
sigma_abs <= 1e-7 max_side. Boundary: reflect without repeating the edge,
folded periodically (period 2(n - 1)), so any kernel size works on any image
side, also K // 2 >= n where `F.pad(mode="reflect")` refuses. The folding
and the taps go into one (n, n) band matrix a side, built in float64 on the
images' device from the taps and a one-hot tap placement cached a shape; the
blur is two fp32 matmuls (rows, then columns) with TF32 off for the call
only. A re-blur reads nothing from the host, so it does not stall the
device's queue.
"""
from __future__ import annotations

import functools
import numpy as np
import torch

from nerf_experiments_tpu_torch.utils.precision import full_fp32


def gaussian_kernel(kernel_size: int, relative_sigma: float, max_side_length: int,
                    device=None) -> torch.Tensor:
    """The 1-D taps (K,) in float64 on `device`,
    `_get_gaussian_blur_kernel:324-340`."""
    sigma_abs = float(relative_sigma) * max_side_length
    if sigma_abs <= 1e-7 * max_side_length:
        return torch.eye(kernel_size, dtype=torch.float64, device=device)[kernel_size // 2]
    x = torch.linspace(-kernel_size / 2.0, kernel_size / 2.0, kernel_size,
                       dtype=torch.float64, device=device)
    g = torch.exp(-(x ** 2) / (2.0 * max(sigma_abs, 1e-12) ** 2))
    return g / g.sum()


def reflect_index(i: np.ndarray, n: int) -> np.ndarray:
    """np.pad-style 'reflect' (no edge repeat) index folding, for any i."""
    period = 2 * (n - 1) if n > 1 else 1
    i = np.abs(i) % period
    return np.where(i >= n, period - i, i)


@functools.lru_cache(maxsize=8)
def _tap_placement(n: int, kernel_size: int, device: torch.device) -> torch.Tensor:
    """(K, n n) float64 one-hot on `device`: tap j of output pixel v reads
    input pixel reflect(v - K // 2 + j). Built on the host once a shape, so a
    new sigma's band matrix is one product on the device (no host transfer,
    no atomics: the same bits every time)."""
    v = np.arange(n)[None, :]
    j = np.arange(kernel_size)[:, None]
    src = reflect_index(v - kernel_size // 2 + j, n)
    placement = np.zeros((kernel_size, n, n))
    placement[j, v, src] = 1.0
    return torch.as_tensor(placement.reshape(kernel_size, n * n)).to(device)


def blur_matrix(n: int, kernel: torch.Tensor) -> torch.Tensor:
    """(n, n) float64 M on the kernel's device with M @ column == the 1-D
    reflect-padded convolution; taps that fold onto one pixel add up."""
    placement = _tap_placement(n, kernel.shape[0], kernel.device)
    return (kernel.double() @ placement).reshape(n, n)


def separable_gaussian_blur(images: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """images (..., H, W, C) fp32 -> blurred, rows then columns, in fp32
    without TF32; the band matrices rounded to fp32 once."""
    h, w = images.shape[-3], images.shape[-2]
    kernel = kernel.to(images.device)
    m_h = blur_matrix(h, kernel).to(images.dtype)
    m_w = blur_matrix(w, kernel).to(images.dtype)
    with full_fp32():
        out = torch.einsum("vh,...hwc->...vwc", m_h, images)
        return torch.einsum("uw,...hwc->...huc", m_w, out)


class ConvBlurTargets:
    """Trainer callback of the reference's decaying at-fetch blur.

    Holds the raw train images (N, H, W, 3) on their device. At every
    epoch-fraction milestone (`mip_barf/data_module.py:150-170` cadence) sigma
    becomes sigma0 decay^n, n = floor(epoch_frac / period) (n times the
    reference's `gaussian_blur_step`), and the trainer gets freshly blurred
    flat colours (R, n_sigma_slots, 3) in ray order (image-major pixels, as
    the ray store). The GARF loss reads the last slot (c_b of the reference's
    (c_r, c_b) pair); the earlier slots keep the raw colours. Sigma is a
    closed form of the epoch fraction, so a resumed run (`sync_to`) lands on
    the blur an uninterrupted run had."""

    def __init__(self, images: torch.Tensor, kernel_size: int = 81,
                 relative_sigma_start: float = 0.0, relative_sigma_decay: float = 0.99,
                 epoch_fraction_period: float = 0.02, n_sigma_slots: int = 1):
        self.images = images
        self.kernel_size = kernel_size
        self.sigma0 = float(relative_sigma_start)
        self.sigma = self.sigma0
        self.decay = float(relative_sigma_decay)
        self.period = float(epoch_fraction_period)
        self.n_sigma_slots = n_sigma_slots
        self.max_side = max(images.shape[1], images.shape[2])
        self.n_applied = 0

    def milestones(self, epoch_frac: float) -> int:
        return int(epoch_frac // self.period)

    def sync_to(self, epoch_frac: float) -> None:
        """Jump the ladder to the state an uninterrupted run has at
        `epoch_frac` (checkpoint resume)."""
        self.n_applied = self.milestones(epoch_frac)
        self.sigma = self.sigma0 * self.decay ** self.n_applied

    def flat_colors(self) -> torch.Tensor:
        """(R, n_sigma_slots, 3) at the current sigma: the raw colours, the
        blurred ones last."""
        k = gaussian_kernel(self.kernel_size, self.sigma, self.max_side,
                            device=self.images.device)
        blurred = separable_gaussian_blur(self.images, k).reshape(-1, 3)
        raw = self.images.reshape(-1, 3)
        return torch.stack([raw] * (self.n_sigma_slots - 1) + [blurred], dim=1)

    def __call__(self, trainer, state, step: int, epoch_frac: float) -> None:
        n = self.milestones(epoch_frac)
        if n <= self.n_applied:
            return
        self.n_applied = n
        self.sigma = self.sigma0 * self.decay ** n
        trainer.swap_train_colors(self.flat_colors())
