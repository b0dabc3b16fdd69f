"""On-device ray-batch sampling + blur-pyramid colour interpolation.

Replaces the reference's DataLoader worker processes
(`barf/data_module.py:202-263`) with one device-resident store: every ray
and colour of a split lives on the device as flat (N*H*W, ...) tensors, and
each train step gathers a random index batch there.

`blurred_pixel_colors` reproduces `get_blurred_pixel_colors`
(`barf/data_module.py:276-369`): linear interpolation between the two nearest
blur-pyramid levels; below sigma 0.25 the sharp image; above the largest
sigma the most blurred level. Output packs [interpolated, sharp] like the
reference's (N, 2, 3).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from nerf_experiments_tpu_torch.data.blender import ImagePoseData


@dataclasses.dataclass
class RayStore:
    """Flat device tensors over all pixels of a split."""

    origins_raw: torch.Tensor  # (R, 3)
    origins_noisy: torch.Tensor  # (R, 3)
    dirs_raw: torch.Tensor  # (R, 3)
    dirs_noisy: torch.Tensor  # (R, 3)
    colors: torch.Tensor  # (R, n_sigmas, 3)
    img_idx: torch.Tensor  # (R,) int64, ORIGINAL image indices (index_to_index)
    pixel_width: float
    gaussian_blur_sigmas: Tuple[float, ...]
    camera_origins_raw: torch.Tensor  # (N, 3)
    camera_origins_noisy: torch.Tensor  # (N, 3)
    hw: int = 0  # rays per image (H*W); 0 = unknown (hand-built stores)

    @property
    def n_rays(self) -> int:
        return self.origins_raw.shape[0]

    @property
    def device(self) -> torch.device:
        return self.origins_raw.device

    def arrays(self) -> dict:
        """The per-ray tensors as a dict (what `gather_batch_arrays` reads)."""
        return {
            "origins_raw": self.origins_raw,
            "origins_noisy": self.origins_noisy,
            "dirs_raw": self.dirs_raw,
            "dirs_noisy": self.dirs_noisy,
            "colors": self.colors,
            "img_idx": self.img_idx,
        }


def make_ray_store(data: ImagePoseData, device=None) -> RayStore:
    n, h, w = data.n_images, data.image_height, data.image_width
    hw = h * w

    def to_dev(x):
        return torch.as_tensor(np.ascontiguousarray(x), device=device)

    img_idx = np.repeat(np.array([data.index_to_index[i] for i in range(n)], np.int64), hw)
    return RayStore(
        origins_raw=to_dev(data.ray_origins.reshape(-1, 3)),
        origins_noisy=to_dev(data.ray_origins_noisy.reshape(-1, 3)),
        dirs_raw=to_dev(data.ray_directions.reshape(-1, 3)),
        dirs_noisy=to_dev(data.ray_directions_noisy.reshape(-1, 3)),
        colors=to_dev(data.images.reshape(n * hw, len(data.gaussian_blur_sigmas), 3)),
        img_idx=to_dev(img_idx),
        pixel_width=data.pixel_width,
        gaussian_blur_sigmas=tuple(data.gaussian_blur_sigmas),
        camera_origins_raw=to_dev(data.camera_origins),
        camera_origins_noisy=to_dev(data.camera_origins_noisy),
        hw=hw,
    )


def gather_batch_arrays(arrays: dict, pixel_width: float, idx: torch.Tensor) -> dict:
    """Batch gather from the flat ray tensors: origs_raw / origs_noisy /
    dirs_raw / dirs_noisy (B, 3), colors (B, n_sigmas, 3), img_idx (B,),
    pixel_width (B, 1)."""
    b = idx.shape[0]
    return {
        "origs_raw": arrays["origins_raw"][idx],
        "origs_noisy": arrays["origins_noisy"][idx],
        "dirs_raw": arrays["dirs_raw"][idx],
        "dirs_noisy": arrays["dirs_noisy"][idx],
        "colors": arrays["colors"][idx],
        "img_idx": arrays["img_idx"][idx],
        "pixel_width": torch.full((b, 1), float(pixel_width), device=idx.device),
    }


def blurred_pixel_colors(colors: torch.Tensor, sigmas: Sequence[float],
                         sigma: float) -> torch.Tensor:
    """(B, n_sigmas, 3), pyramid sigmas (descending, last = 0), sigma ->
    (B, 2, 3) = [interpolated at sigma, sharp].

    The branchless form of the JAX package (`data/sampler.py:111-145`): the
    lerp of every adjacent sigma pair whose interval holds sigma, in order,
    the last match winning, so equal results for every sigma."""
    sigmas = list(sigmas)
    if sigmas != sorted(sigmas, reverse=True):
        raise ValueError(
            f"gaussian_blur_sigmas must be descending (most-blurred first, "
            f"sharp last), got {sigmas}")
    sharp = colors[:, -1]
    sigma = float(sigma)
    out = colors[:, 0] if sigma >= max(sigmas) else sharp
    for i in range(len(sigmas) - 1):
        s_hi, s_lo = sigmas[i], sigmas[i + 1]
        if s_hi > s_lo and s_lo <= sigma < s_hi:
            # the JAX package computes the coefficient in float32
            coeff = np.float32(sigma - s_hi) / np.float32(s_lo - s_hi + 1e-8)
            out = colors[:, i + 1] * float(coeff) + colors[:, i] * float(np.float32(1.0) - coeff)
    if sigma <= 0.25:
        out = sharp
    return torch.stack([out, sharp], dim=1)
