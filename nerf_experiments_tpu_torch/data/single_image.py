"""Single-image pixel dataset for 2-D fitting experiments (a copy of the
JAX package's `data/single_image.py`: numpy only).

From `2d-reconstruction/data_loader.py:10-106` / `2d-ingp/data_loader.py`:
pixel coords normalized by width/height to [0,1), seeded pixel shuffle,
(0.9, 0.05, 0.05) train/val/test split.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np


@dataclasses.dataclass
class SingleImageData:
    coords: np.ndarray  # (P, 2) in [0,1)
    colors: np.ndarray  # (P, 3)
    splits: dict  # name -> (coords, colors)
    image_width: int
    image_height: int


def load(
    image: np.ndarray,
    pixel_shuffle_seed: int = 0,
    pixel_split_sizes: Tuple[float, float, float] = (0.9, 0.05, 0.05),
) -> SingleImageData:
    """image: (H, W, 3) float in [0,1]."""
    assert abs(sum(pixel_split_sizes) - 1.0) < 1e-9
    h, w = image.shape[:2]
    x, y = np.meshgrid(np.arange(w), np.arange(h), indexing="ij")
    x, y = x.ravel(), y.ravel()
    coords = np.stack([x / w, y / h], axis=1).astype(np.float32)
    colors = image[y, x].astype(np.float32)

    rng = np.random.default_rng(pixel_shuffle_seed)
    idx = rng.permutation(coords.shape[0])
    n_val = int(coords.shape[0] * pixel_split_sizes[1])
    n_test = int(coords.shape[0] * pixel_split_sizes[2])
    n_train = coords.shape[0] - n_val - n_test
    parts = {
        "train": idx[:n_train],
        "val": idx[n_train : n_train + n_val],
        "test": idx[n_train + n_val :],
    }
    splits = {k: (coords[v], colors[v]) for k, v in parts.items()}
    return SingleImageData(coords, colors, splits, w, h)


def load_path(image_path: str, **kw) -> SingleImageData:
    from PIL import Image

    img = np.asarray(Image.open(image_path).convert("RGB"), np.float32) / 255.0
    return load(img, **kw)


def procedural_test_image(size: int = 64, seed: int = 0) -> np.ndarray:
    """Structured test image (smooth gradients + edges) for self-contained runs."""
    y, x = np.mgrid[0:size, 0:size] / size
    r = 0.5 + 0.5 * np.sin(6.0 * x) * np.cos(4.0 * y)
    g = np.clip(((x - 0.5) ** 2 + (y - 0.5) ** 2) < 0.1, 0, 1) * 0.8 + 0.1
    b = (np.floor(x * 8) + np.floor(y * 8)) % 2 * 0.7 + 0.15
    return np.stack([r, g, b], axis=-1).astype(np.float32)


def reconstruct_image(apply_fn, data: SingleImageData, chunk: int = 65536) -> np.ndarray:
    """Full-image reconstruction: evaluate the fitted field at every pixel
    coordinate (the reference renders these qualitative images in its wandb
    logger, `2d-reconstruction/main.py`). apply_fn: (N, 2) -> (N, 3)."""
    preds = []
    for i in range(0, data.coords.shape[0], chunk):
        preds.append(np.asarray(apply_fn(data.coords[i : i + chunk])))
    pred = np.concatenate(preds, axis=0)
    img = np.zeros((data.image_height, data.image_width, 3), np.float32)
    # coords were built x-major (meshgrid indexing="ij"): flat index = x*H + y
    x = (data.coords[:, 0] * data.image_width).round().astype(np.int64)
    y = (data.coords[:, 1] * data.image_height).round().astype(np.int64)
    img[y, x] = pred
    return np.clip(img, 0.0, 1.0)


def save_png(path: str, img: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(path)


def full_image_psnr(recon: np.ndarray, data: SingleImageData) -> float:
    x = (data.coords[:, 0] * data.image_width).round().astype(np.int64)
    y = (data.coords[:, 1] * data.image_height).round().astype(np.int64)
    target = np.zeros_like(recon)
    target[y, x] = data.colors
    mse = float(np.mean((recon - target) ** 2))
    return -10.0 * math.log10(max(mse, 1e-12))
