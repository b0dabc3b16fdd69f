"""Shared experiment wiring: scene resolution, the blur-sigma ladder and the
common CLI flags."""
from __future__ import annotations

import argparse
import math
import os
import tempfile
from typing import Tuple

import numpy as np

from nerf_experiments_tpu_torch.data import synthetic


def resolve_scene(scene_path: str, image_size: int) -> str:
    """Resolve a scene path; "synthetic" generates a procedural Blender-format
    scene into a cache dir under the temporary directory."""
    if scene_path != "synthetic":
        return scene_path
    cache = os.path.join(tempfile.gettempdir(), f"netpu_synth_{image_size}")
    if not os.path.exists(os.path.join(cache, "transforms_train.json")):
        synthetic.generate_dataset(cache, image_size=image_size)
    return cache


def blur_sigmas_from_start(start_blur_sigma: float, n_blur_sigmas: int) -> Tuple[float, ...]:
    """The reference's geometric blur-sigma ladder (`barf/run_barf.py:48-53`):
    2^linspace(-1, log2(start), n-1) reversed, then 0.0 appended."""
    if start_blur_sigma <= 0.25:
        return (0.0, 0.0)
    if n_blur_sigmas <= 2:
        return (start_blur_sigma, 0.0)
    exps = np.linspace(-1, math.log2(start_blur_sigma), n_blur_sigmas - 1)
    ladder = [round(float(2.0**e), 2) for e in exps[::-1]]
    return tuple(ladder + [0.0])


def add_common_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--scene_path", type=str, default="synthetic",
                   help="Blender dataset dir, or 'synthetic' for the generated scene")
    p.add_argument("--mesh", type=str, default="",
                   help="multi-device layout; only '' (one device) is ported so far")
    p.add_argument("--image_size", type=int, default=64)
    p.add_argument("--batch_size", type=int, default=1024)
    p.add_argument("--max_epochs", type=int, default=100)
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--out_dir", type=str, default="runs/latest")
    p.add_argument("--seed", type=int, default=134534)
    p.add_argument("--wandb", action="store_true", default=False)
    p.add_argument("--bf16", action="store_true", default=False)
