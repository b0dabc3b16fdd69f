"""Procedural Blender-format scene generator.

The reference trains on the Blender-synthetic lego scene (not shipped here).
This module generates a procedurally textured analytic scene — colored
spheres + a ground slab inside the unit region — renders ground-truth images
with a dense-ray-march emission-absorption integrator, and writes a
Blender-style dataset (transforms_{split}.json + RGBA PNGs) so the full
loader → trainer → renderer pipeline is exercised end-to-end, including the
alpha→white compositing path (`barf/dataset.py:227-228`).

Camera rig matches Blender-synthetic conventions: cameras on a sphere of
radius ~4 looking at the origin, up = +z, camera_angle_x ≈ 0.6911 (lego's).
"""
from __future__ import annotations

import json
import math
import os
from typing import Callable, Tuple

import numpy as np

CAMERA_ANGLE_X = 0.6911112070083618  # lego's camera_angle_x


def look_at_c2w(position: np.ndarray, target: np.ndarray, up: np.ndarray) -> np.ndarray:
    """Camera-to-world with camera looking down -z (OpenGL/Blender style)."""
    forward = target - position
    forward = forward / np.linalg.norm(forward)
    z_axis = -forward  # camera -z points at target
    x_axis = np.cross(up, z_axis)
    x_axis = x_axis / np.linalg.norm(x_axis)
    y_axis = np.cross(z_axis, x_axis)
    c2w = np.eye(4)
    c2w[:3, 0] = x_axis
    c2w[:3, 1] = y_axis
    c2w[:3, 2] = z_axis
    c2w[:3, 3] = position
    return c2w


def _scene_density_color(pts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Analytic density + rgb at world points (B, 3).

    A cluster of colored spheres and a box — enough geometric and chromatic
    structure for PSNR-meaningful NeRF fits at small resolutions.
    """
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    density = np.zeros(pts.shape[:-1], dtype=np.float64)
    color = np.zeros(pts.shape[:-1] + (3,), dtype=np.float64)

    spheres = [
        (np.array([0.0, 0.0, 0.2]), 0.55, np.array([0.9, 0.2, 0.15])),
        (np.array([0.55, 0.3, -0.1]), 0.3, np.array([0.2, 0.75, 0.25])),
        (np.array([-0.5, -0.25, 0.0]), 0.35, np.array([0.2, 0.35, 0.9])),
        (np.array([0.1, -0.55, 0.45]), 0.22, np.array([0.95, 0.85, 0.2])),
    ]
    for center, radius, rgb in spheres:
        d2 = np.sum((pts - center) ** 2, axis=-1)
        inside = d2 < radius**2
        sigma = 60.0 * np.exp(-d2 / (2 * (radius / 2) ** 2))
        sigma = np.where(inside, sigma, 0.0)
        take = sigma > density
        density = np.where(take, sigma, density)
        color = np.where(take[..., None], rgb, color)

    # box slab under the spheres (checker texture)
    in_box = (np.abs(x) < 0.8) & (np.abs(y) < 0.8) & (z > -0.55) & (z < -0.35)
    checker = ((np.floor(x * 5) + np.floor(y * 5)) % 2).astype(np.float64)
    box_color = np.stack(
        [0.6 + 0.3 * checker, 0.5 + 0.2 * checker, 0.4 + 0.1 * checker], axis=-1
    )
    density = np.where(in_box, 80.0, density)
    color = np.where(in_box[..., None], box_color, color)
    return density, color


def render_image(
    c2w: np.ndarray,
    image_width: int,
    image_height: int,
    camera_angle_x: float = CAMERA_ANGLE_X,
    n_samples: int = 128,
    near: float = 2.0,
    far: float = 6.5,
) -> np.ndarray:
    """Ground-truth RGBA render via dense ray marching. Returns (H, W, 4) in [0,1]."""
    focal = image_width / 2.0 / math.tan(camera_angle_x / 2.0)
    ys = -(np.arange(image_height) - (image_height - 1) / 2) / focal
    xs = (np.arange(image_width) - (image_width - 1) / 2) / focal
    yy, xx = np.meshgrid(ys, xs, indexing="ij")
    dirs_cam = np.stack([xx, yy, -np.ones_like(xx)], axis=-1)
    dirs_cam /= np.linalg.norm(dirs_cam, axis=-1, keepdims=True)
    dirs = dirs_cam @ c2w[:3, :3].T  # (H, W, 3)
    origin = c2w[:3, 3]

    t = np.linspace(near, far, n_samples)
    dt = t[1] - t[0]
    rgb_acc = np.zeros((image_height, image_width, 3))
    trans = np.ones((image_height, image_width))
    for i in range(n_samples):
        pts = origin + dirs * t[i]
        sigma, col = _scene_density_color(pts)
        alpha = 1.0 - np.exp(-sigma * dt)
        w = trans * alpha
        rgb_acc += w[..., None] * col
        trans *= 1.0 - alpha
    alpha_img = 1.0 - trans
    return np.concatenate([rgb_acc, alpha_img[..., None]], axis=-1)


def generate_dataset(
    out_dir: str,
    n_train: int = 12,
    n_val: int = 4,
    n_test: int = 4,
    image_size: int = 64,
    seed: int = 0,
    radius: float = 4.0,
    n_samples: int = 96,
    render_fn: Callable = render_image,
) -> str:
    """Write a Blender-format dataset under out_dir. Returns out_dir.
    `render_fn` renders each view (`render_image`'s signature); the poses and
    the file layout do not depend on it (`data/synthetic_fast.py` passes the
    on-card renderer)."""
    try:
        from PIL import Image
    except ImportError as e:  # pragma: no cover
        raise RuntimeError("PIL required to write synthetic datasets") from e

    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)

    splits = [("train", n_train), ("val", n_val), ("test", n_test)]
    frame_idx = 0
    for split, n_images in splits:
        img_dir = os.path.join(out_dir, split)
        os.makedirs(img_dir, exist_ok=True)
        frames = []
        for i in range(n_images):
            # poses on the upper hemisphere, jittered golden-angle azimuths
            az = (frame_idx * 2.399963) + rng.uniform(-0.1, 0.1)
            el = rng.uniform(0.2, 1.0)
            pos = radius * np.array(
                [math.cos(az) * math.cos(el), math.sin(az) * math.cos(el), math.sin(el)]
            )
            c2w = look_at_c2w(pos, np.zeros(3), np.array([0.0, 0.0, 1.0]))
            rgba = render_fn(c2w, image_size, image_size, n_samples=n_samples)
            img = Image.fromarray((np.clip(rgba, 0, 1) * 255).astype(np.uint8), "RGBA")
            name = f"r_{i}"
            img.save(os.path.join(img_dir, f"{name}.png"))
            frames.append(
                {
                    "file_path": f"./{split}/{name}",
                    "rotation": 0.0,
                    "transform_matrix": c2w.tolist(),
                }
            )
            frame_idx += 1
        with open(os.path.join(out_dir, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": CAMERA_ANGLE_X, "frames": frames}, f)
    return out_dir
