"""Blender-synthetic dataset loader (ImagePoseDataset equivalent).

Reproduces `barf/dataset.py` semantics as a host-side numpy pipeline (a copy
of the JAX package's loader, with the port's `so3_exp` and the numpy ray
path):
  * PNG load, bilinear resize, alpha→white composite (`_load_images:161-248`);
  * per-image Gaussian blur pyramid over `gaussian_blur_sigmas`, no blur
    below sigma 0.25 (`gaussian_blur:250-262`);
  * focal length from camera_angle_x; c2w orthogonality/scale validation
    (`_load_camera_info:264-313`);
  * space transform (center on mean camera, scale by 3× max pairwise camera
    distance or explicit) (`_transform_camera_to_world:315-381`);
  * full-ray precomputation (N, H*W, 3) (`_get_directions_meshgrid`,
    `_meshgrid_to_world`);
  * seeded per-camera pose noise (`_apply_noise:513-561`);
  * image-level subsetting with index_to_index bookkeeping
    (`subset_dataset:565-610`);
  * the deliberate pose-corruption test hook (`:484-511`).

The pose noise is drawn by numpy from the same seed as the JAX package's
loader, so the noisy poses agree with it.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import pathlib
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

import torch

from nerf_experiments_tpu_torch.ops import lie


def _stable_split_hash(split: str) -> int:
    """Deterministic stand-in for the reference's `hash(purpose)` salt
    (`barf/data_module.py:123`) — Python's hash() is not run-stable."""
    return zlib.crc32(split.encode())


@dataclasses.dataclass
class ImagePoseData:
    """All host-side arrays for one split. Everything numpy, fixed shapes."""

    image_height: int
    image_width: int
    focal_length: float
    pixel_width: float  # 1 / focal_length
    gaussian_blur_sigmas: List[float]

    images: np.ndarray  # (N, H, W, n_sigmas, 3) float32 in [0, 1]
    camera_to_worlds: np.ndarray  # (N, 4, 4)
    camera_origins: np.ndarray  # (N, 3)
    camera_directions: np.ndarray  # (N, 3)
    ray_origins: np.ndarray  # (N, H*W, 3)
    ray_directions: np.ndarray  # (N, H*W, 3)
    camera_origins_noisy: np.ndarray
    camera_directions_noisy: np.ndarray
    ray_origins_noisy: np.ndarray
    ray_directions_noisy: np.ndarray

    space_transform_scale: float
    space_transform_translate: np.ndarray

    image_name_to_index: Dict[str, int]
    image_index_to_name: Dict[int, str]
    index_to_index: Dict[int, int]

    @property
    def n_images(self) -> int:
        return self.images.shape[0]

    @property
    def n_rays(self) -> int:
        return self.n_images * self.image_height * self.image_width

    def subset(self, image_indices: Sequence) -> "ImagePoseData":
        """Image-level shallow subset with index bookkeeping (`subset_dataset`)."""
        idx = [
            self.image_name_to_index[i] if isinstance(i, str) else int(i)
            for i in image_indices
        ]
        out = dataclasses.replace(
            self,
            images=self.images[idx],
            camera_to_worlds=self.camera_to_worlds[idx],
            camera_origins=self.camera_origins[idx],
            camera_directions=self.camera_directions[idx],
            ray_origins=self.ray_origins[idx],
            ray_directions=self.ray_directions[idx],
            camera_origins_noisy=self.camera_origins_noisy[idx],
            camera_directions_noisy=self.camera_directions_noisy[idx],
            ray_origins_noisy=self.ray_origins_noisy[idx],
            ray_directions_noisy=self.ray_directions_noisy[idx],
            index_to_index={i: self.index_to_index[j] for i, j in enumerate(idx)},
            image_index_to_name={i: self.image_index_to_name[j] for i, j in enumerate(idx)},
        )
        out.image_name_to_index = {n: i for i, n in out.image_index_to_name.items()}
        return out

    def corrupt_poses_for_gauge_test(self) -> Tuple[np.ndarray, np.ndarray, float]:
        """The reference's validation-transform test hook
        (`_screw_up_original_camera_poses_..._:484-511`): applies the inverse
        of a known (R, t, c) to the raw poses; the Kabsch gauge transform
        must recover (R, t, c). Returns the injected transform."""
        R = lie.so3_exp(torch.tensor([23.0, 11.0, 31.0])).numpy()
        R_inv = R.T
        t = np.array([7.0, 2.0, -11.0])
        c = 3.6
        self.camera_directions = self.camera_directions @ R_inv.T
        self.camera_origins = ((self.camera_origins - t) @ R_inv.T) / c
        self.ray_directions = self.ray_directions @ R_inv.T
        self.ray_origins = ((self.ray_origins - t) @ R_inv.T) / c
        return R, t, c


def _gaussian_blur_pyramid(img, sigmas: Sequence[float], min_sigma: float = 0.25):
    """PIL Gaussian blur per sigma; identity below min_sigma (`:250-262`)."""
    from PIL import ImageFilter

    out = []
    for sigma in sigmas:
        if sigma > min_sigma:
            out.append(img.filter(ImageFilter.GaussianBlur(radius=sigma)))
        else:
            out.append(img)
    return out


def load(
    scene_path: str,
    split: str,
    image_width: int,
    image_height: int,
    space_transform_scale: Optional[float] = None,
    space_transform_translate: Optional[np.ndarray] = None,
    rotation_noise_sigma: float = 0.0,
    translation_noise_sigma: float = 0.0,
    noise_seed: Optional[int] = None,
    gaussian_blur_sigmas: Sequence[float] = (0.0,),
    verbose: bool = False,
) -> ImagePoseData:
    """Load one split directory + transforms_{split}.json."""
    from PIL import Image

    images_path = os.path.join(scene_path, split)
    camera_info_path = os.path.join(scene_path, f"transforms_{split}.json")

    with open(camera_info_path) as f:
        camera_data = json.load(f)
    focal = image_width / 2.0 / math.tan(camera_data["camera_angle_x"] / 2.0)

    c2w_by_name: Dict[str, np.ndarray] = {}
    for frame in camera_data["frames"]:
        c2w = np.asarray(frame["transform_matrix"], dtype=np.float64)
        if not np.isclose(c2w[-1, -1], 1.0):
            raise ValueError(f"c2w scale != 1 in {frame['file_path']}")
        err = np.abs(c2w[:3, :3] @ c2w[:3, :3].T - np.eye(3)).max()
        if err > 2e-5:
            raise ValueError(f"c2w not orthogonal (err {err}) in {frame['file_path']}")
        c2w_by_name[pathlib.PurePath(frame["file_path"]).stem] = c2w

    image_names = sorted(
        pathlib.PurePath(p).stem for p in os.listdir(images_path)
    )
    n_images = len(image_names)
    name_to_index = {n: i for i, n in enumerate(image_names)}
    index_to_name = {i: n for i, n in enumerate(image_names)}
    index_to_index = {i: i for i in range(n_images)}

    sigmas = list(gaussian_blur_sigmas)
    white = Image.new("RGBA", (image_width, image_height), (255, 255, 255, 255))
    stack = np.empty((n_images, image_height, image_width, len(sigmas), 3), np.float32)
    for i, name in enumerate(image_names):
        img = Image.open(os.path.join(images_path, f"{name}.png"))
        img = img.resize((image_width, image_height), Image.BILINEAR)
        if img.mode != "RGBA":
            img = img.convert("RGBA")
        img = Image.alpha_composite(white, img).convert("RGB")
        for s, blurred in enumerate(_gaussian_blur_pyramid(img, sigmas)):
            stack[i, :, :, s, :] = np.asarray(blurred, np.float32) / 255.0

    c2w = np.stack([c2w_by_name[index_to_name[i]] for i in range(n_images)])
    cam_pos = c2w[:, :3, 3]
    if space_transform_scale is None:
        diff = cam_pos[:, None] - cam_pos[None, :]
        space_transform_scale = float(3.0 * np.linalg.norm(diff, axis=-1).max())
    if space_transform_translate is None:
        space_transform_translate = cam_pos.mean(axis=0)
    space_transform_translate = np.asarray(space_transform_translate, np.float64)

    c2w = c2w.copy()
    c2w[:, :3, 3] = (c2w[:, :3, 3] - space_transform_translate) / space_transform_scale

    camera_origins = c2w[:, :3, 3].astype(np.float32)
    camera_directions = (c2w[:, :3, :3] @ np.array([0.0, 0.0, -1.0])).astype(np.float32)

    # meshgrid directions, row-major pixel order (`_get_directions_meshgrid`)
    ys = -(np.arange(image_height) - (image_height - 1) / 2) / focal
    xs = (np.arange(image_width) - (image_width - 1) / 2) / focal
    yy, xx = np.meshgrid(ys, xs, indexing="ij")
    mesh = np.stack([xx, yy, -np.ones_like(xx)], axis=-1).reshape(-1, 3)
    mesh /= np.linalg.norm(mesh, axis=-1, keepdims=True)

    ray_dirs = np.einsum("nij,pj->npi", c2w[:, :3, :3], mesh).astype(np.float32)
    ray_origs = np.broadcast_to(
        camera_origins[:, None, :], ray_dirs.shape
    ).astype(np.float32).copy()

    # seeded pose noise (`_apply_noise:513-561`)
    rng = np.random.default_rng(
        None if noise_seed is None else noise_seed + _stable_split_hash(split)
    )
    rot_noise = lie.so3_exp(torch.as_tensor(
        rng.standard_normal((n_images, 3)) * rotation_noise_sigma, dtype=torch.float32
    )).numpy()
    trans_noise = (rng.standard_normal((n_images, 3)) * translation_noise_sigma).astype(np.float32)

    camera_origins_noisy = camera_origins + trans_noise
    ray_origs_noisy = ray_origs + trans_noise[:, None, :]
    camera_directions_noisy = np.einsum("nij,nj->ni", rot_noise, camera_directions)
    ray_dirs_noisy = np.einsum("nij,npj->npi", rot_noise, ray_dirs)

    return ImagePoseData(
        image_height=image_height,
        image_width=image_width,
        focal_length=float(focal),
        pixel_width=float(1.0 / focal),
        gaussian_blur_sigmas=sigmas,
        images=stack,
        camera_to_worlds=c2w.astype(np.float32),
        camera_origins=camera_origins,
        camera_directions=camera_directions,
        ray_origins=ray_origs,
        ray_directions=ray_dirs,
        camera_origins_noisy=camera_origins_noisy,
        camera_directions_noisy=camera_directions_noisy.astype(np.float32),
        ray_origins_noisy=ray_origs_noisy,
        ray_directions_noisy=ray_dirs_noisy.astype(np.float32),
        space_transform_scale=float(space_transform_scale),
        space_transform_translate=space_transform_translate,
        image_name_to_index=name_to_index,
        image_index_to_name=index_to_name,
        index_to_index=index_to_index,
    )


@dataclasses.dataclass
class DataModule:
    """ImagePoseDataModule equivalent (`barf/data_module.py:15-369`):
    train/val/test splits with the train split's auto space-transform
    propagated, image-level validation subsetting with seeded shuffle."""

    scene_path: str
    image_width: int
    image_height: int
    rotation_noise_sigma: float = 0.0
    translation_noise_sigma: float = 0.0
    camera_noise_seed: Optional[int] = None
    gaussian_blur_sigmas: Sequence[float] = (0.0,)
    space_transform_scale: Optional[float] = None
    space_transform_translate: Optional[np.ndarray] = None
    validation_fraction: float = 1.0
    validation_fraction_shuffle: object = "disabled"  # "disabled" | "random" | int

    dataset_train: Optional[ImagePoseData] = None
    dataset_val: Optional[ImagePoseData] = None
    dataset_test: Optional[ImagePoseData] = None

    def _load(self, split: str) -> ImagePoseData:
        return load(
            self.scene_path,
            split,
            self.image_width,
            self.image_height,
            space_transform_scale=self.space_transform_scale,
            space_transform_translate=self.space_transform_translate,
            rotation_noise_sigma=self.rotation_noise_sigma,
            translation_noise_sigma=self.translation_noise_sigma,
            noise_seed=self.camera_noise_seed,
            gaussian_blur_sigmas=self.gaussian_blur_sigmas,
        )

    def setup(self, stage: str = "fit") -> None:
        self.dataset_train = self._load("train")
        self.space_transform_scale = self.dataset_train.space_transform_scale
        self.space_transform_translate = self.dataset_train.space_transform_translate
        if stage == "fit":
            self.dataset_val = self._load("val")
            if self.validation_fraction < 1.0:
                n = max(1, int(self.dataset_val.n_images * self.validation_fraction))
                if self.validation_fraction_shuffle == "disabled":
                    idx = list(range(n))
                else:
                    seed = (
                        self.validation_fraction_shuffle
                        if isinstance(self.validation_fraction_shuffle, int)
                        else None
                    )
                    perm = np.random.default_rng(seed).permutation(self.dataset_val.n_images)
                    idx = perm[:n].tolist()
                self.dataset_val = self.dataset_val.subset(idx)
        elif stage == "test":
            self.dataset_test = self._load("test")

    @property
    def n_training_images(self) -> int:
        if self.dataset_train is not None:
            return self.dataset_train.n_images
        return len(os.listdir(os.path.join(self.scene_path, "train")))
