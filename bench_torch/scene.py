"""The generated scene the BARF cells train on and serve from, cached in the
checkout.

The scene is the program's procedural one (`data/synthetic_fast.py`: spheres
and a slab, rendered on the card) at a configuration's sizes, always from
generator seed 0, so every run of every cell reads the same files. A split is
written the first time a cell needs it, into `bench_torch/.cache/scene_<image
size>_<train>_<val>_<test>/`, and read by every later run. A split whose
images no cell reads (the test split of the serving cells, which need only
its poses) is written as its poses alone. The poses of every split are the
generator's whatever is rendered, since they are drawn before each view.
"""
from __future__ import annotations

import json
import math
import os
import shutil
import tempfile
from typing import Iterable

import numpy as np

CACHE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".cache")
GENERATOR_SEED = 0  # one scene for every run of every cell
SPLITS = ("train", "val", "test")


def scene_dir(scene: dict) -> str:
    return os.path.join(CACHE_DIR, "scene_{image_size}_{train_views}_{val_views}_{test_views}"
                        .format(**scene))


def _has(root: str, split: str, images: bool) -> bool:
    if not os.path.exists(os.path.join(root, f"transforms_{split}.json")):
        return False
    return not images or os.path.isdir(os.path.join(root, split))


def ensure(scene: dict, images: Iterable[str], poses: Iterable[str] = (), device="cuda") -> str:
    """The scene's directory, holding the rendered views of the splits in
    `images` and the poses of those in `poses`; whatever is missing is
    generated first (the device render after its gate against the numpy
    oracle, `synthetic_fast.validate`)."""
    from nerf_experiments_tpu_torch.data import synthetic, synthetic_fast

    root = scene_dir(scene)
    images, poses = set(images), set(poses) - set(images)
    missing_img = {s for s in images if not _has(root, s, True)}
    missing_pose = {s for s in poses if not _has(root, s, False)}
    if not missing_img and not missing_pose:
        return root
    counts = [scene["train_views"], scene["val_views"], scene["test_views"]]
    owner = [s for s, n in zip(SPLITS, counts) for _ in range(n)]
    if missing_img:
        synthetic_fast.validate(device=device)
    calls = iter(owner)

    def render(c2w, width, height, n_samples):
        if next(calls) in missing_img:
            return synthetic_fast.render_image(c2w, width, height, n_samples=n_samples,
                                               device=device)
        return np.zeros((1, 1, 4))  # a view no cell reads: its pose is all that is kept

    os.makedirs(CACHE_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="scene_", dir=CACHE_DIR)
    try:
        synthetic.generate_dataset(
            tmp, n_train=counts[0], n_val=counts[1], n_test=counts[2],
            image_size=scene["image_size"], seed=GENERATOR_SEED,
            n_samples=scene["render_samples"], render_fn=render)
        os.makedirs(root, exist_ok=True)
        for split in sorted(missing_img | missing_pose):
            if split in missing_img:
                dst = os.path.join(root, split)
                shutil.rmtree(dst, ignore_errors=True)
                os.rename(os.path.join(tmp, split), dst)
            # the poses last: their file marks the split as complete
            os.replace(os.path.join(tmp, f"transforms_{split}.json"),
                       os.path.join(root, f"transforms_{split}.json"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return root


def view_rays(root: str, split: str, image_size: int):
    """(origins, directions) (n_views, H W, 3) float32 and the pixel width of
    a split's views, row-major pixels, in the frame of the poses (the BARF
    entry's space transform is the identity: scale 1, no translation)."""
    with open(os.path.join(root, f"transforms_{split}.json")) as f:
        meta = json.load(f)
    focal = image_size / 2.0 / math.tan(meta["camera_angle_x"] / 2.0)
    c = (np.arange(image_size) - (image_size - 1) / 2) / focal
    yy, xx = np.meshgrid(-c, c, indexing="ij")
    mesh = np.stack([xx, yy, -np.ones_like(xx)], axis=-1).reshape(-1, 3)
    mesh /= np.linalg.norm(mesh, axis=-1, keepdims=True)
    c2w = np.stack([np.asarray(fr["transform_matrix"], np.float64) for fr in meta["frames"]])
    dirs = np.empty((len(c2w), mesh.shape[0], 3), np.float32)
    for i, m in enumerate(c2w):
        dirs[i] = mesh @ m[:3, :3].T
    origs = np.broadcast_to(c2w[:, None, :3, 3], dirs.shape).astype(np.float32)
    return origs, dirs, 1.0 / focal
