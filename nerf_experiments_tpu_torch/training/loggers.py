"""Observability: metric/image/point-cloud/ray loggers with taper schedules.

Re-designs the reference's wandb Lightning callbacks (SURVEY.md §2.2) as
plain callback objects driven by the trainer loop:
  * `TaperSchedule` — the tanh-tapered logging-delay schedule shared by
    `barf/image_logger.py:99-136` and `barf/point_logger.py` (log often at
    the start, rarely later): delay(step) = tanh(step/k)*(end-start)+start
    with k chosen so delay(taper/2) = (end-start)/2.
  * `ImageReconstructionLogger` — full-image re-render of named train/val
    images through the model (val rays through the Kabsch gauge, train rays
    through the extrinsics), written as PNGs + logged
    (`barf/image_logger.py:26-287`).
  * `CameraPointLogger` — true (blue) vs predicted camera origins colored
    green→red by error with threshold max_dist/10, as a point-cloud .npz +
    wandb Object3D when available (`barf/point_logger.py:17-231`).
  * `RayDensityLogger` — density/color profiles along center rays of named
    images (`garf/ray_logger.py:20-250`), saved as .npz (+ matplotlib PNG
    when available).
  * `EpochFractionLogger` — epoch + batch/num_batches each step
    (`barf/epoch_fraction_logger.py:13-44`).
  * `MetricLogger` — JSONL metric sink (wandb-compatible dict stream); the
    wandb backend attaches if wandb is importable & enabled, else files.

Everything is host-side numpy and pull-based: callbacks receive (step,
epoch fraction, params, context) from the trainer and fetch device tensors
only when they actually fire. A copy of the JAX package's module (it imports
no JAX); the metric file is opened at the first row, so a logger that never
logs leaves no file. On a mesh every rank runs the loggers (their renders are
collective) and only global rank 0's `MetricLogger` is `active`: the others
write nothing.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Callable, Dict, Optional, Sequence

import numpy as np


class TaperSchedule:
    """Tanh-tapered delay between logging events."""

    def __init__(self, logging_start: float, delay_start: float, delay_end: float,
                 delay_taper: float):
        self.logging_start = logging_start
        self.delay_start = delay_start
        self.delay_end = delay_end
        self.delay_taper = delay_taper
        self.next_point = self._delay_at(0.0)

    def _delay_at(self, step: float) -> float:
        delay_factor = -self.delay_taper / 2 / math.log(math.sqrt(3) / 3)
        return (
            math.tanh(step / delay_factor) * (self.delay_end - self.delay_start)
            + self.delay_start
        )

    def should_fire(self, step: float) -> bool:
        """step is in fractional epochs (like the reference)."""
        if step < self.logging_start or step < self.next_point:
            return False
        self.next_point = step + self._delay_at(step)
        return True


class MetricLogger:
    """JSONL metrics file + optional wandb mirror; `active=False` (a rank
    other than 0) writes nothing."""

    def __init__(self, out_dir: str, use_wandb: bool = False, wandb_kwargs: Optional[dict] = None,
                 active: bool = True):
        self.path = os.path.join(out_dir, "metrics.jsonl")
        self.active = active
        self._f = None
        self._wandb = None
        if use_wandb and active:
            try:
                import wandb

                self._wandb = wandb.init(**(wandb_kwargs or {}))
            except Exception:
                self._wandb = None

    def log(self, metrics: Dict, step: int) -> None:
        if not self.active:
            return
        row = {"step": int(step)}
        for k, v in metrics.items():
            try:
                row[k] = float(v)
            except (TypeError, ValueError):
                continue
        if self._f is None:
            os.makedirs(os.path.dirname(self.path), exist_ok=True)
            self._f = open(self.path, "a")
        self._f.write(json.dumps(row) + "\n")
        self._f.flush()
        if self._wandb is not None:
            self._wandb.log(row, step=step)

    def log_image(self, name: str, image: np.ndarray, step: int) -> None:
        """image: (H, W, 3) float in [0,1]; saved as PNG."""
        if not self.active:
            return
        img_dir = os.path.join(os.path.dirname(self.path), "images")
        os.makedirs(img_dir, exist_ok=True)
        arr = (np.clip(image, 0, 1) * 255).astype(np.uint8)
        try:
            from PIL import Image

            Image.fromarray(arr).save(os.path.join(img_dir, f"{name}_{step:08d}.png"))
        except ImportError:
            np.save(os.path.join(img_dir, f"{name}_{step:08d}.npy"), arr)
        if self._wandb is not None:
            import wandb

            self._wandb.log({name: wandb.Image(arr)}, step=step)

    def log_points(self, name: str, points: np.ndarray, colors: np.ndarray, step: int) -> None:
        """points (N,3), colors (N,3) uint8 — saved .npz + wandb Object3D."""
        if not self.active:
            return
        pts_dir = os.path.join(os.path.dirname(self.path), "points")
        os.makedirs(pts_dir, exist_ok=True)
        np.savez(os.path.join(pts_dir, f"{name}_{step:08d}.npz"), points=points, colors=colors)
        if self._wandb is not None:
            import wandb

            cloud = np.concatenate([points, colors.astype(np.float64)], axis=1)
            self._wandb.log({name: wandb.Object3D(cloud)}, step=step)

    def close(self):
        if self._f is not None:
            self._f.close()


@dataclasses.dataclass
class ImageReconstructionLogger:
    """Re-render named images during training (`Log2dImageReconstruction`)."""

    render_fn: Callable  # (params, origs, dirs, pixel_width, train_space: bool, img_idx) -> rgb
    metric_logger: MetricLogger
    train_image_names: Sequence[str] = ()
    validation_image_names: Sequence[str] = ()
    schedule: Optional[TaperSchedule] = None
    chunk: int = 4096
    metric_name_train: str = "train_img"
    metric_name_val: str = "val_img"

    def maybe_log(self, epoch_frac: float, step: int, params, dm) -> bool:
        if self.schedule is not None and not self.should_fire(epoch_frac):
            return False
        for name in self.validation_image_names:
            self._render_split(params, dm.dataset_val, name, step, train_space=False)
        for name in self.train_image_names:
            self._render_split(params, dm.dataset_train, name, step, train_space=True)
        return True

    def should_fire(self, epoch_frac: float) -> bool:
        return self.schedule.should_fire(epoch_frac)

    def _render_split(self, params, dataset, name: str, step: int, train_space: bool):
        if dataset is None or name not in dataset.image_name_to_index:
            return
        idx = dataset.image_name_to_index[name]
        h, w = dataset.image_height, dataset.image_width
        if train_space:
            origs = dataset.ray_origins_noisy[idx]
            dirs = dataset.ray_directions_noisy[idx]
        else:
            origs = dataset.ray_origins[idx]
            dirs = dataset.ray_directions[idx]
        img_idx = dataset.index_to_index.get(idx, idx)
        rgb = np.empty((h * w, 3), np.float32)
        for lo in range(0, h * w, self.chunk):
            hi = min(lo + self.chunk, h * w)
            rgb[lo:hi] = np.asarray(
                self.render_fn(params, origs[lo:hi], dirs[lo:hi],
                               np.full((hi - lo, 1), dataset.pixel_width, np.float32),
                               train_space, img_idx)
            )
        metric = self.metric_name_train if train_space else self.metric_name_val
        self.metric_logger.log_image(f"{metric}_{name}", rgb.reshape(h, w, 3), step)


@dataclasses.dataclass
class CameraPointLogger:
    """True vs predicted camera origins point cloud (`LogCameraExtrinsics`)."""

    predict_origins_fn: Callable  # (params) -> (N, 3) predicted origins
    metric_logger: MetricLogger
    schedule: Optional[TaperSchedule] = None
    metric_name: str = "train_point"

    def maybe_log(self, epoch_frac: float, step: int, params, camera_origins_raw) -> bool:
        if self.schedule is not None and not self.schedule.should_fire(epoch_frac):
            return False
        raw = np.asarray(camera_origins_raw)
        pred = np.asarray(self.predict_origins_fn(params))
        # error -> green..red; threshold = 1/10 of max pairwise raw distance
        max_dist = np.linalg.norm(raw[:, None] - raw[None, :], axis=-1).max()
        err = np.linalg.norm(pred - raw, axis=-1)
        frac = np.clip(err / (max_dist / 10 + 1e-12), 0, 1)
        pred_colors = np.stack(
            [255 * frac, 255 * (1 - frac), np.zeros_like(frac)], axis=1
        ).astype(np.uint8)
        raw_colors = np.tile(np.array([[0, 0, 255]], np.uint8), (raw.shape[0], 1))
        points = np.concatenate([raw, pred], axis=0)
        colors = np.concatenate([raw_colors, pred_colors], axis=0)
        self.metric_logger.log_points(self.metric_name, points, colors, step)
        return True


@dataclasses.dataclass
class RayDensityLogger:
    """Density/color profile along the center ray of named images
    (`garf/ray_logger.py:20-250`)."""

    density_fn: Callable  # (params, positions (S,3), dirs (S,3)) -> dict of (S,) arrays
    metric_logger: MetricLogger
    image_names: Sequence[str] = ()
    n_samples: int = 256
    near: float = 2.0
    far: float = 7.0
    schedule: Optional[TaperSchedule] = None

    def maybe_log(self, epoch_frac: float, step: int, params, dataset) -> bool:
        if self.schedule is not None and not self.schedule.should_fire(epoch_frac):
            return False
        out_dir = os.path.join(os.path.dirname(self.metric_logger.path), "rays")
        if self.metric_logger.active:
            os.makedirs(out_dir, exist_ok=True)
        for name in self.image_names:
            if dataset is None or name not in dataset.image_name_to_index:
                continue
            idx = dataset.image_name_to_index[name]
            hw = dataset.image_height * dataset.image_width
            center = hw // 2 + dataset.image_width // 2
            o = dataset.ray_origins[idx, center]
            d = dataset.ray_directions[idx, center]
            t = np.linspace(self.near, self.far, self.n_samples, dtype=np.float32)
            pos = o[None] + t[:, None] * d[None]
            dirs = np.broadcast_to(d, pos.shape)
            profile = {k: np.asarray(v) for k, v in self.density_fn(params, pos, dirs).items()}
            if not self.metric_logger.active:
                continue
            np.savez(os.path.join(out_dir, f"{name}_{step:08d}.npz"), t=t, **profile)
        return True


class EpochFractionLogger:
    """`LogEpochFraction` parity: epoch + batch_idx/num_batches each log."""

    def __init__(self, metric_logger: MetricLogger, metric_name: str = "epoch_fraction"):
        self.metric_logger = metric_logger
        self.metric_name = metric_name

    def log(self, epoch_frac: float, step: int) -> None:
        self.metric_logger.log({self.metric_name: epoch_frac}, step)
