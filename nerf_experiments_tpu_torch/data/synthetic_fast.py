"""The procedural scene rendered on the card.

Port of the JAX package's `data/synthetic_fast.py`: the analytic scene and
the emission-absorption integrator of `data/synthetic.py`
(`_scene_density_color`, `render_image`) in torch, batched over a whole view
and stepped over the samples, so one call renders one view on the device
instead of the numpy marcher's per-sample loop over host arrays.

`generate_dataset` is `synthetic.generate_dataset` with this renderer handed
in as its `render_fn`: the poses, the file layout and the transforms JSON are
the numpy path's. It first runs `validate`, the gate against the numpy
oracle, and writes nothing if that fails.

The scene has hard density edges, so the render stays fp32 and the camera
rotation of the ray directions runs without TF32, scoped to the call
(`utils/precision.full_fp32`, as the JAX package scopes
`jax.default_matmul_precision("highest")`): a TF32 direction can put a
boundary ray on the other side of an edge.

    from nerf_experiments_tpu_torch.data import synthetic_fast
    synthetic_fast.generate_dataset(out_dir, image_size=400)  # on the card
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from nerf_experiments_tpu_torch.data import synthetic
from nerf_experiments_tpu_torch.utils.precision import full_fp32

# (centre, radius, rgb) of `synthetic._scene_density_color`'s spheres
_SPHERES = [
    ((0.0, 0.0, 0.2), 0.55, (0.9, 0.2, 0.15)),
    ((0.55, 0.3, -0.1), 0.3, (0.2, 0.75, 0.25)),
    ((-0.5, -0.25, 0.0), 0.35, (0.2, 0.35, 0.9)),
    ((0.1, -0.55, 0.45), 0.22, (0.95, 0.85, 0.2)),
]

# the oracle gate: fp32 sample positions can cross the scene's hard density
# edges otherwise than numpy's float64 ones and flip isolated boundary pixels,
# so the gate is perceptual; a transposed, flipped or mis-axed render agrees
# on fewer than half of the pixels
GATE_FRAC_SAME = 0.98
GATE_MEAN_ERR = 1e-3


@functools.lru_cache(maxsize=4)
def _scene_constants(device: torch.device):
    """The spheres' centres and colours as (4, 3) tensors on `device`, made
    once: a tensor built from host values on each sample would copy to the
    card, and wait for it, every time."""
    return (torch.tensor([c for c, _, _ in _SPHERES], device=device),
            torch.tensor([rgb for _, _, rgb in _SPHERES], device=device))


def scene_density_color(pts: torch.Tensor):
    """(density (...,), rgb (..., 3)) of the analytic scene at points (..., 3),
    `synthetic._scene_density_color` in fp32."""
    centers, rgbs = _scene_constants(pts.device)
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    density = torch.zeros(pts.shape[:-1], dtype=torch.float32, device=pts.device)
    color = torch.zeros(pts.shape[:-1] + (3,), dtype=torch.float32, device=pts.device)
    for i, (_, radius, _) in enumerate(_SPHERES):
        d2 = torch.sum((pts - centers[i]) ** 2, dim=-1)
        sigma = torch.where(d2 < radius ** 2,
                            60.0 * torch.exp(-d2 / (2 * (radius / 2) ** 2)), 0.0)
        take = sigma > density
        density = torch.where(take, sigma, density)
        color = torch.where(take[..., None], rgbs[i], color)
    in_box = (x.abs() < 0.8) & (y.abs() < 0.8) & (z > -0.55) & (z < -0.35)
    checker = (torch.floor(x * 5) + torch.floor(y * 5)) % 2
    box_color = torch.stack([0.6 + 0.3 * checker, 0.5 + 0.2 * checker, 0.4 + 0.1 * checker],
                            dim=-1)
    density = torch.where(in_box, 80.0, density)
    color = torch.where(in_box[..., None], box_color, color)
    return density, color


@torch.no_grad()
def render_view(c2w: torch.Tensor, image_width: int, image_height: int,
                camera_angle_x: float = synthetic.CAMERA_ANGLE_X, n_samples: int = 128,
                near: float = 2.0, far: float = 6.5) -> torch.Tensor:
    """(H, W, 4) fp32 RGBA on c2w's device: every pixel's ray marched over
    `n_samples` equidistant samples in [near, far]."""
    dev = c2w.device
    focal = image_width / 2.0 / math.tan(camera_angle_x / 2.0)
    ys = -(torch.arange(image_height, device=dev) - (image_height - 1) / 2) / focal
    xs = (torch.arange(image_width, device=dev) - (image_width - 1) / 2) / focal
    yy, xx = torch.meshgrid(ys.float(), xs.float(), indexing="ij")
    dirs_cam = torch.stack([xx, yy, -torch.ones_like(xx)], dim=-1)
    dirs_cam = dirs_cam / torch.linalg.norm(dirs_cam, dim=-1, keepdim=True)
    with full_fp32():
        dirs = dirs_cam @ c2w[:3, :3].T
    origin = c2w[:3, 3]
    t = torch.linspace(near, far, n_samples, device=dev)
    dt = t[1] - t[0]
    rgb = torch.zeros((image_height, image_width, 3), device=dev)
    trans = torch.ones((image_height, image_width), device=dev)
    for i in range(n_samples):
        sigma, col = scene_density_color(origin + dirs * t[i])
        alpha = 1.0 - torch.exp(-sigma * dt)
        rgb += (trans * alpha)[..., None] * col
        trans = trans * (1.0 - alpha)
    return torch.cat([rgb, (1.0 - trans)[..., None]], dim=-1)


def render_image(c2w: np.ndarray, image_width: int, image_height: int,
                 camera_angle_x: float = synthetic.CAMERA_ANGLE_X, n_samples: int = 128,
                 near: float = 2.0, far: float = 6.5, device="cuda") -> np.ndarray:
    """`synthetic.render_image`'s signature and result ((H, W, 4) float64 in
    [0, 1]), rendered on `device`."""
    c2w = torch.as_tensor(np.asarray(c2w, np.float32), device=device)
    out = render_view(c2w, image_width, image_height, camera_angle_x, n_samples, near, far)
    return out.cpu().numpy().astype(np.float64)


def validate(size: int = 64, n_samples: int = 64, device="cuda"):
    """The device render against the numpy oracle on one pose: at least
    GATE_FRAC_SAME of the pixels within 1/255 in every channel and a mean
    error below GATE_MEAN_ERR, else AssertionError. Returns (fraction of
    pixels within 1/255, mean error)."""
    c2w = synthetic.look_at_c2w(np.array([2.5, 2.0, 2.2]), np.zeros(3),
                                np.array([0.0, 0.0, 1.0]))
    ref = synthetic.render_image(c2w, size, size, n_samples=n_samples)
    fast = render_image(c2w, size, size, n_samples=n_samples, device=device)
    d = np.abs(ref - fast)
    frac_same = float((d.max(axis=-1) < 1.0 / 255.0).mean())
    mean_err = float(d.mean())
    if not (frac_same >= GATE_FRAC_SAME and mean_err < GATE_MEAN_ERR):
        raise AssertionError(
            f"device scene render disagrees with the numpy oracle: {frac_same:.4f} of the "
            f"pixels within 1/255 (gate >= {GATE_FRAC_SAME}), mean error {mean_err:.2e} "
            f"(gate < {GATE_MEAN_ERR:.0e})")
    return frac_same, mean_err


def generate_dataset(out_dir: str, device="cuda", **kwargs) -> str:
    """`synthetic.generate_dataset(out_dir, **kwargs)` with every view
    rendered on `device`, after `validate` passed there."""
    validate(device=device)
    return synthetic.generate_dataset(
        out_dir, render_fn=functools.partial(render_image, device=device), **kwargs)
