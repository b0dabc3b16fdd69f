"""Ray generation and camera-space transforms.

Conventions (semantically) of `barf/dataset.py`:
  * focal length from the horizontal camera angle:
    f = W / 2 / tan(camera_angle_x / 2)          (`_load_camera_info:303`)
  * camera looks down -z, y flipped, pixel grid centred:
    direction(i_row, j_col) ∝ (x, y, -1) normalized   (`_get_directions_meshgrid:406-451`)
  * rays in world space: rotate directions by c2w[:3,:3], origin = c2w[:3,3]
  * space transform: origins' translation removed then everything scaled;
    default scale = 3 * max pairwise camera distance, default translate =
    mean camera position (`_transform_camera_to_world:315-381`)
  * pose noise: per-camera translation noise added to origins, rotation
    noise applied to directions (`_apply_noise:513-561`)
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from nerf_experiments_tpu_torch.ops.lie import so3_exp


def focal_length(image_width: int, camera_angle_x: float) -> float:
    return image_width / 2.0 / math.tan(camera_angle_x / 2.0)


def directions_meshgrid(
    image_height: int, image_width: int, focal: float,
    dtype=torch.float32, device=None,
) -> torch.Tensor:
    """Unit direction vectors in camera space, flattened row-major (H*W, 3):
    pixel (i, j) maps to row i*W + j."""
    ys = -torch.linspace(-(image_height - 1) / 2, (image_height - 1) / 2,
                         image_height, device=device) / focal
    xs = torch.linspace(-(image_width - 1) / 2, (image_width - 1) / 2,
                        image_width, device=device) / focal
    y, x = torch.meshgrid(ys.to(dtype), xs.to(dtype), indexing="ij")
    d = torch.stack([x, y, -torch.ones_like(x)], dim=-1)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    return d.reshape(-1, 3)


def space_transform_params(
    camera_positions: torch.Tensor,
    scale: Optional[float] = None,
    translate: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """translate = mean camera position, scale = 3 * max pairwise camera
    distance (`_transform_camera_to_world:352-358`)."""
    if scale is None:
        diff = camera_positions[:, None, :] - camera_positions[None, :, :]
        scale = 3.0 * torch.max(torch.linalg.norm(diff, dim=-1))
    if translate is None:
        translate = torch.mean(camera_positions, dim=0)
    return torch.as_tensor(scale), torch.as_tensor(translate)


def transform_c2w(
    c2w: torch.Tensor, scale: torch.Tensor, translate: torch.Tensor
) -> torch.Tensor:
    """Apply the space transform to (N, 4, 4) camera-to-world matrices (the
    translation column only; the rotation block is unchanged)."""
    out = c2w.clone()
    out[:, :3, 3] = (c2w[:, :3, 3] - translate) / scale
    return out


def rays_from_c2w(
    meshgrid: torch.Tensor, c2w: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """World-space rays for every camera: meshgrid (H*W, 3), c2w (N, 4, 4)
    -> origins (N, H*W, 3), directions (N, H*W, 3)."""
    origins = c2w[:, None, :3, 3].expand(c2w.shape[0], meshgrid.shape[0], 3)
    dirs = torch.einsum("nij,pj->npi", c2w[:, :3, :3], meshgrid)
    return origins, dirs


def camera_origins_and_directions(c2w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-camera origin and central viewing direction
    (`_get_cam_origs_and_directions:384-404`)."""
    forward = torch.tensor([0.0, 0.0, -1.0], dtype=c2w.dtype, device=c2w.device)
    return c2w[:, :3, 3], torch.einsum("nij,j->ni", c2w[:, :3, :3], forward)


def apply_pose_noise(
    generator: torch.Generator,
    camera_origins: torch.Tensor,
    camera_directions: torch.Tensor,
    ray_origins: torch.Tensor,
    ray_directions: torch.Tensor,
    rotation_noise_sigma: float,
    translation_noise_sigma: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-camera pose noise (`_apply_noise:513-561`): translation noise is
    added to origins; a random so3 rotation (sigma in radians) rotates the
    direction vectors about the world origin."""
    n = camera_origins.shape[0]
    kw = dict(generator=generator, dtype=camera_origins.dtype,
              device=camera_origins.device)
    R_noise = so3_exp(torch.randn((n, 3), **kw) * rotation_noise_sigma)
    t_noise = torch.randn((n, 3), **kw) * translation_noise_sigma
    return (
        camera_origins + t_noise,
        torch.einsum("nij,nj->ni", R_noise, camera_directions),
        ray_origins + t_noise[:, None, :],
        torch.einsum("nij,npj->npi", R_noise, ray_directions),
    )
