"""Rotation-convention sanity check (lie-algebra-check analogue).

Port of the JAX package's `experiments/studies/rotation_check.py` on the
port's `ops/lie.py`. The reference ships a WebGL teapot page
(`lie-algebra-check/`) to verify rotation-matrix handedness by eye; here the
same conventions are checked numerically, and optionally drawn as PNG frames
of a rotating cube: right-handed axes, a positive angle turns
counter-clockwise about its axis (looking down it), exp(hat(z theta)) turns
x toward y, and a camera's c2w maps its -z onto the viewing direction.

    python -m nerf_experiments_tpu_torch.experiments.studies.rotation_check
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from nerf_experiments_tpu_torch.data.synthetic import look_at_c2w
from nerf_experiments_tpu_torch.ops.lie import so3_exp


def _rot(w) -> np.ndarray:
    return so3_exp(torch.tensor(w, dtype=torch.float32)).numpy()


def convention_checks() -> Dict[str, bool]:
    checks = {}
    # +90 degrees about z takes the x axis to the y axis (right-handed, CCW)
    R = _rot([0.0, 0.0, np.pi / 2])
    checks["z_rotation_x_to_y"] = bool(np.allclose(R @ [1, 0, 0], [0, 1, 0], atol=1e-5))
    # +90 degrees about x takes the y axis to the z axis
    R = _rot([np.pi / 2, 0.0, 0.0])
    checks["x_rotation_y_to_z"] = bool(np.allclose(R @ [0, 1, 0], [0, 0, 1], atol=1e-5))
    # exp(a) exp(b) != exp(a + b) for rotations that do not commute
    lhs = _rot([0.7, 0.0, 0.0]) @ _rot([0.0, 0.7, 0.0])
    rhs = _rot([0.7, 0.7, 0.0])
    checks["non_commutative"] = bool(np.abs(lhs - rhs).max() > 1e-3)
    # camera convention: the c2w rotation maps camera -z to the viewing direction
    c2w = look_at_c2w(np.array([4.0, 0.0, 0.0]), np.zeros(3), np.array([0.0, 0.0, 1.0]))
    view = c2w[:3, :3] @ np.array([0.0, 0.0, -1.0])
    checks["camera_looks_at_target"] = bool(np.allclose(view, [-1, 0, 0], atol=1e-6))
    checks["c2w_orthogonal"] = bool(np.allclose(c2w[:3, :3] @ c2w[:3, :3].T, np.eye(3),
                                                atol=1e-6))
    return checks


def render_teapot_frames(n_frames: int = 8, out_dir: Optional[str] = None) -> List[np.ndarray]:
    """The corners of a unit cube turned about z over `n_frames` frames;
    with `out_dir`, also one matplotlib PNG a frame (when matplotlib is
    installed)."""
    corners = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)],
                       dtype=float)
    frames = [corners @ _rot([0.0, 0.0, 2 * np.pi * i / n_frames]).T.astype(float)
              for i in range(n_frames)]
    if out_dir is not None:
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return frames
        os.makedirs(out_dir, exist_ok=True)
        for i, pts in enumerate(frames):
            fig = plt.figure()
            ax = fig.add_subplot(projection="3d")
            ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2])
            fig.savefig(os.path.join(out_dir, f"frame_{i}.png"))
            plt.close(fig)
    return frames


if __name__ == "__main__":
    import json

    print(json.dumps(convention_checks(), indent=2))
