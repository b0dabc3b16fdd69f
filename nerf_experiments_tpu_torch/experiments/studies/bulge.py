"""Projection-matrix "bulge" study.

The port's own copy of the JAX package's `experiments/studies/bulge.py`
(numpy only). Parity with `bulge-test/main.py:1-70`: compares a perspective projection
matrix against true pinhole geometry, quantifying how planes of constant z
bow ("bulge") under the matrix's post-projective interpolation vs the exact
per-point projection. Pure numpy; returns the max deviation so tests can
assert the known geometry facts.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def perspective_matrix(n: float = 2.0, f: float = 3.0, r: float = 1.0, t: float = 1.0):
    return np.array(
        [
            [n / r, 0, 0, 0],
            [0, n / t, 0, 0],
            [0, 0, (f + n) / (f - n), 2 * f * n / (f - n)],
            [0, 0, -1, 0],
        ]
    )


def to_homo(ps: np.ndarray) -> np.ndarray:
    return np.vstack((ps, np.ones(ps.shape[1])))


def to_inho(qs: np.ndarray) -> np.ndarray:
    return (qs / qs[-1, :])[:-1]


def bulge_study(n_points: int = 100) -> Dict:
    """Project the boundary of a slab [-0.5,0.5]x{0}x[-2,-1] and measure how
    straight lines map. Constant-z lines stay straight (projective maps of
    planes z=c are affine in x), while the z-interpolation is non-linear —
    the 'bulge' the reference visualizes."""
    M = perspective_matrix()
    zs = np.linspace(-2, -1, n_points)
    xs = np.linspace(-0.5, 0.5, n_points)

    # line of constant z: projected x must remain affine in x (no bulge)
    line_const_z = np.array([[x, 0.0, zs[0]] for x in xs]).T
    proj = to_inho(M @ to_homo(line_const_z))
    x_proj = proj[0]
    affine_fit = np.polyfit(xs, x_proj, 1)
    x_lin_residual = np.abs(np.polyval(affine_fit, xs) - x_proj).max()

    # line of constant x: projected depth is NON-linear in z (the bulge)
    line_const_x = np.array([[xs[0], 0.0, z] for z in zs]).T
    projz = to_inho(M @ to_homo(line_const_x))
    z_proj = projz[2]
    zfit = np.polyfit(zs, z_proj, 1)
    z_lin_residual = np.abs(np.polyval(zfit, zs) - z_proj).max()

    return {
        "const_z_line_linear_residual": float(x_lin_residual),
        "const_x_depth_nonlinearity": float(z_lin_residual),
    }


if __name__ == "__main__":
    import json

    print(json.dumps(bulge_study(), indent=2))
