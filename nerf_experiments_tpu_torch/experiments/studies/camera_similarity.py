"""Camera-similarity studies: alignment by gradient descent against the closed
form, and the Gauss activation's bandwidth response to scale.

Port of the JAX package's `experiments/studies/camera_similarity.py`, with
`torch.optim.SGD` / `Adam` in place of optax. Parity with
`test-camera-similarity/`:
  * `optimize.py:6-98` `iterative_optimize`: fit a linear map A by SGD to
    align paired point clouds (optionally with an orthogonality penalty),
    recording the loss and rotation-penalty curves;
  * `optimize.py:100-143` `align_rotation` / `align_paired_point_clouds`:
    the closed-form Kabsch answer to the same problem (`ops/kabsch.py`, the
    main pipeline's);
  * `main.py:36-81` + `model.py:52-79`: a Gaussian-activation MLP fitting a
    family of scale-conditioned 1-D functions, probing how the learnable
    bandwidth responds to the target's frequency.

The starting points come from a seeded `torch.Generator`, or from `init=`
(a numpy array or pytree), so a run can start where another package's did.

    python -m nerf_experiments_tpu_torch.experiments.studies.camera_similarity
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from nerf_experiments_tpu_torch.encodings.activations import gauss_from_isd
from nerf_experiments_tpu_torch.models.common import Dense, linear_apply, linear_init
from nerf_experiments_tpu_torch.ops.kabsch import apply_similarity, kabsch


def iterative_align(x: torch.Tensor, target: torch.Tensor, reg: float = 0.0,
                    lr: float = 1e-3, max_iter: int = 1000, seed: int = 1,
                    init: Optional[np.ndarray] = None) -> Dict:
    """SGD fit of a linear map A minimising mean ||x A - target||^2 (+ reg
    ||A^T A - I||^2), from `init` or A ~ N(0, 1) drawn with `seed`. Returns
    the final A and each step's loss and rotation penalty (before its
    update)."""
    shape = (x.shape[1], target.shape[1])
    if init is None:
        A = torch.randn(shape, generator=torch.Generator().manual_seed(seed)).to(x.device)
    else:
        A = torch.tensor(np.asarray(init, np.float32), device=x.device)
    A = A.clone().requires_grad_(True)
    opt = torch.optim.SGD([A], lr=lr)
    eye = torch.eye(shape[1], device=x.device)
    losses, rot_pens = [], []
    for _ in range(max_iter):
        opt.zero_grad()
        rot_pen = torch.sum((A.T @ A - eye) ** 2)
        loss = torch.mean((target - x @ A) ** 2) + reg * rot_pen
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        rot_pens.append(float(rot_pen.detach()))
    return {"A": A.detach().cpu().numpy(), "loss": losses, "rot_penalty": rot_pens}


def closed_form_align(pts_from: torch.Tensor, pts_to: torch.Tensor) -> Dict:
    """Closed-form Kabsch alignment (align_paired_point_clouds parity)."""
    R, t, c = kabsch(pts_from, pts_to, remove_outliers=False)
    residual = float(torch.mean(torch.linalg.norm(
        apply_similarity(R, t, c, pts_from) - pts_to, dim=1)))
    return {"R": R.cpu().numpy(), "t": t.cpu().numpy(), "c": float(c), "residual": residual}


@dataclasses.dataclass(frozen=True)
class GaussMLPConfig:
    hidden_dim: int = 64
    n_layers: int = 3
    init_min: float = 0.0
    init_max: float = 1.0


class GaussMLP(nn.Module):
    def __init__(self, layers, isd):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.isd = nn.ParameterList(isd)


def gauss_mlp_init(generator: torch.Generator, cfg: GaussMLPConfig, in_dim: int = 2,
                   device=None) -> GaussMLP:
    """Linear layers with nn.Linear's bounds and, after each hidden layer, a
    learnable inverse standard deviation U(init_min, init_max) per unit."""
    dims = [in_dim] + [cfg.hidden_dim] * (cfg.n_layers - 1) + [1]
    layers = [linear_init(generator, i, o, device=device) for i, o in zip(dims[:-1], dims[1:])]
    isd = [torch.rand((d,), generator=generator, device=device) * (cfg.init_max - cfg.init_min)
           + cfg.init_min for d in dims[1:-1]]
    return GaussMLP(layers, isd)


def gauss_mlp_from_numpy(tree: Dict, device=None) -> GaussMLP:
    """{"layers": [{"w", "b"}, ...], "isd": [...]} (the JAX package's pytree)."""
    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    return GaussMLP([Dense(t(l["w"]), t(l["b"])) for l in tree["layers"]],
                    [t(a) for a in tree["isd"]])


def gauss_mlp_apply(params: GaussMLP, x: torch.Tensor) -> torch.Tensor:
    h = x
    for i, layer in enumerate(params.layers):
        h = linear_apply(layer, h)
        if i < len(params.layers) - 1:
            h = gauss_from_isd(h, params.isd[i])
    return h[..., 0]


def scale_response_study(scales=(0.5, 1.0, 2.0, 4.0), n_points: int = 256, steps: int = 800,
                         seed: int = 0, init: Optional[Dict] = None, device=None) -> Dict:
    """Fit f_s(x) = sin(2 pi s x) on [-1, 1] for each scale s with a
    scale-conditioned Gauss-activation MLP (Adam 3e-3), each from the same
    start (`init`, or drawn with `seed`); report the last step's loss and the
    learned mean |isd| per scale (the reference's probe of the bandwidth's
    response to frequency)."""
    x = torch.linspace(-1, 1, n_points, device=device)[:, None]
    results = {}
    for s in scales:
        target = torch.sin(s * 2 * math.pi * x[:, 0])
        inp = torch.cat([x, torch.full_like(x, s)], dim=1)
        params = (gauss_mlp_from_numpy(init, device) if init is not None else gauss_mlp_init(
            torch.Generator().manual_seed(seed), GaussMLPConfig(init_min=0.5, init_max=2.0),
            device=device))
        opt = torch.optim.Adam(params.parameters(), lr=3e-3, betas=(0.9, 0.999), eps=1e-8)
        for _ in range(steps):
            opt.zero_grad()
            loss = torch.mean((gauss_mlp_apply(params, inp) - target) ** 2)
            loss.backward()
            opt.step()
        isd_mean = float(np.mean([a.detach().abs().mean().item() for a in params.isd]))
        results[s] = {"final_loss": float(loss.detach()), "mean_abs_isd": isd_mean}
    return results


if __name__ == "__main__":
    import json

    from nerf_experiments_tpu_torch.ops.lie import so3_exp

    pts = torch.randn((50, 3), generator=torch.Generator().manual_seed(0))
    R_true = so3_exp(torch.tensor([0.4, -0.2, 0.9]))
    target = apply_similarity(R_true, torch.tensor([[1.0, 2.0, -0.5]]), 1.3, pts)
    cf = closed_form_align(pts, target)
    it = iterative_align(pts, target - torch.mean(target, 0), max_iter=400)
    print(json.dumps({
        "closed_form_residual": cf["residual"],
        "iterative_final_loss": it["loss"][-1],
        "scale_response": scale_response_study(scales=(1.0, 2.0), steps=300),
    }, indent=2))
