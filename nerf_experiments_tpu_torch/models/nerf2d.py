"""2-D image-fitting MLP (the minimal end-to-end slice).

Port of the JAX package's `models/nerf2d.py` (`2d-reconstruction/model.py:6-102`,
`Nerf2d`): Fourier features (scale pi, 2 dimensions) over the pixel
coordinates -> 3 x (Linear 256 + tanh) -> Linear 3 + sigmoid. Parameters keep
the JAX package's names and (in, out) layout (`layers[i].{w,b}`);
`from_numpy` / `to_numpy` convert to and from its pytree.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from nerf_experiments_tpu_torch.encodings.fourier import Fourier
from nerf_experiments_tpu_torch.models.common import Dense, linear_apply, linear_init


@dataclasses.dataclass(frozen=True)
class Nerf2dConfig:
    fourier_levels: int = 10
    hidden_dim: int = 256
    learning_rate: float = 1e-3
    compute_dtype: Any = None  # None (fp32) or torch.bfloat16

    @property
    def encoder(self) -> Fourier:
        # the reference's scale is pi (2^j pi), over 2 space dimensions
        return Fourier(levels=self.fourier_levels, scale=math.pi, space_dimensions=2)


class Nerf2d(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


def init(generator: torch.Generator, cfg: Nerf2dConfig, device=None) -> Nerf2d:
    """Four layers with nn.Linear's bounds, drawn from `generator`."""
    dims = [cfg.encoder.output_dim] + [cfg.hidden_dim] * 3 + [3]
    return Nerf2d([linear_init(generator, i, o, device=device)
                   for i, o in zip(dims[:-1], dims[1:])])


def apply(params: Nerf2d, cfg: Nerf2dConfig, x: torch.Tensor) -> torch.Tensor:
    """x (B, 2) pixel coordinates in [0, 1) -> rgb (B, 3)."""
    h = cfg.encoder(x)
    for layer in params.layers[:-1]:
        h = torch.tanh(linear_apply(layer, h, cfg.compute_dtype))
    return torch.sigmoid(linear_apply(params.layers[-1], h, cfg.compute_dtype))


def from_numpy(tree: Dict, device=None) -> Nerf2d:
    """The JAX package's {"layers": [{"w", "b"}, ...]} -> Nerf2d."""
    return Nerf2d([Dense(torch.tensor(np.asarray(l["w"], np.float32), device=device),
                         torch.tensor(np.asarray(l["b"], np.float32), device=device))
                   for l in tree["layers"]])


def to_numpy(params: Nerf2d) -> Dict:
    return {"layers": [{"w": l.w.detach().cpu().numpy(), "b": l.b.detach().cpu().numpy()}
                       for l in params.layers]}
