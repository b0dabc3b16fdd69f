"""SIREN NeRF: omega-scaled sine layers with a residual colour head.

Port of the JAX package's `models/siren.py` (`nerf-siren/nerf_model.py:7-74`,
`nerf-siren/linear_sine.py:8-45`): density trunk 3 -> 256 (omega on the raw
input) -> 256 -> 256 -> 256, the position re-injected (skip), -> 256 -> 256
-> 256 -> (256 + 3 + 1) linear; density = softplus8(z[259] - 1); rgb =
sigmoid(rgb_base + the residual colour head's output).

Every sine layer is sin(linear(x * omega)) with a per-input-feature omega
vector: 1 for hidden features, `input_scale` for raw positions. The omega
vectors are derived from the config and held as non-persistent buffers:
no optimizer sees them and checkpoints do not carry them.

Parameters keep the JAX package's names and (in, out) layout:
`density1[i].{w,b}`, `density2[i].{w,b}`, `density2_out`, `color_sine`,
`color_out`; `from_numpy` / `to_numpy` convert to and from its pytree.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from nerf_experiments_tpu_torch.models.common import Dense, linear_apply, linear_init, softplus8

HIDDEN = 256


@dataclasses.dataclass(frozen=True)
class SirenConfig:
    input_scale: float = 30.0
    compute_dtype: Any = None  # None (fp32) or torch.bfloat16


def _omegas(cfg: SirenConfig) -> Dict[str, List[torch.Tensor]]:
    """Each sine layer's omega vector over its input features
    (`nerf-siren/nerf_model.py:14-53`)."""
    s = cfg.input_scale
    ones_h = torch.ones(HIDDEN)
    skip = torch.cat([ones_h, torch.full((3,), s)])
    return {"density1": [torch.full((3,), s), ones_h, ones_h, ones_h],
            "density2": [skip, ones_h, ones_h],
            "color_sine": [skip]}


class Siren(nn.Module):
    def __init__(self, cfg: SirenConfig, density1, density2, density2_out: Dense,
                 color_sine: Dense, color_out: Dense):
        super().__init__()
        self.density1 = nn.ModuleList(density1)
        self.density2 = nn.ModuleList(density2)
        self.density2_out = density2_out
        self.color_sine = color_sine
        self.color_out = color_out
        device = density2_out.w.device
        for group, vectors in _omegas(cfg).items():
            for i, v in enumerate(vectors):
                self.register_buffer(f"omega_{group}_{i}", v.to(device, copy=True),
                                     persistent=False)

    def omega(self, group: str, i: int = 0) -> torch.Tensor:
        return getattr(self, f"omega_{group}_{i}")


def _sine_layer_init(generator: torch.Generator, in_features: int, out_features: int,
                     omega: torch.Tensor, first_layer: bool, device=None) -> Dense:
    """SIREN init (`linear_sine.py:31-40`): W ~ U(-1, 1)/in for the first
    layer, U(-1, 1) sqrt(6/in)/omega (per input feature) for the others;
    b ~ U(-1/sqrt(in), 1/sqrt(in))."""
    def uniform(shape, bound):
        return torch.rand(shape, generator=generator, device=device) * (2.0 * bound) - bound

    w = uniform((in_features, out_features), 1.0)
    if first_layer:
        w = w / in_features
    else:
        w = w * (math.sqrt(6.0 / in_features) / omega.to(w.device))[:, None]
    return Dense(w, uniform((out_features,), 1.0 / math.sqrt(in_features)))


def init(generator: torch.Generator, cfg: SirenConfig, device=None) -> Siren:
    """Every layer drawn from `generator`, in the JAX package's order."""
    om = _omegas(cfg)
    density1 = [_sine_layer_init(generator, 3 if i == 0 else HIDDEN, HIDDEN,
                                 om["density1"][i], i == 0, device) for i in range(4)]
    density2 = [_sine_layer_init(generator, HIDDEN + 3 if i == 0 else HIDDEN, HIDDEN,
                                 om["density2"][i], False, device) for i in range(3)]
    density2_out = linear_init(generator, HIDDEN, HIDDEN + 3 + 1, device=device)
    color_sine = _sine_layer_init(generator, HIDDEN + 3, HIDDEN, om["color_sine"][0], False,
                                  device)
    color_out = linear_init(generator, HIDDEN, 3, device=device)
    return Siren(cfg, density1, density2, density2_out, color_sine, color_out)


def _sine_apply(layer: Dense, omega: torch.Tensor, x: torch.Tensor, compute_dtype):
    return torch.sin(linear_apply(layer, x * omega, compute_dtype))


def apply(params: Siren, cfg: SirenConfig, pos: torch.Tensor,
          dir: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(density (B,), rgb (B, 3)) in fp32, `nerf_model.py:58-74`."""
    dt = cfg.compute_dtype
    z = pos
    for i, layer in enumerate(params.density1):
        z = _sine_apply(layer, params.omega("density1", i), z, dt)
    z = torch.cat([z, pos.to(z.dtype)], dim=-1)
    for i, layer in enumerate(params.density2):
        z = _sine_apply(layer, params.omega("density2", i), z, dt)
    z = linear_apply(params.density2_out, z, dt)

    density = softplus8(z[:, HIDDEN + 3].float() - 1.0)
    rgb_base = z[:, HIDDEN:HIDDEN + 3]
    h = _sine_apply(params.color_sine, params.omega("color_sine"),
                    torch.cat([z[:, :HIDDEN], dir.to(z.dtype)], dim=-1), dt)
    rgb = torch.sigmoid((rgb_base + linear_apply(params.color_out, h, dt)).float())
    return density, rgb


def _dense_from_numpy(p, device) -> Dense:
    return Dense(torch.tensor(np.asarray(p["w"], np.float32), device=device),
                 torch.tensor(np.asarray(p["b"], np.float32), device=device))


def _dense_to_numpy(layer: Dense) -> Dict:
    return {"w": layer.w.detach().cpu().numpy(), "b": layer.b.detach().cpu().numpy()}


def from_numpy(tree: Dict, cfg: SirenConfig, device=None) -> Siren:
    """The JAX package's pytree -> Siren (the omega buffers from `cfg`)."""
    return Siren(cfg, [_dense_from_numpy(l, device) for l in tree["density1"]],
                 [_dense_from_numpy(l, device) for l in tree["density2"]],
                 *(_dense_from_numpy(tree[k], device)
                   for k in ("density2_out", "color_sine", "color_out")))


def to_numpy(params: Siren) -> Dict:
    return {"density1": [_dense_to_numpy(l) for l in params.density1],
            "density2": [_dense_to_numpy(l) for l in params.density2],
            **{k: _dense_to_numpy(getattr(params, k))
               for k in ("density2_out", "color_sine", "color_out")}}
