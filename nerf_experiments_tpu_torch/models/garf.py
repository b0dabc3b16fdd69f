"""GARF-family networks: Gaussian/Gabor/SARF-activated radiance and proposal
MLPs.

Port of `nerf_experiments_tpu/models/garf.py`. Architecture from
`barf/model_garf_radiance.py:10-113` (RadianceNetwork: 3->1024->256->128->128,
the position re-injected, ->512->256->128->129; density = softplus(z2[:, 128]
- 1); colour head on z1[:, :128] + z2[:, :128] with the direction, ->256->3,
sigmoid) and `barf/model_garf_proposal.py:10-77` (ProposalNetwork:
3->512->256->128->1, softplus).

Parameters keep the JAX tree's names and (in, out) weight layout:
`density1.linear.0.w`, `density1.act.0.isd`, ..., `net.linear.3.b`;
`from_numpy` / `to_numpy` convert to and from the JAX pytree. Linear and
activation parameters are labelled apart (`param_labels`) so they get their
own learning rates (gaussian_learning_rate_factor).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from nerf_experiments_tpu_torch.encodings.activations import (
    gabor_from_isd,
    gauss_from_isd,
    sarf_act,
)
from nerf_experiments_tpu_torch.models.common import (
    Dense,
    ParamGroup,
    linear_apply,
    linear_init,
    softplus8,
)

RADIANCE_D1_DIMS = [(3, 1024), (1024, 256), (256, 128), (128, 128)]
RADIANCE_D2_DIMS = [(128 + 3, 512), (512, 256), (256, 128), (128, 128 + 1)]
RADIANCE_COLOR_DIMS = [(128 + 3, 256), (256, 3)]
PROPOSAL_DIMS = [(3, 512), (512, 256), (256, 128), (128, 1)]
# name of each family's activation parameters, in the JAX tree's order
ACT_PARAMS = {"gauss": ("isd",), "gabor": ("isd", "spread"), "sarf": ("freq",)}


@dataclasses.dataclass(frozen=True)
class GarfConfig:
    activation: str = "gauss"  # gauss | gabor | sarf
    init_min: float = 0.0
    init_max: float = 1.0
    learning_rate_start: float = 1e-4
    learning_rate_stop: float = 1e-5
    learning_rate_decay_end: int = 10000
    activation_learning_rate_factor: float = 1.0
    weight_decay: float = 0.0
    compute_dtype: Any = None  # None (fp32) or torch.bfloat16

    @property
    def linear_group(self) -> ParamGroup:
        return ParamGroup(self.learning_rate_start, self.learning_rate_stop,
                          self.learning_rate_decay_end, self.weight_decay)

    @property
    def activation_group(self) -> ParamGroup:
        f = self.activation_learning_rate_factor
        return ParamGroup(self.learning_rate_start * f, self.learning_rate_stop * f,
                          self.learning_rate_decay_end, self.weight_decay)


class Act(nn.Module):
    """One layer's per-feature activation parameters (`isd`, `spread`,
    `freq`), each (features,)."""

    def __init__(self, **params: torch.Tensor):
        super().__init__()
        for name, value in params.items():
            setattr(self, name, nn.Parameter(value))


class Stack(nn.Module):
    """Alternating linear / activation layers: `linear[i]`, `act[i]`."""

    def __init__(self, linear: List[Dense], act: List[Act]):
        super().__init__()
        self.linear = nn.ModuleList(linear)
        self.act = nn.ModuleList(act)


class Radiance(nn.Module):
    def __init__(self, cfg: GarfConfig, density1: Stack, density2: Stack, color: Stack):
        super().__init__()
        self.cfg = cfg
        self.density1, self.density2, self.color = density1, density2, color


class Proposal(nn.Module):
    def __init__(self, cfg: GarfConfig, net: Stack):
        super().__init__()
        self.cfg = cfg
        self.net = net


def _act_init(generator: torch.Generator, cfg: GarfConfig, features: int,
              device=None) -> Act:
    """Gauss/Gabor: inv_standard_deviation ~ U(init_min, init_max) (+ spread ~
    U(0, 2 pi) for Gabor); SARF: frequency ~ U(init_min, init_max)."""
    if cfg.activation not in ACT_PARAMS:
        raise ValueError(f"unknown activation {cfg.activation!r}")

    def uniform():
        return torch.rand((features,), generator=generator, device=device)

    params = {ACT_PARAMS[cfg.activation][0]:
              uniform() * (cfg.init_max - cfg.init_min) + cfg.init_min}
    if cfg.activation == "gabor":
        params["spread"] = uniform() * 2.0 * math.pi
    return Act(**params)


def _act_apply(cfg: GarfConfig, act: Act, x: torch.Tensor, anneal=1.0) -> torch.Tensor:
    """anneal scales the oscillatory term of gabor/sarf (gauss ignores it)."""
    if cfg.activation == "gauss":
        return gauss_from_isd(x, act.isd)
    if cfg.activation == "gabor":
        return gabor_from_isd(x, act.isd, act.spread, anneal)
    if cfg.activation == "sarf":
        return sarf_act(x, act.freq, anneal)
    raise ValueError(cfg.activation)


def _init_stack(generator, cfg: GarfConfig, dims, act_after_last: bool, device=None) -> Stack:
    linear, act = [], []
    for i, (d_in, d_out) in enumerate(dims):
        linear.append(linear_init(generator, d_in, d_out, device=device))
        if act_after_last or i < len(dims) - 1:
            act.append(_act_init(generator, cfg, d_out, device=device))
    return Stack(linear, act)


def _apply_stack(cfg: GarfConfig, stack: Stack, x: torch.Tensor, anneal=1.0) -> torch.Tensor:
    h = x
    for i, lin in enumerate(stack.linear):
        h = linear_apply(lin, h, cfg.compute_dtype)
        if i < len(stack.act):
            h = _act_apply(cfg, stack.act[i], h, anneal)
    return h


# --------------------------------------------------------------- Radiance
def radiance_init(generator: torch.Generator, cfg: GarfConfig, device=None) -> Radiance:
    return Radiance(
        cfg,
        _init_stack(generator, cfg, RADIANCE_D1_DIMS, act_after_last=True, device=device),
        _init_stack(generator, cfg, RADIANCE_D2_DIMS, act_after_last=False, device=device),
        _init_stack(generator, cfg, RADIANCE_COLOR_DIMS, act_after_last=False, device=device),
    )


def radiance_apply(params: Radiance, cfg: GarfConfig, pos: torch.Tensor, dir: torch.Tensor,
                   act_anneal=1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rgb, density): argument and return order of RadianceNetwork.forward."""
    z1 = _apply_stack(cfg, params.density1, pos, act_anneal)
    z2 = _apply_stack(cfg, params.density2, torch.cat([z1, pos.to(z1.dtype)], dim=-1),
                      act_anneal)
    density = softplus8(z2[:, 128].float() - 1.0)
    color_in = torch.cat([z1[:, :128] + z2[:, :128], dir.to(z1.dtype)], dim=-1)
    rgb = torch.sigmoid(_apply_stack(cfg, params.color, color_in, act_anneal).float())
    return rgb, density


# --------------------------------------------------------------- Proposal
def proposal_init(generator: torch.Generator, cfg: GarfConfig, device=None) -> Proposal:
    return Proposal(cfg, _init_stack(generator, cfg, PROPOSAL_DIMS, act_after_last=False,
                                     device=device))


def proposal_apply(params: Proposal, cfg: GarfConfig, pos: torch.Tensor,
                   act_anneal=1.0) -> torch.Tensor:
    """Density-only network; softplus(threshold=8) output, squeezed to (B,)."""
    out = _apply_stack(cfg, params.net, pos, act_anneal)
    return softplus8(out[..., 0].float())


def param_labels(params: nn.Module, linear_label: str, act_label: str) -> Dict[str, str]:
    """Parameter name -> optimizer group label: linear weights and biases vs
    activation bandwidth parameters (`model_garf_radiance.py:63-77`)."""
    return {name: (act_label if ".act." in name else linear_label)
            for name, _ in params.named_parameters()}


# --------------------------------------------------------------- converters
def _stack_from_numpy(tree: Dict, device=None) -> Stack:
    def t(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)

    return Stack([Dense(t(l["w"]), t(l["b"])) for l in tree["linear"]],
                 [Act(**{k: t(v) for k, v in a.items()}) for a in tree["act"]])


def _stack_to_numpy(stack: Stack) -> Dict:
    def n(p):
        return p.detach().cpu().numpy()

    return {"linear": [{"w": n(l.w), "b": n(l.b)} for l in stack.linear],
            "act": [{k: n(v) for k, v in a.named_parameters()} for a in stack.act]}


def from_numpy(tree: Dict, cfg: GarfConfig, device=None) -> nn.Module:
    """The JAX package's radiance tree {"density1", "density2", "color"} or
    proposal tree {"net"} (numpy or array-like leaves) -> Radiance / Proposal.
    Layouts are identical, so this is a copy."""
    if "net" in tree:
        return Proposal(cfg, _stack_from_numpy(tree["net"], device))
    return Radiance(cfg, *(_stack_from_numpy(tree[k], device)
                           for k in ("density1", "density2", "color")))


def to_numpy(module: nn.Module) -> Dict:
    """Radiance / Proposal -> the JAX package's tree of numpy arrays."""
    if isinstance(module, Proposal):
        return {"net": _stack_to_numpy(module.net)}
    return {k: _stack_to_numpy(getattr(module, k)) for k in ("density1", "density2", "color")}
