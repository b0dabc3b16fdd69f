"""Multi-group Adam with per-group LR schedules, on `torch.optim.AdamW`.

Port of the JAX package's `training/optim.py` (optax): one Adam param group
per label, each with its own schedule, eps and freeze window. It reproduces
the reference's single Adam(eps=1e-5) over NerfBaseModel param groups with
SchedulerLeNice (`barf/model_interpolation.py:543-584`), and garf's
one-Adam-per-subnet style (Adam state is per parameter, so one Adam over
disjoint groups is the same update).

What matches optax, step for step:
  * the LR of a step is the schedule at the count of updates taken BEFORE it
    (`optax.scale_by_schedule` reads its count before the increment): the
    first `step()` uses schedule(0);
  * Adam's eps is added after the bias-corrected square root, in torch as in
    optax; a frozen group, or the camera with `optimize_camera=False`, has
    lr 0: its moments still move, its parameters do not;
  * a freeze window zeroes the group's gradients before the moments see them
    (`_zero_grads_in_window`);
  * `guard_nonfinite` zeroes every gradient when any is non-finite, and the
    Adam update still runs: the moments decay and the parameters move by
    momentum, exactly as optax does on a zeroed gradient tree. Gradients are
    set as zero tensors, never None, which torch would skip;
  * a group's weight decay is optax's `add_decayed_weights` after
    `scale_by_adam`: p <- p - lr (adam_update + wd p), which is AdamW's
    decoupled decay with the group's own `weight_decay` (0 elsewhere). It
    applies on guarded steps too, and not in a freeze window (lr 0).

`ReduceOnPlateau` is `optax.contrib.reduce_on_plateau`, the plateau scale
of the 2-D fits (`experiments/run_2d_ingp.py`,
`experiments/run_2d_reconstruction.py`).
"""
from __future__ import annotations

from typing import Dict, Iterable, List

import numpy as np
import torch

from nerf_experiments_tpu_torch.models.common import ParamGroup
from nerf_experiments_tpu_torch.training import schedules


def group_lr_schedules(groups: Dict[str, ParamGroup], schedule_kind: str = "le_nice",
                       scheduler_steps_per_period: int = 1):
    """label -> LR schedule (step -> float), exactly as the optimizer applies
    it; also the LearningRateMonitor rows (`barf/run_barf.py:139-141`)."""
    if schedule_kind == "le_nice":
        schedule_fn = schedules.le_nice
    elif schedule_kind == "garf_exponential":
        schedule_fn = schedules.garf_exponential
    elif schedule_kind == "quantized_exponential":
        def schedule_fn(a, b, c):
            return schedules.quantized_exponential(a, b, c, scheduler_steps_per_period)
    else:
        raise ValueError(f"unknown schedule_kind {schedule_kind!r}")

    def build(g: ParamGroup):
        base = schedule_fn(g.learning_rate_start, g.learning_rate_stop,
                           g.learning_rate_decay_end)
        if g.freeze_end_step <= g.freeze_start_step:
            return base
        lo, hi = g.freeze_start_step, g.freeze_end_step
        return lambda step: 0.0 if lo <= step < hi else base(step)

    return {label: build(g) for label, g in groups.items()}


def lr_row_fn(groups: Dict[str, ParamGroup], schedule_kind: str = "le_nice",
              scheduler_steps_per_period: int = 1):
    """(step) -> {"lr_<group>": float} for the trainer's metric rows."""
    scheds = group_lr_schedules(groups, schedule_kind, scheduler_steps_per_period)
    return lambda step: {f"lr_{label}": float(s(step)) for label, s in scheds.items()}


def guard_nonfinite(params: Iterable[torch.Tensor]) -> torch.Tensor:
    """Zero every parameter's gradient if ANY is non-finite; a missing
    gradient becomes zeros. Returns the (device) flag "all finite", without a
    host sync."""
    params = list(params)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    ok = torch.stack([torch.isfinite(p.grad).all() for p in params]).all()
    for p in params:
        p.grad.masked_fill_(~ok, 0.0)
    return ok


class MultiGroupAdam:
    """torch.optim.AdamW with one param group per label, LRs from schedules."""

    def __init__(self, groups: Dict[str, ParamGroup],
                 params_by_label: Dict[str, List[torch.Tensor]], eps: float = 1e-5,
                 schedule_kind: str = "le_nice", adam_b1: float = 0.9,
                 adam_b2: float = 0.999, scheduler_steps_per_period: int = 1):
        self.groups = dict(groups)
        self.schedules = group_lr_schedules(groups, schedule_kind, scheduler_steps_per_period)
        self.adam = torch.optim.AdamW(
            [{"params": list(params_by_label[label]), "label": label,
              "eps": eps if g.adam_eps is None else g.adam_eps, "lr": 0.0,
              "weight_decay": g.weight_decay}
             for label, g in groups.items()],
            lr=0.0, betas=(adam_b1, adam_b2), eps=eps, weight_decay=0.0)
        self.count = 0  # updates taken: the schedules' step
        # leaves split over a mesh's model axis (`parallel/shard.py:shard_state`):
        # their shards stand in for them in the groups above
        self.model_shards = []

    def params(self) -> List[torch.Tensor]:
        return [p for group in self.adam.param_groups for p in group["params"]]

    def step(self) -> None:
        for group in self.adam.param_groups:
            g = self.groups[group["label"]]
            group["lr"] = float(self.schedules[group["label"]](self.count))
            if g.freeze_start_step <= self.count < g.freeze_end_step:
                for p in group["params"]:
                    if p.grad is not None:
                        p.grad.zero_()
        self.adam.step()
        self.count += 1

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def state_dict(self) -> dict:
        return {"adam": self.adam.state_dict(), "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.adam.load_state_dict(state["adam"])
        self.count = int(state["count"])


def multi_group_adam(groups: Dict[str, ParamGroup],
                     params_by_label: Dict[str, List[torch.Tensor]], eps: float = 1e-5,
                     schedule_kind: str = "le_nice", adam_b1: float = 0.9,
                     adam_b2: float = 0.999,
                     scheduler_steps_per_period: int = 1) -> MultiGroupAdam:
    """The optimizer: `groups` label -> ParamGroup hyperparameters,
    `params_by_label` label -> its parameters. schedule_kind: "le_nice"
    (clamped closed form), "garf_exponential" (unclamped per step) or
    "quantized_exponential" (staircase, `scheduler_steps_per_period` steps
    per LR update)."""
    return MultiGroupAdam(groups, params_by_label, eps, schedule_kind, adam_b1, adam_b2,
                          scheduler_steps_per_period)


# optax.contrib.reduce_on_plateau's defaults, which the 2-D fit keeps
# (cooldown 0 and min_scale 0 leave nothing to count or clamp)
PLATEAU_RTOL = 1e-4
PLATEAU_ATOL = 0.0


class ReduceOnPlateau:
    """`optax.contrib.reduce_on_plateau` (optax 0.2.6, rtol 1e-4, atol 0,
    cooldown 0, min_scale 0) as a scale on the learning rate: the loss values
    handed to `update` are averaged over `accumulation_size` calls; at the
    end of each window the average improves on the best when it is below
    (1 - rtol) * best - atol, and after `patience` windows without
    improvement the scale is multiplied by `factor`. The scale `update`
    returns applies to the update of the same step, as optax's chain scales
    that step's Adam update. The average is kept in float32 on the loss's
    device, read once a window (the one host sync).

    Not `torch.optim.lr_scheduler.ReduceLROnPlateau`: its threshold and
    counting differ."""

    def __init__(self, factor: float = 0.5, patience: int = 5, accumulation_size: int = 100):
        self.factor, self.patience, self.accumulation_size = factor, patience, accumulation_size
        self.scale = np.float32(1.0)
        self.best_value = np.float32(np.inf)
        self.plateau_count = 0
        self.count = 0
        self.avg_value = None  # float32 device scalar, set by the first update

    def update(self, value) -> float:
        """Add one loss value; return the scale for this step's update."""
        value = torch.as_tensor(value).detach().float()
        avg = self.avg_value if self.avg_value is not None else torch.zeros_like(value)
        self.avg_value = (self.count * avg + value) / (self.count + 1)
        self.count += 1
        if self.count == self.accumulation_size:
            self._window_end(np.float32(self.avg_value.item()))
        return float(self.scale)

    def _window_end(self, avg: np.float32) -> None:
        improved = avg < np.float32(1 - PLATEAU_RTOL) * self.best_value - np.float32(PLATEAU_ATOL)
        if improved:
            self.best_value = avg
        self.plateau_count = 0 if improved else self.plateau_count + 1
        if self.plateau_count == self.patience:
            self.plateau_count = 0
            self.scale = self.scale * np.float32(self.factor)
        self.count = 0
        self.avg_value = torch.zeros_like(self.avg_value)

    def state_dict(self) -> dict:
        """The whole state machine: a run restored from it takes the same
        scales as one that never stopped, also within a window."""
        return {"scale": float(self.scale), "best_value": float(self.best_value),
                "plateau_count": self.plateau_count, "count": self.count,
                "avg_value": None if self.avg_value is None else self.avg_value.cpu()}

    def load_state_dict(self, state: dict, device=None) -> None:
        self.scale = np.float32(state["scale"])
        self.best_value = np.float32(state["best_value"])
        self.plateau_count = int(state["plateau_count"])
        self.count = int(state["count"])
        avg = state["avg_value"]
        self.avg_value = None if avg is None else avg.to(device)
