"""Faults planted underneath the timed path, to show that the check catches
them (`tests/test_faults.py`, `calibrate.py --faults`). Each takes what the
kind hands `ctx.fault` (the built experiment for training, the
`render_views` module for serving) and returns an undo, or None."""
from __future__ import annotations

import torch


def state_unchanged(exp):
    """Every training step returns its state unchanged: the parameters as
    they were, Adam's moments empty."""
    inner = exp.trainer.step_fn

    def step(state, batch, gen, *scalars):
        saved = [p.detach().clone() for p in state.params.parameters()]
        state, metrics = inner(state, batch, gen, *scalars)
        with torch.no_grad():
            for p, s in zip(state.params.parameters(), saved):
                p.copy_(s)
        state.optimizer.adam.state.clear()
        return state, metrics

    exp.trainer.step_fn = step


def half_batch(exp):
    """Every training step sees the first half of its batch, its means
    taken over those rays alone."""
    inner = exp.trainer.step_fn

    def step(state, batch, gen, *scalars):
        half = batch["img_idx"].shape[0] // 2
        return inner(state, {k: v[:half] for k, v in batch.items()}, gen, *scalars)

    exp.trainer.step_fn = step


def answer_altered(render_views):
    """The first ray of every rendered chunk has its colour moved by 0.3,
    where it is produced."""
    sys_mod = render_views.barf_sys
    forward = sys_mod.forward

    def altered(*a, **k):
        rgb, coarse = forward(*a, **k)
        rgb = rgb.clone()
        rgb[0] = torch.where(rgb[0] < 0.5, rgb[0] + 0.3, rgb[0] - 0.3)
        return rgb, coarse

    sys_mod.forward = altered

    def undo():
        sys_mod.forward = forward

    return undo


BY_KIND = {"train": {"state_unchanged": state_unchanged, "half_batch": half_batch},
           "serve": {"answer_altered": answer_altered}}
