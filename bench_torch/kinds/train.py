"""Training traffic: a closed loop of training steps through the entry's
own trainer (`<entry>.build`, `Trainer.fit`), resumed at a fixed step.

Set-up builds the experiment once from the configuration's flags (the scene
from the cache, the camera noise and the trainer's batch stream from
`--seed`), loads the weights of the configuration's reference family
(`reference/<family>.py`) into it and sets its step and its optimizer's
update count to the traffic's `start_step`, with Adam's moments empty, as a
run resumed there with a fresh optimizer. It then drives that same object
through its first `check_steps` steps, recording each step's batch, the
state of its step generator (from which the family replays the step's
draws) and its loss; the first gradient (Adam's first moment after one
step) and the parameters' change after the last; then `warmup_steps` more.
The window trains until `--seconds` have passed on the host clock and
closes at a device sync; a traced run then profiles `trace_steps` more
steps with the harness's spans around the trainer's calls. Validation and image logs are off (events of an
epoch, which is longer than a run); log rows and the pose error stay as the
entry sets them.
"""
from __future__ import annotations

import dataclasses
import gc
import shutil
import tempfile
import time
from typing import Dict, List

import torch

from bench_torch import harness, scene
from bench_torch import trace as tracing
from bench_torch.reference.common import exact_fp32

# a family with the reference's steps models an entry with a `build`, a
# `parse_args` and a trainer (`Trainer.fit`) that this kind drives
FAMILY_FUNCTION = "train_steps"
ENTRIES = harness.entries_with(FAMILY_FUNCTION)


class _WindowEnd(Exception):
    pass


class _Recorder:
    """Wraps the trainer's step function for the check steps: records, before
    each step, the batch keys the family names and a copy of the state of
    the step's generator; after it, the step's loss."""

    def __init__(self, trainer, family):
        self.trainer, self.inner, self.family = trainer, trainer.step_fn, family
        self.calls: List[Dict] = []
        trainer.step_fn = self

    def __call__(self, state, batch, gen, *scalars):
        call = {"batch": {k: batch[k].detach().clone() for k in self.family.BATCH_KEYS},
                "gen_state": gen.get_state(), "gen_device": gen.device}
        state, metrics = self.inner(state, batch, gen, *scalars)
        call["loss"] = float(metrics["loss"])
        self.calls.append(call)
        return state, metrics

    def restore(self):
        self.trainer.step_fn = self.inner


def replay(call: dict, family, model: dict) -> dict:
    """A recorded step's batch with the draws the family's reference replays,
    made from a generator at the step's starting state."""
    gen = torch.Generator(device=call["gen_device"])
    gen.set_state(call["gen_state"])
    return dict(call["batch"], **family.step_draws(model, call["batch"], gen))


def _fit_to(trainer, state, last_step: int):
    trainer.cfg = dataclasses.replace(trainer.cfg, max_steps=last_step)
    return trainer.fit(state)


def _spans(trainer):
    """Wrap the trainer's calls into the batch gather, the step and the pose
    error in harness spans; returns the undo."""
    batch, step, pose = trainer._batch, trainer.step_fn, trainer.pose_error_fn

    def batch_span(*a, **k):
        with tracing.span("trainer.batch"):
            return batch(*a, **k)

    def step_span(*a, **k):
        with tracing.span("trainer.step"):
            return step(*a, **k)

    def pose_span(*a, **k):
        with tracing.span("trainer.pose_error"):
            return pose(*a, **k)

    trainer._batch, trainer.step_fn, trainer.pose_error_fn = batch_span, step_span, pose_span

    def undo():
        del trainer._batch  # back to the class's method
        trainer.step_fn, trainer.pose_error_fn = step, pose

    return undo


def _first_grads(state) -> Dict[str, torch.Tensor]:
    """Each leaf's first gradient as the optimizer holds it: Adam's first
    moment after one step over (1 - beta1); zero where it holds none."""
    adam = state.optimizer.adam
    out = {}
    names = {id(p): n for n, p in state.params.named_parameters()}
    for group in adam.param_groups:
        beta1 = group["betas"][0]
        for p in group["params"]:
            st = adam.state.get(p, {})
            m = st.get("exp_avg")
            out[names[id(p)]] = (m / (1 - beta1)).detach().clone() if m is not None \
                else torch.zeros_like(p)
    return out


def build(ctx: harness.Context, out_dir: str):
    """(args, experiment, weights): the entry's experiment built from the
    configuration's flags, the harness's weights loaded into it, resumed at
    the traffic's `start_step` with Adam's moments empty; validation and the
    image logs off."""
    cfg_file = ctx.cell.config
    family = harness.family_module(cfg_file)
    entry = harness.entry_module(cfg_file)
    root = scene.ensure(cfg_file["scene"], images=("train", "val"), device=ctx.device)
    args = entry.parse_args(list(cfg_file["flags"]) + [
        "--scene_path", root, "--seed", str(ctx.seed), "--device", str(ctx.device),
        "--checkpoint_every_n_epochs", "0", "--out_dir", out_dir])
    harness.log(f"scene ready at {harness.elapsed(ctx.t_start):.2f} s")
    exp = entry.build(args)
    harness.log(f"experiment built at {harness.elapsed(ctx.t_start):.2f} s")
    exp.trainer.callbacks.clear()  # image and camera-point logs
    exp.trainer.val_fn = None
    shapes = family.param_shapes(cfg_file["model"], exp.dm.n_training_images)
    weights = family.draw_weights(shapes, ctx.seed, ctx.device)
    harness.load_weights(exp.state.params, weights)
    start = int(ctx.cell.traffic["start_step"])
    exp.state.step = start
    exp.state.optimizer.count = start
    return args, exp, weights


def run(ctx: harness.Context) -> harness.Outcome:
    traffic = ctx.cell.traffic
    cuda = torch.device(ctx.device).type == "cuda"
    out_dir = tempfile.mkdtemp(prefix="bench_train_")
    undo_fault = None
    try:
        args, exp, weights = build(ctx, out_dir)
        trainer, state = exp.trainer, exp.state
        start = int(traffic["start_step"])
        undo_fault = ctx.fault(exp) if ctx.fault is not None else None

        rec = _Recorder(trainer, harness.family_module(ctx.cell.config))
        state = _fit_to(trainer, state, start + 1)
        grads = _first_grads(state)
        state = _fit_to(trainer, state, start + traffic["check_steps"])
        rec.restore()
        harness.log(f"check steps done at {harness.elapsed(ctx.t_start):.2f} s")
        calls = rec.calls
        del rec
        change = {n: (p.detach() - weights[n]).clone()
                  for n, p in state.params.named_parameters()}
        state = _fit_to(trainer, state, start + traffic["check_steps"] + traffic["warmup_steps"])
        if cuda:
            torch.cuda.synchronize()
        setup_s = harness.elapsed(ctx.t_start)

        # the window: trains until the deadline, closes at a device sync
        steps = [0]
        t0 = time.perf_counter()
        deadline = t0 + ctx.seconds
        gap = [t0, 0.0, 0, 0.0]  # last step end, longest host gap, its step, closing sync

        def stop(trainer_, state_, step_, ef_):
            steps[0] += 1
            now = time.perf_counter()
            if now - gap[0] > gap[1]:
                gap[1], gap[2] = now - gap[0], step_
            gap[0] = now
            if now >= deadline:
                if cuda:
                    torch.cuda.synchronize()
                gap[3] = time.perf_counter() - now
                raise _WindowEnd(state_)

        trainer.callbacks.append(stop)
        try:
            _fit_to(trainer, state, 2**62)
        except _WindowEnd as end:
            state = end.args[0]
        window_s = time.perf_counter() - t0
        trainer.callbacks.remove(stop)
        harness.log(f"set-up {setup_s:.2f} s; window {window_s:.3f} s, {steps[0]} steps; longest "
                    f"host gap between steps {gap[1] * 1e3:.1f} ms (step {gap[2]}), closing sync "
                    f"{gap[3] * 1e3:.1f} ms")

        held = {}
        if ctx.trace:
            undo = _spans(trainer)
            try:
                with tracing.traced(held):
                    state = _fit_to(trainer, state, state.step + traffic["trace_steps"])
            finally:
                undo()
        finite = all(bool(torch.isfinite(p).all()) for p in state.params.parameters())
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        batch = args.batch_size
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
        if undo_fault is not None:
            undo_fault()
    # the program's state goes before the reference runs
    del exp, trainer, state
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    rays = steps[0] * batch
    return harness.Outcome(
        end_to_end={"train_rays_per_s": rays / window_s, "setup_s": setup_s},
        attempted=steps[0], failed=0 if finite else steps[0],
        window={"seconds": window_s, "steps": steps[0], "rays": rays, "batch": batch,
                "trace_steps": traffic["trace_steps"]},
        check={"weights": weights, "calls": calls, "grads": grads, "change": change,
               "start": start},
        trace=held.get("trace"), memory_peak_bytes=peak)


def _leaf_gap(prog: Dict[str, torch.Tensor], refs: Dict[str, torch.Tensor], keep=None):
    """The worst leaf's gap between the norms, |‖prog‖ - ‖ref‖| over the
    larger of the reference leaf's norm and the median leaf's."""
    norms = {k: float(v.double().norm()) for k, v in refs.items()}
    med = sorted(norms.values())[len(norms) // 2]
    gaps = {k: abs(float(prog[k].double().norm()) - norms[k]) / max(norms[k], med, 1e-30)
            for k in refs if keep is None or keep(k)}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def compare(ctx: harness.Context, check: dict, control: str = None) -> Dict[str, float]:
    """The loss of every check step, the worst leaf of the first gradient
    and the worst leaf of the change after the check steps, against the
    reference from the same weights, batches and uniforms. Leaves whose
    reference gradient is under a thousandth of the median leaf's (moved by
    round-off alone under Adam) are left out of the change."""
    model = ctx.cell.config["model"]
    family = harness.family_module(ctx.cell.config)
    batches = [replay(c, family, model) for c in check["calls"]]
    with exact_fp32():
        r = family.train_steps(check["weights"], model, batches, check["start"])
        if control is None:
            prog = {"losses": [c["loss"] for c in check["calls"]], "grad": check["grads"],
                    "change": check["change"]}
        else:
            prog = family.train_steps(check["weights"], model, batches, check["start"], control)
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], r["losses"]))
    grad_gap, grad_leaf = _leaf_gap(prog["grad"], r["grad"])
    gnorm = {k: float(v.double().norm()) for k, v in r["grad"].items()}
    floor = 1e-3 * sorted(gnorm.values())[len(gnorm) // 2]
    change_gap, change_leaf = _leaf_gap(prog["change"], r["change"], keep=lambda k: gnorm[k] >= floor)
    harness.log(f"worst leaves: grad {grad_leaf}, change {change_leaf}; left out of the change: "
                f"{sorted(k for k in gnorm if gnorm[k] < floor)}")
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap}
