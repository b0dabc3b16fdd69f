"""The program's seams that the harness relies on, each checked on the CPU at
the small size of `small.py`. A change to the program that breaks one makes
every run of the cells that use it read `correct` false (or fail), so a
program change has to keep these (README.md, "Seams"):

* training: the step function that `Trainer.fit` calls draws from the step
  generator it is handed what the family's `step_draws` draws, first and in
  that order (for BARF the comb's offset, one (rays, 1) `torch.rand`); the
  harness replays them for the reference from a copy of the generator's
  state;
* training: after one update from empty moments, Adam's `exp_avg` over
  (1 - beta1) is the first gradient, and `optimizer.count` counts updates;
* training: `Trainer.fit` calls the instance's `_batch`, `step_fn` and each
  of `callbacks` once a step, stops at `cfg.max_steps`, and lets an
  exception raised by a callback out (the window's end);
* serving: `render_views.render_image` calls `render_views.barf_sys.forward`
  and `render_views.calibration.validation_transform_rays` once a chunk and
  returns the view's rgb on the host.
"""
import math

import numpy as np
import pytest
import torch

from bench_torch import harness, scene
from bench_torch.kinds import train as train_kind
from bench_torch.reference.common import exact_fp32
from bench_torch.tests.small import context, small_cell, train_cells

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]
SERVE = [c for c in CELLS if harness.resolve(c).traffic["kind"] == "serve"]


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _built(cell, tmp_path):
    ctx = context(small_cell(*cell(tmp_path)))
    args, exp, weights = train_kind.build(ctx, str(tmp_path / "out"))
    return ctx, exp, weights


@pytest.mark.parametrize("family, cell", train_cells())
def test_step_draws_the_comb_offset_first(family, cell, tmp_path, monkeypatch):
    """The step's first draws from its generator are the family's
    `step_draws`, in order: for BARF the comb's offset (rays, 1)."""
    ctx, exp, _ = _built(cell, tmp_path)
    fam = harness.family_module(ctx.cell.config)
    trainer, start = exp.trainer, exp.state.step
    gen, real, drawn = trainer._generator, torch.rand, []

    def spy(*a, **k):
        out = real(*a, **k)
        if k.get("generator") is gen:
            drawn.append(out.clone())
        return out

    monkeypatch.setattr(torch, "rand", spy)
    rec = train_kind._Recorder(trainer, fam)
    train_kind._fit_to(trainer, exp.state, start + 1)
    rec.restore()
    model = ctx.cell.config["model"]
    replayed = train_kind.replay(rec.calls[0], fam, model)
    expected = [k for k in replayed if k not in rec.calls[0]["batch"]]
    assert len(drawn) >= len(expected), (
        f"the step drew {len(drawn)} torch.rand from the step generator, the family "
        f"replays {expected}")
    for got, key in zip(drawn, expected):
        assert tuple(got.shape) == tuple(replayed[key].shape), (
            f"the step's draw is {tuple(got.shape)}, not the family's {key!r} "
            f"{tuple(replayed[key].shape)}")
        assert torch.equal(got, replayed[key]), (
            f"the replayed {key!r} is not the one the step drew")


@pytest.mark.parametrize("family, cell", train_cells())
def test_first_moment_is_the_first_gradient(family, cell, tmp_path):
    ctx, exp, weights = _built(cell, tmp_path)
    fam = harness.family_module(ctx.cell.config)
    start = exp.state.step
    rec = train_kind._Recorder(exp.trainer, fam)
    state = train_kind._fit_to(exp.trainer, exp.state, start + 1)
    rec.restore()
    assert state.optimizer.count == start + 1
    adam = state.optimizer.adam
    assert all("exp_avg" in adam.state[p] for p in state.params.parameters())
    grads = train_kind._first_grads(state)
    model = ctx.cell.config["model"]
    with exact_fp32():
        r = fam.train_steps(weights, model, [train_kind.replay(rec.calls[0], fam, model)], start)
    gap, leaf = train_kind._leaf_gap(grads, r["grad"])
    limit = ctx.cell.limits["grad_gap"]
    assert gap <= limit, f"first moment against the reference gradient: {leaf} {gap} > {limit}"


@pytest.mark.parametrize("family, cell", train_cells()[:1])
def test_fit_calls_what_the_harness_wraps(family, cell, tmp_path):
    ctx, exp, _ = _built(cell, tmp_path)
    trainer, start = exp.trainer, exp.state.step
    calls = {"batch": 0, "step": 0, "callback": []}
    batch, step = trainer._batch, trainer.step_fn

    def batch_spy(*a, **k):
        calls["batch"] += 1
        return batch(*a, **k)

    def step_spy(*a, **k):
        calls["step"] += 1
        return step(*a, **k)

    class End(Exception):
        pass

    def callback(trainer_, state_, step_, ef_):
        calls["callback"].append(step_)
        if step_ == start + 5:
            raise End

    trainer._batch, trainer.step_fn = batch_spy, step_spy
    trainer.callbacks.append(callback)
    state = train_kind._fit_to(trainer, exp.state, start + 3)
    assert state.step == start + 3
    assert calls == {"batch": 3, "step": 3, "callback": [start + 1, start + 2, start + 3]}
    with pytest.raises(End):
        train_kind._fit_to(trainer, state, 2**62)
    assert calls["callback"][-1] == start + 5


@pytest.mark.parametrize("cell", SERVE[:1])
def test_render_image_calls_forward_per_chunk(cell):
    from nerf_experiments_tpu_torch.experiments import render_views
    from nerf_experiments_tpu_torch.systems import barf as barf_sys

    c = small_cell(cell)
    size, chunk = c.config["scene"]["image_size"], c.traffic["chunk"]
    root = scene.ensure(c.config["scene"], images=("train",), poses=(c.traffic["split"],),
                        device="cpu")
    entry = harness.entry_module(c.config)
    cfg, dm = entry.build_config(entry.parse_args(c.config["flags"] + ["--scene_path", root]))
    params = barf_sys.init(torch.Generator().manual_seed(0), cfg)
    fam = harness.family_module(c.config)
    harness.load_weights(params, fam.draw_weights(
        fam.param_shapes(c.config["model"], dm.n_training_images), 5, "cpu"))
    origs, dirs, pw = scene.view_rays(root, c.traffic["split"], size)
    counts = {"forward": 0, "transform": 0}
    forward, transform = barf_sys.forward, render_views.calibration.validation_transform_rays

    def forward_spy(*a, **k):
        counts["forward"] += 1
        return forward(*a, **k)

    def transform_spy(*a, **k):
        counts["transform"] += 1
        return transform(*a, **k)

    gauge = (torch.eye(3), torch.zeros(1, 3), torch.tensor(1.0))
    try:
        render_views.barf_sys.forward = forward_spy
        render_views.calibration.validation_transform_rays = transform_spy
        rgb = render_views.render_image(params, cfg, origs[0], dirs[0], gauge, pw, chunk, "cpu",
                                        10.0, 4.0)
    finally:
        render_views.barf_sys.forward = forward
        render_views.calibration.validation_transform_rays = transform
    n_chunks = math.ceil(size * size / chunk)
    assert counts == {"forward": n_chunks, "transform": n_chunks}
    assert isinstance(rgb, np.ndarray) and rgb.shape == (size * size, 3)
