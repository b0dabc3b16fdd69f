"""The port's spans (`utils/profiling.annotate`) on the CPU at a tiny size:
free when no profiler runs, entered once a step or a chunk in the order of
the phases when one does, read back by the benchmark's `Trace` and its
per-layer metric readers; and the trainer's logged `train_rays_per_sec`,
measured over the interval since the log row before.

No JAX: the steps run their plain versions on the CPU, and the spans are
compared with what the benchmark's trace reader keeps."""
import contextlib
import dataclasses
import json
import os
import time
import types

import numpy as np
import pytest
import torch

from bench_torch import harness
from bench_torch import trace as bench_trace
from nerf_experiments_tpu_torch.data import sampler
from nerf_experiments_tpu_torch.encodings.fourier import Barf
from nerf_experiments_tpu_torch.experiments import render_views
from nerf_experiments_tpu_torch.models import nerf_mlp
from nerf_experiments_tpu_torch.systems import barf
from nerf_experiments_tpu_torch.training.loggers import MetricLogger
from nerf_experiments_tpu_torch.training.trainer import Trainer, TrainerConfig
from nerf_experiments_tpu_torch.utils import profiling

STEP_SPANS = ["trainer.step.camera", "trainer.step.bins", "trainer.step.k4",
              "trainer.step.backward", "trainer.step.update"]
PLAIN_STEP_SPANS = ["trainer.step.camera", "render.bins", "render.fine",
                    "trainer.step.backward", "trainer.step.update"]
RENDER_SPANS = ["render.rays", "render.bins", "render.fine", "render.to_host"]
PROGRAM_SPANS = sorted(set(STEP_SPANS + RENDER_SPANS + ["trainer.log"]))
# the spans the benchmark's traffic puts around its calls into the program
HARNESS_SPANS = {"trainer.batch", "trainer.step", "trainer.pose_error", "render.view",
                 "render.forward", "render.transform"}
TRAIN_READERS = {"host_bins_ms.train": "trainer.step.bins", "host_k4_ms.train": "trainer.step.k4",
                 "host_backward_ms.train": "trainer.step.backward",
                 "host_update_ms.train": "trainer.step.update"}
SERVE_READERS = {"host_bins_ms.serve": "render.bins", "host_copy_ms.serve": "render.to_host"}
SCALARS = (4.0, 2.0, 0.0)  # alpha_pos, alpha_dir, blur sigma
CHUNK = 8
VIEW_RAYS = 3 * CHUNK - 2  # three chunks, the last one short


def config():
    """A tiny flagship-shaped BARF config with a proposal stage."""
    enc = dict(scale=1.0, include_identity=True)

    def mlp(n_hidden, hidden_dim, n_segments):
        return nerf_mlp.NerfMLPConfig(
            position_encoder=Barf(levels=4, **enc), direction_encoder=Barf(levels=2, **enc),
            n_hidden=n_hidden, hidden_dim=hidden_dim, n_segments=n_segments,
            delayed_direction=True, delayed_density=False)

    return barf.BarfConfig(radiance=mlp(2, 32, 2), proposal=mlp(1, 16, 1), n_training_images=4,
                           near=2.0, far=6.0, samples_per_ray_radiance=8,
                           samples_per_ray_proposal=4)


def rays(n, seed):
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return (rng.normal(size=(n, 3)) * 0.3).astype(np.float32), dirs.astype(np.float32)


def batch(n=16, seed=1):
    origs, dirs = rays(n, seed)
    rng = np.random.default_rng(seed + 1)
    return {"origs_noisy": torch.as_tensor(origs), "dirs_noisy": torch.as_tensor(dirs),
            "colors": torch.as_tensor(rng.uniform(size=(n, 2, 3)).astype(np.float32)),
            "img_idx": torch.as_tensor(rng.integers(0, 4, size=n)),
            "pixel_width": torch.full((n, 1), 1e-3)}


def one_step(fused):
    cfg = config()
    state = barf.init_state(cfg, barf.init(torch.Generator().manual_seed(0), cfg))
    step = barf.make_train_step(cfg, fused=fused)
    state, metrics = step(state, batch(), torch.Generator().manual_seed(3), *SCALARS)
    assert state.step == 1 and torch.isfinite(metrics["loss"])


def render_one_view():
    cfg = config()
    params = barf.init(torch.Generator().manual_seed(0), cfg)
    origs, dirs = rays(VIEW_RAYS, 5)
    gauge = (torch.eye(3), torch.zeros((1, 3)), torch.tensor(1.0))
    rgb = render_views.render_image(params, cfg, origs, dirs, gauge, 1e-3, CHUNK, "cpu",
                                    *SCALARS[:2])
    assert rgb.shape == (VIEW_RAYS, 3) and np.isfinite(rgb).all()


def traced(fn):
    held = {}
    with bench_trace.traced(held):
        fn()
    return held["trace"]


def program_spans(tr):
    return [s for s in tr.spans if s[0] in PROGRAM_SPANS]


@pytest.fixture(scope="module")
def step_trace():
    return traced(lambda: one_step(fused=True))


@pytest.fixture(scope="module")
def render_trace():
    return traced(render_one_view)


# ---------------------------------------------------------------- off


def test_annotate_is_one_null_context_with_no_profiler():
    a, b = profiling.annotate("trainer.step.k4"), profiling.annotate("render.bins")
    assert a is b and isinstance(a, contextlib.nullcontext)
    with a, b:  # nests
        pass


@pytest.mark.parametrize("run", [lambda: one_step(fused=True), lambda: one_step(fused=False),
                                 render_one_view], ids=["fused_step", "plain_step", "render"])
def test_no_record_function_without_a_profiler(run, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler running")

    monkeypatch.setattr(profiling, "record_function", refuse)
    run()


def test_annotate_records_under_a_profiler():
    def work():
        assert not isinstance(profiling.annotate("render.bins"), contextlib.nullcontext)
        with profiling.annotate("render.bins"):
            torch.ones(4).sum()

    assert traced(work).span_stats("render.bins")[1] == 1


# ---------------------------------------------------------------- a training step


def assert_in_order_without_overlap(spans, names):
    assert [s[0] for s in spans] == names
    for (_, _, end), (_, start, _) in zip(spans, spans[1:]):
        assert end <= start


@pytest.mark.parametrize("fused,names", [(True, STEP_SPANS), (False, PLAIN_STEP_SPANS)],
                         ids=["fused", "plain"])
def test_a_step_enters_each_phase_once_in_order(fused, names, step_trace):
    tr = step_trace if fused else traced(lambda: one_step(fused=False))
    assert_in_order_without_overlap(program_spans(tr), names)


def test_fit_enters_a_log_span_a_log_row(tmp_path):
    cfg = config()
    state = barf.init_state(cfg, barf.init(torch.Generator().manual_seed(0), cfg))
    trainer = Trainer(
        cfg=TrainerConfig(max_steps=4, batch_size=16, log_every_n_steps=2,
                          val_every_n_epochs=1e9),
        train_store=tiny_store(), step_fn=barf.make_train_step(cfg, fused=True),
        scalar_fn=lambda step, ef: SCALARS, metric_logger=MetricLogger(str(tmp_path)))
    tr = traced(lambda: trainer.fit(state))
    logs = [s for s in tr.spans if s[0] == "trainer.log"]
    assert len(logs) == 2
    assert sum(s[0] == "trainer.step.k4" for s in tr.spans) == 4
    # each log row follows its step's update
    updates = [s for s in tr.spans if s[0] == "trainer.step.update"]
    assert logs[0][1] >= updates[1][2] and logs[1][1] >= updates[3][2]


# ---------------------------------------------------------------- serving


def test_render_image_enters_each_phase_once_a_chunk(render_trace):
    spans = program_spans(render_trace)
    assert [s[0] for s in spans] == RENDER_SPANS * 3
    for name in RENDER_SPANS:
        assert render_trace.span_stats(name)[1] == 3


def test_block_coarse_serving_enters_bins_and_fine():
    cfg = config()
    params = barf.init(torch.Generator().manual_seed(0), cfg)
    origs, dirs = rays(16, 6)
    tr = traced(lambda: barf.render_block_coarse(params, cfg, torch.as_tensor(origs),
                                                 torch.as_tensor(dirs), *SCALARS[:2], block=4))
    assert [s[0] for s in program_spans(tr)] == ["render.bins", "render.fine"]


# ---------------------------------------------------------------- names


@pytest.mark.parametrize("name", PROGRAM_SPANS)
def test_a_program_span_is_kept_by_the_trace_and_is_no_harness_span(name):
    assert name not in HARNESS_SPANS
    assert name.startswith(bench_trace.SPAN_PREFIXES) and name != bench_trace.WINDOW_SPAN


def test_the_trace_names_idle_time_by_the_innermost_program_span(step_trace):
    assert all(n in PROGRAM_SPANS or n == "outside harness spans"
               for n, _ in step_trace.idle_gaps(20))
    k4 = next(s for s in step_trace.spans if s[0] == "trainer.step.k4")
    assert step_trace.host_span_at(0.5 * (k4[1] + k4[2])) == "trainer.step.k4"


# ---------------------------------------------------------------- the metric readers


def outcome(tr, **window):
    return types.SimpleNamespace(trace=tr, window=window)


@pytest.mark.parametrize("name", sorted(TRAIN_READERS) + sorted(SERVE_READERS))
def test_reader_reads_its_span(name, step_trace, render_trace):
    reader = harness.metric_reader(name)
    own, other = ((step_trace, render_trace) if name in TRAIN_READERS
                  else (render_trace, step_trace))
    span = {**TRAIN_READERS, **SERVE_READERS}[name]
    value = reader.read(None, outcome(own, trace_steps=1, trace_views=1))
    assert value > 0 and value == pytest.approx(1e3 * own.span_stats(span)[0])
    half = reader.read(None, outcome(own, trace_steps=2, trace_views=2))
    assert half == pytest.approx(value / 2)
    # a program without the span (the parent of the spans), and no trace
    assert reader.read(None, outcome(other, trace_steps=1, trace_views=1)) is None
    assert reader.read(None, outcome(None, trace_steps=1, trace_views=1)) is None


def test_every_reader_is_a_per_layer_metric_of_its_cells():
    per_layer = {m["name"]: m for m in harness.benchmark()["per_layer"]}
    for names, kind in ((TRAIN_READERS, "train"), (SERVE_READERS, "serve")):
        for name in names:
            m = per_layer[name]
            assert m["source"] == "program_span" and m["unit"] == "ms"
            assert all(w.endswith("." + kind) for w in m["workloads"])


# ---------------------------------------------------------------- the logged rate


@dataclasses.dataclass
class TinyState:
    params: dict
    step: int = 0


def tiny_store(n_rays=64):
    g = torch.Generator().manual_seed(0)
    return sampler.RayStore(
        origins_raw=torch.randn((n_rays, 3), generator=g),
        origins_noisy=torch.randn((n_rays, 3), generator=g),
        dirs_raw=torch.randn((n_rays, 3), generator=g),
        dirs_noisy=torch.randn((n_rays, 3), generator=g),
        colors=torch.rand((n_rays, 2, 3), generator=g),
        img_idx=torch.zeros((n_rays,), dtype=torch.int64),
        pixel_width=0.01, gaussian_blur_sigmas=(0.0, 0.0),
        camera_origins_raw=torch.zeros((4, 3)), camera_origins_noisy=torch.zeros((4, 3)))


def test_logged_rate_counts_since_the_row_before(tmp_path, monkeypatch):
    """Steps 1-4 take 1 s each, steps 5-8 take 3 s each: the second row's
    rate is that of its own interval, not of the run so far."""
    clock = [100.0]
    monkeypatch.setattr(time, "perf_counter", lambda: clock[0])

    def step_fn(state, batch, gen):
        clock[0] += 1.0 if state.step < 4 else 3.0
        return TinyState(state.params, state.step + 1), {"loss": batch["colors"].mean()}

    Trainer(cfg=TrainerConfig(max_steps=8, batch_size=8, log_every_n_steps=4,
                              val_every_n_epochs=1e9, rollback_enabled=False),
            train_store=tiny_store(), step_fn=step_fn, scalar_fn=lambda step, ef: (),
            metric_logger=MetricLogger(str(tmp_path))).fit(TinyState({}))
    rows = [json.loads(line) for line in open(os.path.join(str(tmp_path), "metrics.jsonl"))]
    rows = [r for r in rows if "train_rays_per_sec" in r]
    assert [r["train_rays_per_sec"] for r in rows] == [pytest.approx(32 / 4.0),
                                                       pytest.approx(32 / 12.0)]
    assert [r["wall_s"] for r in rows] == [4.0, 16.0]
