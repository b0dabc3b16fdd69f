"""Profiling and tracing hooks.

Port of the JAX package's `utils/profiling.py` onto `torch.profiler`:
  * `trace(dir)`: a context manager that profiles the host and the card
    (CUDA kernels through CUPTI) and writes a Chrome trace
    (`<dir>/trace.json`, open it in Perfetto or chrome://tracing);
  * `annotate(name)`: a labelled range in that trace
    (`torch.profiler.record_function`), on the profiler's clock, the one the
    card's kernels are placed on. With no profiler running it is one shared
    null context, so the spans the train steps and the serving loop enter
    cost a check each.

The program's spans, entered through `annotate` (no two siblings overlap):
  * each train step (`systems/barf.py`): `trainer.step.camera` (the ray
    transform and the blurred target), `trainer.step.bins` (the fused step's
    coarse stage and fine bins), `trainer.step.k4` (the flagship train
    kernel's call), `trainer.step.backward` (autograd), `trainer.step.update`
    (guard, Adam, occupancy refresh);
  * each log row of `Trainer.fit`: `trainer.log`;
  * each chunk served (`render_views.render_image`): `render.rays` (the
    chunk's rays to the card), `render.bins` (`forward` or
    `render_block_coarse`: the fine bins; in the plain train step too),
    `render.fine` (`rgb_fine_pass`), `render.to_host` (its rgb to the host).
"""
from __future__ import annotations

import contextlib
import os

import torch
from torch.profiler import ProfilerActivity, profile, record_function

TRACE_FILE = "trace.json"
_OFF = contextlib.nullcontext()


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block (CPU, and CUDA when a card is present) and export
    its Chrome trace to `<log_dir>/trace.json`. Yields the profiler (its
    `key_averages()` give per-op times)."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def annotate(name: str):
    """A labelled range of host work (and the kernels it launches) in the
    trace of a running profiler; with none running, a null context."""
    if not torch._C._autograd._profiler_enabled():
        return _OFF
    return record_function(name)
