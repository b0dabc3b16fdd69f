"""Profiling and tracing hooks.

Port of the JAX package's `utils/profiling.py` onto `torch.profiler`:
  * `trace(dir)`: a context manager that profiles the host and the card
    (CUDA kernels through CUPTI) and writes a Chrome trace
    (`<dir>/trace.json`, open it in Perfetto or chrome://tracing);
  * `annotate(name)`: a labelled range in that trace
    (`torch.profiler.record_function`);
  * `StepTimer`: rays/s over steps after a warm-up, synchronised with the
    card by `torch.cuda.synchronize` (a device tensor's `float()` is not
    needed as a sync point here);
  * rays/s is also a metric the trainer logs every log interval
    (`training/trainer.py`: `train_rays_per_sec`).
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

TRACE_FILE = "trace.json"


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
    trace."""
    return record_function(name)


class StepTimer:
    """Throughput meter: the clock starts after `warmup` ticks, at a device
    sync, and `rays_per_sec` syncs again before it reads the clock.

        timer = StepTimer(device)
        for ...:
            state, metrics = step(...)
            timer.tick(rays=batch_size)
        print(timer.rays_per_sec())
    """

    def __init__(self, device=None, warmup: int = 3):
        device = torch.device(device) if device is not None else None
        self._cuda = device is not None and device.type == "cuda"
        self._device = device
        self._warmup = warmup
        self._count = 0
        self._rays = 0
        self._t0: Optional[float] = None

    def sync(self) -> None:
        if self._cuda:
            torch.cuda.synchronize(self._device)

    def tick(self, rays: int) -> None:
        self._count += 1
        if self._count == self._warmup:
            self.sync()  # drain the queue before the clock starts
            self._t0 = time.perf_counter()
            self._rays = 0
        elif self._count > self._warmup:
            self._rays += rays

    def rays_per_sec(self) -> float:
        if self._t0 is None or self._rays == 0:
            return float("nan")
        self.sync()
        return self._rays / (time.perf_counter() - self._t0)
