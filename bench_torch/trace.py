"""The traced stretch of a run: `torch.profiler` (CUPTI) over a block, its
Chrome trace read back into device intervals, the harness's host spans and
the stretch's own span.

Everything here reads the trace as recorded: device time is the union of
the kernels', copies' and fills' intervals on the card, the stretch is the
host span `bench.trace` around the block (ended after a device sync), and an
idle gap is named by the innermost harness span the host was in when the
card went idle.
"""
from __future__ import annotations

import contextlib
import json
import os
import shutil
import tempfile
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function

WINDOW_SPAN = "bench.trace"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the prefixes of the harness's own spans (`span` below)
SPAN_PREFIXES = ("trainer.", "render.", "bench.")


def span(name: str):
    """A host span of the harness around a call into the program."""
    return record_function(name)


def short_name(name: str) -> str:
    """A kernel's name without its return type, anonymous namespaces,
    template and arguments: `netpu::reduce_kernel`, `flagship_train_kernel`."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    cuts = [i for i in (name.find("<"), name.find("(")) if i > 0]
    return (name[:min(cuts)] if cuts else name).strip()


class Trace:
    """The events of one traced stretch, times in seconds from its start."""

    def __init__(self, events: List[dict]):
        window = [e for e in events if e.get("name") == WINDOW_SPAN and e.get("ph") == "X"
                  and e.get("cat") == "user_annotation"]
        if not window:
            raise ValueError(f"the trace holds no {WINDOW_SPAN} span")
        w = window[0]
        t0, t1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
        self.window_s = (t1 - t0) * 1e-6

        def clip(e):
            a, b = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
            a, b = max(a, t0), min(b, t1)
            return ((a - t0) * 1e-6, (b - t0) * 1e-6) if b > a else None

        self.device: List[Tuple[str, float, float]] = []
        self.spans: List[Tuple[str, float, float]] = []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat")
            if cat in DEVICE_CATS:
                iv = clip(e)
                if iv:
                    self.device.append((short_name(e["name"]), *iv))
            elif (cat == "user_annotation" and e["name"] != WINDOW_SPAN
                  and e["name"].startswith(SPAN_PREFIXES)):
                iv = clip(e)
                if iv:
                    self.spans.append((e["name"], *iv))
        self.device.sort(key=lambda x: x[1])
        self.spans.sort(key=lambda x: x[1])
        self._busy = self._union()

    def _union(self) -> List[Tuple[float, float]]:
        out: List[List[float]] = []
        for _, a, b in self.device:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    @property
    def busy_s(self) -> float:
        """Seconds of the stretch in which an operation ran on the card."""
        return sum(b - a for a, b in self._busy)

    def kernel_seconds(self, names) -> Tuple[float, int]:
        """(summed seconds, launches) of the kernels whose short name is in
        `names`."""
        names = set(names)
        hits = [b - a for n, a, b in self.device if n in names]
        return sum(hits), len(hits)

    def span_stats(self, name: str) -> Tuple[float, int]:
        """(summed seconds, count) of a harness span."""
        hits = [b - a for n, a, b in self.spans if n == name]
        return sum(hits), len(hits)

    def top_ops(self, n: int = 10) -> List[List]:
        by = defaultdict(float)
        for name, a, b in self.device:
            by[name] += b - a
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def host_span_at(self, t: float) -> str:
        """The innermost harness span the host was in at time t."""
        best: Optional[Tuple[str, float, float]] = None
        for s in self.spans:
            if s[1] > t:
                break
            if s[2] >= t and (best is None or s[1] >= best[1]):
                best = s
        return best[0] if best else "outside harness spans"

    def idle_gaps(self, n: int = 10) -> List[List]:
        """Idle seconds of the card summed by the host span it went idle
        in, the largest first."""
        by = defaultdict(float)
        edges = [(0.0, 0.0)] + self._busy + [(self.window_s, self.window_s)]
        for (_, end), (start, _) in zip(edges[:-1], edges[1:]):
            if start > end:
                by[self.host_span_at(end)] += start - end
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


@contextlib.contextmanager
def traced(holder: Dict):
    """Profile the block, its end synchronised with the card, and put its
    `Trace` into holder["trace"] once the block has ended. The Chrome trace
    is written to a temporary directory and deleted after it is read."""
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    tmp = tempfile.mkdtemp(prefix="bench_trace_")
    try:
        with profile(activities=activities) as prof:
            with record_function(WINDOW_SPAN):
                yield
                if cuda:
                    torch.cuda.synchronize()
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            holder["trace"] = Trace(json.load(f)["traceEvents"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
