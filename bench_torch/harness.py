"""The harness's core: it finds a cell's configuration, traffic, limits and
per-layer metric readers by the names in `BENCHMARK.json`, runs the cell's
kind of traffic (`kinds/<kind>.py`), reads the metrics, decides `correct`
and builds the result line.

A kind module names the function a reference family needs for the kind to
drive its entries, `FAMILY_FUNCTION`, and those entries, `ENTRIES`
(`reference/__init__.py`); it has two functions:
  * `run(ctx) -> Outcome`: set-up, the measured window, the traced stretch
    (with `ctx.trace`) and the program's answers for the check, then the
    program's state freed;
  * `compare(ctx, check, control=None) -> {number: value}`: the plain
    reference on the check's inputs against the program's answers (or, with
    `control`, against the reference computed at that lower precision).
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from typing import Any, Callable, Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict      # the configuration's file
    traffic: dict     # bench_torch/traffic/<mix>.json
    limits: dict      # bench_torch/limits/<cell>.json: number -> limit
    end_to_end: List[dict]
    per_layer: List[dict]


def resolve(name: str, bench: Optional[dict] = None) -> Cell:
    """The cell `name` of BENCHMARK.json with its files read."""
    bench = bench or benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(ROOT, configs[w["config"]]["file"]))
    traffic = load_json(os.path.join(BENCH_DIR, "traffic", f"{w['traffic']}.json"))
    limits_file = os.path.join(BENCH_DIR, "limits", f"{name}.json")
    limits = load_json(limits_file) if os.path.exists(limits_file) else {}
    entries = kind_module(traffic["kind"]).ENTRIES
    if config.get("entry") not in entries:
        raise ValueError(f"{name}: the {traffic['kind']!r} kind drives the entries {entries}, "
                         f"not the configuration's {config.get('entry')!r}")

    def applies(metric, moved=None):
        if "workloads" in metric:
            return name in metric["workloads"]
        return moved is None or moved in reported

    e2e = [m for m in bench["end_to_end"] if applies(m)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if applies(m, m["moves"])]
    return Cell(name, w["chips"], config, traffic, limits, e2e, per_layer)


@dataclasses.dataclass
class Context:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: Any
    t_start: float                      # process start on the host clock
    fault: Optional[Callable] = None    # tests: breaks the timed path underneath


@dataclasses.dataclass
class Outcome:
    end_to_end: Dict[str, float]        # every end-to-end value the kind measured
    attempted: int
    failed: int
    window: Dict[str, float]            # what the window did (seconds, steps, rays ...)
    check: Dict[str, Any]               # the inputs and the program's answers
    trace: Any = None                   # trace.Trace of the traced stretch
    memory_peak_bytes: int = 0


def load_weights(module, weights: Dict[str, "torch.Tensor"]) -> None:
    """Copy the weights into the program's parameters, which must be the
    same leaves."""
    import torch

    own = dict(module.named_parameters())
    if set(own) != set(weights) or any(own[k].shape != weights[k].shape for k in own):
        raise ValueError(
            "the program's parameters are not the reference's leaves: "
            f"{sorted((k, tuple(v.shape)) for k, v in own.items())} against "
            f"{sorted((k, tuple(v.shape)) for k, v in weights.items())}")
    with torch.no_grad():
        for k, p in own.items():
            p.copy_(weights[k])


def metric_reader(name: str):
    path = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"bench_torch_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kind_module(kind: str):
    return importlib.import_module(f"bench_torch.kinds.{kind}")


def families() -> list:
    """Every family module of `reference/`: those that declare `ENTRIES`."""
    names = sorted(f[:-3] for f in os.listdir(os.path.join(BENCH_DIR, "reference"))
                   if f.endswith(".py") and not f.startswith("_"))
    mods = [importlib.import_module(f"bench_torch.reference.{n}") for n in names]
    return [m for m in mods if hasattr(m, "ENTRIES")]


def family_module(config: dict):
    """The one reference family whose `ENTRIES` hold the configuration's
    entry."""
    found = [f for f in families() if config.get("entry") in f.ENTRIES]
    if len(found) != 1:
        raise ValueError(f"{len(found)} reference families model the entry "
                         f"{config.get('entry')!r}: {[f.__name__ for f in found]}")
    return found[0]


def entries_with(function: str) -> tuple:
    """The entries whose family has `function`: those a kind that needs it
    drives."""
    return tuple(e for f in families() if hasattr(f, function) for e in f.ENTRIES)


def entry_module(config: dict):
    """The program's entry the configuration names (`experiments/<entry>.py`)."""
    return importlib.import_module(f"nerf_experiments_tpu_torch.experiments.{config['entry']}")


def device_info(device, count: int, peak: int) -> dict:
    import torch

    if torch.device(device).type != "cuda":  # the harness's CPU tests
        return {"platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": int(peak)}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": int(peak)}


def judge(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, {number: {"value", "limit"}}) over the numbers that have a
    limit; a number that is not finite fails, and so does a cell with no
    limits."""
    check, ok = {}, bool(limits)
    for name, limit in limits.items():
        value = numbers.get(name, float("nan"))
        check[name] = {"value": value, "limit": limit}
        ok = ok and math.isfinite(value) and value <= limit
    return ok, check


def per_layer_values(cell: Cell, ctx: Context, outcome: Outcome) -> Dict[str, dict]:
    out = {}
    for m in cell.per_layer:
        value = metric_reader(m["name"]).read(ctx, outcome)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def execute(ctx: Context) -> dict:
    """Run the cell once and return its result line (a dict)."""
    cell = ctx.cell
    kind = kind_module(cell.traffic["kind"])
    outcome = kind.run(ctx)
    t_check = time.perf_counter()
    numbers = kind.compare(ctx, outcome.check)
    log(f"the reference and the comparison took {time.perf_counter() - t_check:.2f} s")
    correct, check = judge(numbers, cell.limits)
    correct = correct and outcome.failed == 0
    if ctx.trace:
        metrics = per_layer_values(cell, ctx, outcome)
    else:
        metrics = {m["name"]: {"value": outcome.end_to_end[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    device = device_info(ctx.device, cell.chips, outcome.memory_peak_bytes)
    line = {"correct": correct, "attempted": outcome.attempted, "failed": outcome.failed,
            "metrics": metrics, "device": device}
    if ctx.trace and outcome.trace is not None:
        device["busy_s"] = outcome.trace.busy_s
        device["window_s"] = outcome.trace.window_s
        line["breakdown"] = {"device_ops": outcome.trace.top_ops(10),
                             "idle_gaps": outcome.trace.idle_gaps(10)}
    line["check"] = check
    return line


def elapsed(t_start: float) -> float:
    return time.perf_counter() - t_start


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)
