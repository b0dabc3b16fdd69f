"""A cell of BENCHMARK.json cut to a size the CPU runs in seconds, for the
harness's CPU tests: the configuration as its reference family's `small`
cuts it (the same widths, a 16x16 scene), short stretches of traffic.

Beside the benchmark's own configurations, the tests hold every family to
a configuration of its own: `INGP_CONFIG`, Instant-NGP at the paper's NeRF
grid through `run_3d_ingp`, run under the `train` mix as the cell
`INGP_CELL` of a copy of BENCHMARK.json (`ingp_bench`), which adds it by new
files and entries alone. Its names are the tests' own, so that no cell of
the benchmark ever shares them, and its CPU limits are passed in
(`INGP_LIMITS`)."""
from __future__ import annotations

import copy
import json
import time
from typing import Optional

import pytest
import torch

from bench_torch import harness

INGP_NAME = "ingp_test"
INGP_CELL = f"{INGP_NAME}.train"
INGP_CONFIG = {
    "entry": "run_3d_ingp",
    "source": "https://arxiv.org/abs/2201.05989 (Instant-NGP: NeRF grid L16 F2 T 2^19, "
              "N_min 16, N_max 2048), as sarphiv/nerf-experiments 3d-ingp/model.py trains it",
    "flags": ["--image_size", "400", "--batch_size", "4096", "--samples_per_ray_coarse", "64",
              "--samples_per_ray_fine", "128", "--n_levels", "16", "--n_features", "2",
              "--table_size", "524288", "--resolution_min", "16", "--resolution_max", "2048",
              "--hidden_dim", "64", "--n_hidden", "2"],
    "precision": "fp32",
    "control": "bf16",
    "model": {"n_levels": 16, "n_features": 2, "table_size": 524288, "resolution_min": 16,
              "resolution_max": 2048, "hidden_dim": 64, "n_hidden": 2, "levels_dir": 4,
              "pos_scale": 8.0, "samples_coarse": 64, "samples_fine": 128, "near": 2.0,
              "far": 8.0,
              "optim": {"lr": 1e-3, "lr_stop": 1e-4, "lr_decay_end": 100000,
                        "adam_b1": 0.9, "adam_b2": 0.99, "adam_eps": 1e-15,
                        "weight_decay": 0.0}},
    "scene": {"generator": "synthetic_fast", "image_size": 400, "train_views": 100,
              "val_views": 1, "test_views": 200, "render_samples": 96},
    "reduced": ["scene"],
}


# the small INGP cell's limits on the CPU (`small_cell`), where the program's
# plain path and the reference agree to float32 rounding. Readings over 12
# seeds: the program 0 / 6.6e-8 / 2.4e-7 at most; the bf16 control 1.9e-5 /
# 9.8e-4 / 4.5e-4 at least; the faults 3.0e-3 / 2.8e-2 / 0.127 at least
INGP_LIMITS = {"loss_gap": 1e-6, "grad_gap": 1e-5, "change_gap": 2e-5}


def ingp_bench(tmp_path) -> dict:
    """A copy of BENCHMARK.json with `INGP_CONFIG` written into `tmp_path`
    and the cell `INGP_CELL` under the `train` mix; the metrics it reports
    are the end-to-end ones of the training cells."""
    bench = copy.deepcopy(harness.benchmark())
    path = tmp_path / f"{INGP_NAME}.json"
    path.write_text(json.dumps(INGP_CONFIG))
    bench["configs"].append({"name": INGP_NAME, "source": INGP_CONFIG["source"],
                             "file": str(path), "reduced": INGP_CONFIG["reduced"],
                             "why": "hash-grid NeRF"})
    bench["workloads"].append({"name": INGP_CELL, "config": INGP_NAME, "traffic": "train",
                               "chips": 1, "why": "closed loop of 4096-ray steps"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "barf_dense_400.train" in m.get("workloads", []):
            m["workloads"].append(INGP_CELL)
    return bench


def family_configs():
    """(family, configuration) of every configuration of BENCHMARK.json and
    of `INGP_CONFIG`, as pytest parameters."""
    configs = [(c["name"], harness.load_json(f"{harness.ROOT}/{c['file']}"))
               for c in harness.benchmark()["configs"]] + [(INGP_NAME, INGP_CONFIG)]
    out = []
    for name, cfg in configs:
        family = harness.family_module(cfg).__name__.rsplit(".", 1)[1]
        out.append(pytest.param(family, cfg, id=f"{family}-{name}"))
    return out


def train_cells():
    """(family, tmp_path -> (cell, bench, limits)) of every training cell
    of BENCHMARK.json and of `INGP_CELL`, as pytest parameters: the
    arguments of `small_cell`."""
    out = []
    for w in harness.benchmark()["workloads"]:
        cell = harness.resolve(w["name"])
        if cell.traffic["kind"] == "train":
            family = harness.family_module(cell.config).__name__.rsplit(".", 1)[1]
            out.append(pytest.param(family, lambda tmp, n=w["name"]: (n, None, None),
                                    id=f"{family}-{w['name']}"))
    out.append(pytest.param("ingp", lambda tmp: (INGP_CELL, ingp_bench(tmp), INGP_LIMITS),
                            id=f"ingp-{INGP_CELL}"))
    return out


def small_cell(name: str, bench: Optional[dict] = None,
               limits: Optional[dict] = None) -> harness.Cell:
    """The cell `name` of `bench` (BENCHMARK.json by default) cut to the
    CPU, with `limits` in place of the cell's own where given."""
    cell = harness.resolve(name, bench)
    if limits is not None:
        cell.limits = dict(limits)
    config = harness.family_module(cell.config).small(cell.config)
    traffic = dict(cell.traffic)
    traffic.update({k: 2 for k in ("warmup_steps", "trace_steps", "trace_views")
                    if k in traffic})
    if "chunk" in traffic:
        traffic["chunk"] = 100
        traffic["check_views"] = 2
    cell.config, cell.traffic = config, traffic
    return cell


def context(cell: harness.Cell, seed: int = 7, seconds: float = 0.5, trace: bool = False,
            fault=None) -> harness.Context:
    return harness.Context(cell=cell, seed=seed, seconds=seconds, trace=trace,
                           device=torch.device("cpu"), t_start=time.perf_counter(), fault=fault)
