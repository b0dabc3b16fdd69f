"""A cell of BENCHMARK.json cut to a size the CPU runs in seconds, for the
harness's CPU tests: the same widths, a 16x16 scene of 4 training views, 64
rays a step, 8 fine samples (16 proposal bins), short stretches."""
from __future__ import annotations

import copy
import time

import torch

from bench_torch import harness

SMALL_SCENE = {"image_size": 16, "train_views": 4, "val_views": 1, "test_views": 4}


def _set_flag(flags, name, value):
    flags = list(flags)
    if name in flags:
        flags[flags.index(name) + 1] = value
    else:
        flags += [name, value]
    return flags


def small_cell(name: str) -> harness.Cell:
    cell = harness.resolve(name)
    config = copy.deepcopy(cell.config)
    config["scene"].update(SMALL_SCENE)
    flags = config["flags"]
    for flag, value in (("--image_size", "16"), ("--batch_size", "64"),
                        ("--samples_per_ray", "8")):
        flags = _set_flag(flags, flag, value)
    config["model"]["samples"] = 8
    if "proposal" in config["model"]:
        flags = _set_flag(flags, "--samples_per_ray_proposal", "16")
        config["model"]["proposal"]["samples"] = 16
    config["flags"] = flags
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
