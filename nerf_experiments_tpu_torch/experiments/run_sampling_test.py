"""Sampling / integration-strategy ablation grid (experiment-as-test).

Parity with `barf/run_sampling_test.py:17-115` and the JAX package's
`run_sampling_test`: the BARF pipeline over {stratified_uniform,
equidistant} sampling x {left, middle} integration x offset sizes (the
stratified comb is never offset), one run a cell in turn, each cell's final
train PSNR printed and written to <out_dir>/summary.json. A cell's config
changes only the train step; validation keeps run_barf's sampler, as in the
JAX package (the grid reads the train PSNR).
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import os

import numpy as np

from nerf_experiments_tpu_torch.experiments import common, run_barf
from nerf_experiments_tpu_torch.systems import barf as barf_sys


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--strategies", nargs="+", default=["stratified_uniform", "equidistant"])
    p.add_argument("--integrations", nargs="+", default=["left", "middle"])
    p.add_argument("--offsets", nargs="+", type=float, default=[0.0, -1.0])
    p.add_argument("--steps_per_cell", type=int, default=500)
    p.add_argument("--hidden_dim", type=int, default=256)
    p.add_argument("--n_hidden", type=int, default=4)
    p.add_argument("--use_proposal", action="store_true", default=False)
    common.add_common_args(p)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    common.refuse_mesh(args, "run_sampling_test")
    results = []
    for strategy, integration, offset in itertools.product(
            args.strategies, args.integrations, args.offsets):
        if strategy == "stratified_uniform" and offset != 0.0:
            continue  # the reference offsets only the equidistant comb
        cell = f"{strategy}_{integration}_off{offset}"
        out_dir = os.path.join(args.out_dir, cell)
        barf_args = run_barf.parse_args([
            "--scene_path", args.scene_path,
            "--image_size", str(args.image_size),
            "--batch_size", str(args.batch_size),
            "--max_steps", str(args.steps_per_cell),
            "--camera_origin_noise_sigma", "0.0",
            "--camera_rotation_noise_sigma", "0.0",
            "--no-optimize_camera",
            "--checkpoint_every_n_epochs", "0",
            "--alpha_decay_start_step", "0", "--alpha_decay_end_step", "1",
            "--hidden_dim", str(args.hidden_dim), "--n_hidden", str(args.n_hidden),
            "--samples_per_ray_proposal", "32" if args.use_proposal else "0",
            "--out_dir", out_dir,
            "--seed", str(args.seed),
            "--device", args.device,
        ] + (["--bf16"] if args.bf16 else []))
        exp = run_barf.build(barf_args)
        exp.cfg = dataclasses.replace(
            exp.cfg,
            uniform_sampling_strategy=strategy,
            integration_strategy=integration,
            uniform_sampling_offset_size=offset,
        )
        # the optimizer's groups do not depend on the sampler: only the step changes
        exp.trainer.step_fn = barf_sys.make_train_step(exp.cfg)
        exp.fit()
        with open(os.path.join(out_dir, "metrics.jsonl")) as f:
            metrics = [json.loads(line) for line in f]
        psnrs = [m["psnr"] for m in metrics if "psnr" in m and np.isfinite(m["psnr"])]
        results.append({"cell": cell, "final_psnr": psnrs[-1] if psnrs else None})
        print(json.dumps(results[-1]))

    with open(os.path.join(args.out_dir, "summary.json"), "w") as f:
        json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
