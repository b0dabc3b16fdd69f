"""Hyperparameter-sweep launcher (the LSF `generate_bsub.py` equivalent).

Port of the JAX package's `experiments/sweep.py`, with the same grid parser,
cartesian product and script template, launching the port's entry points.
The reference scales out by generating one `bsub` script per hyperparameter
combination (`barf/generate_bsub.py:99-170`, template
`mip_NeRF/run_experiment.sh:1-17`, kill list `barf/stop_jobs.sh`). Here:
a cartesian-product generator that either (a) writes one shell script per
combination into a sweep directory (for any scheduler — LSF, SLURM, GKE, or
plain xargs), or (b) runs the combinations sequentially in-process.
Each sweep entry is a one-card job like the reference's (the entry points
default to `--device cuda`; pass `--extra "--device cpu"` for a CPU run).

    python -m nerf_experiments_tpu_torch.experiments.sweep \
        --module run_barf --out_dir sweeps/blur \
        --grid start_blur_sigma=0,20,40 camera_origin_noise_sigma=0.0,0.15
"""
from __future__ import annotations

import argparse
import itertools
import os
import shlex
import subprocess
import sys
from typing import Dict, List

SCRIPT_TEMPLATE = """#!/bin/sh
# generated by nerf_experiments_tpu_torch.experiments.sweep
cd {workdir}
{python} -m nerf_experiments_tpu_torch.experiments.{module} {args} --out_dir {out_dir}
"""


def parse_grid(items: List[str]) -> Dict[str, List[str]]:
    grid = {}
    for item in items:
        name, _, values = item.partition("=")
        grid[name] = values.split(",")
    return grid


def combinations(grid: Dict[str, List[str]]):
    """Cartesian product over the grid (generate_bsub `combinations_iterator`)."""
    keys = list(grid)
    for values in itertools.product(*(grid[k] for k in keys)):
        yield dict(zip(keys, values))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--module", required=True, help="experiments module name, e.g. run_barf")
    p.add_argument("--grid", nargs="+", required=True, help="name=v1,v2 ...")
    p.add_argument("--out_dir", default="sweeps/latest")
    p.add_argument("--run", action="store_true", default=False,
                   help="run sequentially instead of generating scripts")
    p.add_argument("--extra", default="", help="extra args passed to every run")
    args = p.parse_args(argv)

    grid = parse_grid(args.grid)
    os.makedirs(args.out_dir, exist_ok=True)
    generated = []
    for i, combo in enumerate(combinations(grid)):
        run_name = "_".join(f"{k}={v}" for k, v in combo.items())
        run_dir = os.path.join(args.out_dir, run_name)
        cli = " ".join(f"--{k} {shlex.quote(v)}" for k, v in combo.items())
        if args.extra:
            cli += " " + args.extra
        if args.run:
            cmd = [sys.executable, "-m", f"nerf_experiments_tpu_torch.experiments.{args.module}"]
            for k, v in combo.items():
                cmd += [f"--{k}", v]
            cmd += shlex.split(args.extra) + ["--out_dir", run_dir]
            print("RUN", " ".join(cmd))
            subprocess.run(cmd, check=True)
        else:
            script = SCRIPT_TEMPLATE.format(
                workdir=os.getcwd(), python=sys.executable,
                module=args.module, args=cli, out_dir=run_dir,
            )
            path = os.path.join(args.out_dir, f"job_{i:03d}_{run_name}.sh")
            with open(path, "w") as f:
                f.write(script)
            os.chmod(path, 0o755)
            generated.append(path)
            print("WROTE", path)
    return generated


if __name__ == "__main__":
    main()
