"""Run one cell of the port's benchmark once and print its result line.

    python3 bench_torch/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is a workload of `BENCHMARK.json` at the root of the checkout; its
configuration, traffic, limits and per-layer readers are files under
`bench_torch/` found by name (README.md). The run needs CUDA cards, as many
as the cell asks for; without them it exits with code 3 and prints no
result. The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the end-to-end metrics, or with --trace 1
the per-layer ones), `device`, with --trace 1 `breakdown`, and last `check`,
each number compared with its limit; the same numbers end standard error.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "bench_torch", ".cache")


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # every cache of the program and of torch inside the checkout, at fixed paths
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache"), ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = os.path.join(CACHE, sub)
    sys.path.insert(0, ROOT)
    from bench_torch import harness

    cell = harness.resolve(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"bench_torch: {args.workload} needs {cell.chips} CUDA card(s), found {found}",
              file=sys.stderr)
        return 3
    ctx = harness.Context(cell=cell, seed=args.seed, seconds=args.seconds,
                          trace=bool(args.trace), device=torch.device("cuda", 0),
                          t_start=T_START)
    line = harness.execute(ctx)
    for name, c in line["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
