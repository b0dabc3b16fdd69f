"""The readings the limits of `limits/<cell>.json` are set from, on the
card: the program's numbers over a dozen seeds or more, the control's (the
reference computed at the precision below the configuration's, in the
program's place) and every fault of `faults.py` the cell's kind can have,
each over three seeds or more, all in one process.

    python3 bench_torch/calibrate.py --workload <cell> [--seeds 12]
        [--control-seeds 3] [--fault-seeds 3] [--seconds 1] [--out <file.jsonl>]

One JSON line a reading on standard output (and in --out): what ran
(`program`, `control` or the fault's name), the seed and the numbers. The
benchmark's own runs never run this.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SEED_BASE = 2**31 + 4093  # seeds above 32 signed bits


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--fault-seeds", type=int, default=3)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--first-seed", type=int, default=SEED_BASE)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from bench_torch import faults, harness

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 3
    cell = harness.resolve(args.workload)
    kind = harness.kind_module(cell.traffic["kind"])
    out = open(args.out, "a") if args.out else None

    def emit(what, seed, numbers, extra=None):
        row = dict({"cell": cell.name, "what": what, "seed": seed}, **numbers, **(extra or {}))
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    def ctx(seed, fault=None):
        return harness.Context(cell=cell, seed=seed, seconds=args.seconds, trace=False,
                               device=torch.device("cuda", 0), t_start=time.perf_counter(),
                               fault=fault)

    seeds = [args.first_seed + 7919 * k for k in range(args.seeds)]
    for k, seed in enumerate(seeds):
        c = ctx(seed)
        outcome = kind.run(c)
        emit("program", seed, kind.compare(c, outcome.check),
             {"setup_s": outcome.end_to_end["setup_s"]})
        if k < args.control_seeds:
            emit("control", seed, kind.compare(c, outcome.check, control=cell.config["control"]))
        del outcome
    for name, fault in faults.BY_KIND[cell.traffic["kind"]].items():
        for seed in seeds[:args.fault_seeds]:
            c = ctx(seed, fault)
            outcome = kind.run(c)
            emit(name, seed, kind.compare(c, outcome.check))
            del outcome
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
