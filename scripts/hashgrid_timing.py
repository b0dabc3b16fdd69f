"""Device time of the hash-grid kernels K7 and K8 of the checkout this file
lives in, at run_3d_ingp's grid (3-D, L16 F2 T 2^16, fp32) and its two
launch sizes: K8 without d_x (as `index_add_` does the table gradient alone)
and with d_x, K7, and `index_add_` / `index_select` of the same rows.

To compare two versions of the kernels on one card, copy this file into the
other checkout's `scripts/` and run the two in turns on one card (A, B, B,
A): each builds its own kernels into its own `build/`.

    python3 scripts/hashgrid_timing.py [--points 524288 262144] [--calls 50]

Prints the card's name and power limit, a line per size, and a last line of
JSON. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--points", type=int, nargs="+", default=[524_288, 262_144])
    ap.add_argument("--calls", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("hashgrid_timing: needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from nerf_experiments_tpu_torch.ops import hashgrid

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, f"| checkout {ROOT}", flush=True)
    result = {"checkout": ROOT, "card": smi, "calls": args.calls, "ms": {}}
    for n in args.points:
        cfg, table, x = chip_smoke.hash_inputs(dict(dim=3), n, 70, dev)
        g = torch.randn((n, cfg.output_dim), generator=torch.Generator(dev).manual_seed(71),
                        device=dev)
        F = cfg.n_features
        rows = torch.cat([hashgrid._level_rows_and_offsets(cfg, res, x, "xor")[0].reshape(-1)
                          + l * cfg.table_size for l, res in enumerate(cfg.level_resolutions)])
        flat = table.reshape(-1, F)
        contrib = torch.randn((rows.shape[0], F), generator=torch.Generator(dev).manual_seed(72),
                              device=dev)
        calls = args.calls
        ms = {
            "K8_no_dx": chip_smoke.device_ms(lambda: hashgrid.hash_encode_bwd_cuda(
                table, x, g, cfg, need_dx=False), calls),
            "K8": chip_smoke.device_ms(lambda: hashgrid.hash_encode_bwd_cuda(table, x, g, cfg),
                                       calls),
            "K7": chip_smoke.device_ms(lambda: hashgrid.hash_encode_fwd_cuda(table, x, cfg),
                                       calls),
            "index_add_": chip_smoke.device_ms(
                lambda: torch.zeros_like(flat).index_add_(0, rows, contrib), calls),
            "index_select": chip_smoke.device_ms(lambda: torch.index_select(flat, 0, rows),
                                                 calls),
        }
        result["ms"][str(n)] = ms
        print(f"{n} points: " + ", ".join(f"{k} {v:.5f} ms" for k, v in ms.items()), flush=True)
        del table, x, g, rows, flat, contrib
        torch.cuda.empty_cache()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
