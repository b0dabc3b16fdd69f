"""Times of the fused MLP chain's kernels K9 (forward) and K10 (backward) of
the checkout this file lives in, on run_mip_nerf's three chains at one
step's 262,144 rows (fp32 and bf16, summed over the chains), beside the
cuBLAS `addmm` chain, and the Mip-NeRF train step at 1024 rays with
`FusedNerfMLPDef`. Each kernel is called as a caller that has no packed
weights calls it, so a call's weight preparation is part of its time.

To compare two versions on one card, copy this file into the other
checkout's `scripts/` and run the two in turns (A, B, B, A): each builds its
own kernels into its own `build/`.

    python3 scripts/fused_mlp_timing.py [--iters 5]

Prints the card's name and power limit, a line per dtype, and a last line
of JSON. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fused_mlp_timing: needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from nerf_experiments_tpu_torch.models import nerf_mlp
    from nerf_experiments_tpu_torch.ops import fused_mlp as fm
    from nerf_experiments_tpu_torch.systems import barf as barf_sys

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, f"| checkout {ROOT}", flush=True)
    result = {"checkout": ROOT, "card": smi, "ms": {}}
    cfg, dm = chip_smoke.mip_config()
    params = nerf_mlp.init(torch.Generator().manual_seed(20), cfg.radiance).to(dev)
    time = lambda fn: chip_smoke.cuda_time_ms(fn, iters=args.iters)
    for bf16 in (False, True):
        tag = "bf16" if bf16 else "fp32"
        lib_dtype = torch.bfloat16 if bf16 else torch.float32
        ms = dict.fromkeys(("K9", "K10", "cuBLAS_fwd"), 0.0)
        for _, layers in chip_smoke.chain_layers(params):
            x, g = chip_smoke.chain_inputs(layers, chip_smoke.MIP_ROWS, 22, dev)
            lw = [l.w.detach().to(lib_dtype) for l in layers]
            lb = [l.b.detach().to(lib_dtype) for l in layers]
            xl = x.to(lib_dtype)
            with torch.no_grad():
                ms["K9"] += time(lambda: fm.fused_mlp_fwd_cuda(x, layers, bf16))
                ms["cuBLAS_fwd"] += time(lambda: chip_smoke.library_chain(xl, lw, lb))
            ms["K10"] += time(lambda: fm.fused_mlp_bwd_cuda(x, layers, g, bf16))
            del x, g, xl
            torch.cuda.empty_cache()
        cfgs = {fused: chip_smoke.mip_config(bf16, fused)[0] for fused in (False, True)}
        bparams = barf_sys.init(torch.Generator().manual_seed(45), cfgs[False]).to(dev)
        batch = chip_smoke.mip_batch(dm, chip_smoke.MIP_RAYS, 44, dev)
        for fused in (True, False):
            state = barf_sys.init_state(cfgs[fused], copy.deepcopy(bparams))
            step = barf_sys.make_train_step(cfgs[fused])
            gen = lambda: torch.Generator(device=dev).manual_seed(46)
            ms["step_fused" if fused else "step_plain"] = chip_smoke.cuda_time_ms(
                lambda: step(state, batch, gen(), 0.0, 0.0, 0.0), iters=3, warmup=1)
            del state
            torch.cuda.empty_cache()
        result["ms"][tag] = ms
        print(f"{tag}: " + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items())
              + f"; fused step {chip_smoke.MIP_RAYS / ms['step_fused'] * 1e3:.0f} rays/s, "
              f"plain {chip_smoke.MIP_RAYS / ms['step_plain'] * 1e3:.0f}", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
