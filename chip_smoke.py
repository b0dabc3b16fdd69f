"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases, each raising on failure:
  1. print the card's name and power limit; build the CUDA kernels from
     `nerf_experiments_tpu_torch/csrc/` with nvcc and print the build time;
  2. hold the compositing kernel against `render.render_full` on the card;
  3. hold the flagship render kernel against `flagship_render_reference` at
     the flagship width (fp32, bf16, fp32 with weights);
  4. run the serving entry point `render_views.main` end to end on a
     generated synthetic scene for the dense flagship config (fp32) and the
     north-star hierarchical config (bf16), check the PSNR is finite, that
     the kernels were launched, and that a crop of the render agrees with the
     plain CPU path;
  5. time kernel and plain paths with CUDA events at the 8192-ray serving
     chunk.

The second-to-last line of stdout is a JSON summary of the kernels; the last
is `{"ok": true, "device": {...}}`. Without a CUDA device it exits non-zero.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

import torch

N_RAYS = 8192  # serving chunk
IMAGE_SIZE = 100
# fp32: kernel and reference differ only in summation order (FMA chains vs
# cuBLAS, warp scan vs cumsum); 1e-4 on values in [0, 1], depth scaled by far.
TOL_FP32 = 1e-4
# bf16: both round every matmul operand to bf16, but the reference also rounds
# each layer's output (density and colour logits included) where the kernel
# keeps them fp32, as the TPU kernel does; 2e-2 on values in [0, 1].
TOL_BF16 = 2e-2
FAR = 8.0


def log(msg: str) -> None:
    print(msg, flush=True)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def cuda_time_ms(fn, iters: int = 5, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def flagship_cfg(bf16: bool, hidden_dim=256, n_hidden=4, n_segments=2):
    from nerf_experiments_tpu_torch.encodings.fourier import Barf
    from nerf_experiments_tpu_torch.models import nerf_mlp

    return nerf_mlp.NerfMLPConfig(
        position_encoder=Barf(levels=10, scale=1.0, include_identity=True),
        direction_encoder=Barf(levels=4, scale=1.0, include_identity=True),
        n_hidden=n_hidden, hidden_dim=hidden_dim, n_segments=n_segments,
        compute_dtype=torch.bfloat16 if bf16 else None,
    )


def random_rays(n: int, gen: torch.Generator, dev):
    """Rays from a sphere of radius 4 towards the unit region around the
    origin, as the synthetic scene's cameras see it."""
    o = torch.randn((n, 3), generator=gen, device=dev)
    o = 4.0 * o / o.norm(dim=-1, keepdim=True)
    target = 0.5 * torch.randn((n, 3), generator=gen, device=dev)
    d = target - o
    return o.contiguous(), (d / d.norm(dim=-1, keepdim=True)).contiguous()


def phase_compositing(dev):
    from nerf_experiments_tpu_torch.ops import render
    from nerf_experiments_tpu_torch.ops.render_cuda import render_full_cuda

    gen = torch.Generator(device=dev).manual_seed(1)
    worst = 0.0
    for s in (64, 128):
        dens = torch.rand((N_RAYS, s), generator=gen, device=dev) * 8.0
        colors = torch.rand((N_RAYS, s, 3), generator=gen, device=dev)
        t = torch.sort(torch.rand((N_RAYS, s + 1), generator=gen, device=dev) * 6.0 + 2.0,
                       dim=-1).values
        ts, te = t[:, :-1].contiguous(), t[:, 1:].contiguous()
        got = render_full_cuda(dens, colors, ts, te)
        ref = render.render_full(dens, colors, ts, te)
        errs = {
            "rgb": max_err(got[0], ref[0]), "opacity": max_err(got[1], ref[1]),
            "depth": max_err(got[2], ref[2]) / FAR,
            "weights": max_err(got[3]["weights"], ref[3]["weights"]),
            "trans": max_err(got[3]["trans"], ref[3]["trans"]),
        }
        log(f"K1 compositing ({N_RAYS}, {s}) fp32 max abs err "
            + json.dumps(errs) + f" (depth / far), tol {TOL_FP32}")
        for k, v in errs.items():
            require(v <= TOL_FP32, f"K1 S={s} {k} err {v} > {TOL_FP32}")
        worst = max(worst, errs["rgb"], errs["weights"])
    return worst


def phase_flagship(dev):
    from nerf_experiments_tpu_torch.models import nerf_mlp
    from nerf_experiments_tpu_torch.ops import sampling
    from nerf_experiments_tpu_torch.ops.train_megakernel import (
        flagship_render, flagship_render_reference)

    gen = torch.Generator(device=dev).manual_seed(2)
    origs, dirs = random_rays(N_RAYS, gen, dev)
    rgb_err_fp32 = 0.0
    for s, bf16, with_w in ((128, False, False), (128, True, False), (32, False, True)):
        cfg = flagship_cfg(bf16)
        params = nerf_mlp.init(torch.Generator().manual_seed(3), cfg).to(dev)
        ts, te = sampling.sample_stratified(None, N_RAYS, s, 2.0, FAR, "equidistant",
                                            device=dev)
        args = (params, cfg, origs, dirs, ts, te, 7.5, 2.5)
        with torch.no_grad():
            got = flagship_render(*args, return_weights=with_w)
            ref = flagship_render_reference(*args, return_weights=with_w)
        torch.cuda.synchronize()
        tol = TOL_BF16 if bf16 else TOL_FP32
        names = ("rgb", "opacity", "depth", "weights")[:len(got)]
        errs = {n: max_err(g, r) / (FAR if n == "depth" else 1.0)
                for n, g, r in zip(names, got, ref)}
        log(f"K2 flagship_render {N_RAYS}x{s} {'bf16' if bf16 else 'fp32'} max abs err "
            + json.dumps(errs) + f" (depth / far), tol {tol}")
        for k, v in errs.items():
            require(v <= tol, f"K2 S={s} bf16={bf16} {k} err {v} > {tol}")
            require(math.isfinite(v), f"K2 {k} not finite")
        if not bf16 and s == 128:
            rgb_err_fp32 = errs["rgb"]
    return rgb_err_fp32


def phase_slice(dev, workdir):
    """render_views end to end for the dense and north-star configs."""
    import numpy as np

    from nerf_experiments_tpu_torch.experiments import render_views, run_barf
    from nerf_experiments_tpu_torch.ops.render_cuda import render_fwd_cuda
    from nerf_experiments_tpu_torch.ops.train_megakernel import flagship_render
    from nerf_experiments_tpu_torch.systems import barf as barf_sys
    from nerf_experiments_tpu_torch.training.checkpoints import CheckpointManager

    configs = {
        "dense": ["--samples_per_ray", "128"],
        "northstar": ["--samples_per_ray", "32", "--samples_per_ray_proposal", "64",
                      "--proposal_hidden_dim", "64", "--proposal_n_hidden", "1", "--bf16"],
    }
    launches, exps = {}, {}
    for name, flags in configs.items():
        common = ["--image_size", str(IMAGE_SIZE), "--seed", "7"] + flags
        exp = run_barf.build(run_barf.parse_args(common), device=dev)
        ckpt = os.path.join(workdir, name, "ckpt")
        CheckpointManager(ckpt).save(1, exp.params)
        argv = ["--ckpt_dir", ckpt, "--split", "test", "--n_images", "2",
                "--chunk", str(N_RAYS), "--device", str(dev),
                "--out_dir", os.path.join(workdir, name)] + common
        render_fwd_cuda.launches = 0
        flagship_render.launches = 0
        summary = render_views.main(argv)
        torch.cuda.synchronize()
        launches[name] = {"flagship_render": flagship_render.launches,
                          "render_fwd": render_fwd_cuda.launches}
        log(f"slice {name}: mean_psnr {summary['mean_psnr']} launches {launches[name]}")
        require(math.isfinite(summary["mean_psnr"]), f"{name}: mean_psnr not finite")
        require(flagship_render.launches > 0, f"{name}: flagship_render never launched")
        if name == "northstar":
            require(render_fwd_cuda.launches > 0, "northstar: compositing never launched")

        # a crop of view 0 through the kernels vs the plain path on the CPU
        dm = exp.dm
        dm.setup("test")
        ds = dm.dataset_test
        params = CheckpointManager(ckpt).restore(exp.params)
        raw = torch.as_tensor(dm.dataset_train.camera_origins)
        noisy = torch.as_tensor(dm.dataset_train.camera_origins_noisy)
        lo, hi = IMAGE_SIZE * IMAGE_SIZE // 2, IMAGE_SIZE * IMAGE_SIZE // 2 + 512
        args = (ds.ray_origins[0][lo:hi], ds.ray_directions[0][lo:hi])
        a_pos = float(exp.cfg.radiance.position_encoder.levels)
        with torch.no_grad():
            gauge_dev = barf_sys.val_gauge(params, raw.to(dev), noisy.to(dev))
            cpu_params = params.to("cpu")
            gauge_cpu = barf_sys.val_gauge(cpu_params, raw, noisy)
            plain = render_views.render_image(cpu_params, exp.cfg, *args, gauge_cpu,
                                              float(ds.pixel_width), 512, "cpu", a_pos, 4.0)
            params.to(dev)
            kern = render_views.render_image(params, exp.cfg, *args, gauge_dev,
                                             float(ds.pixel_width), 512, dev, a_pos, 4.0)
        tol = TOL_BF16 if "--bf16" in flags else TOL_FP32
        err = float(np.abs(kern - plain).max())
        log(f"slice {name}: 512-ray crop, kernel path vs plain CPU path "
            f"max abs err {err}, tol {tol}")
        require(err <= tol, f"{name}: crop err {err} > {tol}")
        exps[name] = exp
    return launches, exps


def plain_forward(params, cfg, origs, dirs, pw):
    """The serving forward with every step in plain PyTorch (no kernel)."""
    from nerf_experiments_tpu_torch.ops import render, sampling
    from nerf_experiments_tpu_torch.ops.train_megakernel import flagship_render_reference
    from nerf_experiments_tpu_torch.systems import barf as barf_sys

    n = origs.shape[0]
    a_pos = float(cfg.radiance.position_encoder.levels)
    if cfg.use_proposal:
        ts, te = sampling.sample_stratified(None, n, cfg.samples_per_ray_proposal, cfg.near,
                                            cfg.far, "equidistant", device=origs.device)
        dens, rgb = barf_sys._eval_model(barf_sys._proposal_model(params, cfg), origs, dirs,
                                         ts, te, pw, a_pos, 4.0, "middle")
        _, w = render.render_rays(dens, rgb, te - ts)
        ts, te = sampling.sample_pdf_weighted_intervals(ts, te, w, cfg.samples_per_ray_radiance,
                                                        cfg.far)
    else:
        ts, te = sampling.sample_stratified(None, n, cfg.samples_per_ray_radiance, cfg.near,
                                            cfg.far, "equidistant", device=origs.device)
    return flagship_render_reference(params.radiance, cfg.radiance, origs, dirs, ts, te,
                                     a_pos, 4.0)[0]


def phase_timing(dev, exps):
    from nerf_experiments_tpu_torch.models import nerf_mlp
    from nerf_experiments_tpu_torch.ops import render, sampling
    from nerf_experiments_tpu_torch.ops.render_cuda import render_full_cuda
    from nerf_experiments_tpu_torch.ops.train_megakernel import (
        flagship_render, flagship_render_reference)
    from nerf_experiments_tpu_torch.systems import barf as barf_sys

    gen = torch.Generator(device=dev).manual_seed(4)
    times = {}
    # K1 at the north-star coarse shape (S = 64) and S = 128
    for s in (64, 128):
        dens = torch.rand((N_RAYS, s), generator=gen, device=dev) * 8.0
        colors = torch.rand((N_RAYS, s, 3), generator=gen, device=dev)
        ts, te = sampling.sample_stratified(None, N_RAYS, s, 2.0, FAR, "equidistant", device=dev)
        k = cuda_time_ms(lambda: render_full_cuda(dens, colors, ts, te), iters=20)
        p = cuda_time_ms(lambda: render.render_full(dens, colors, ts, te), iters=20)
        times[f"K1_S{s}"] = (k, p)
        log(f"time K1 compositing {N_RAYS}x{s} fp32: kernel {k:.4f} ms, plain {p:.4f} ms")
    # K2 at the slice's fine shapes
    origs, dirs = random_rays(N_RAYS, gen, dev)
    with torch.no_grad():
        for s, bf16 in ((128, False), (128, True), (32, False), (32, True)):
            cfg = flagship_cfg(bf16)
            params = nerf_mlp.init(torch.Generator().manual_seed(3), cfg).to(dev)
            ts, te = sampling.sample_stratified(None, N_RAYS, s, 2.0, FAR, "equidistant",
                                                device=dev)
            args = (params, cfg, origs, dirs, ts, te, 10.0, 4.0)
            k = cuda_time_ms(lambda: flagship_render(*args))
            p = cuda_time_ms(lambda: flagship_render_reference(*args))
            tag = f"K2_S{s}_{'bf16' if bf16 else 'fp32'}"
            times[tag] = (k, p)
            log(f"time K2 flagship_render {N_RAYS}x{s} {'bf16' if bf16 else 'fp32'}: "
                f"kernel {k:.4f} ms, plain {p:.4f} ms")
        # the serving forward at one chunk, kernels vs plain
        pw = torch.full((N_RAYS, 1), 1e-3, device=dev)
        for name, exp in exps.items():
            k = cuda_time_ms(lambda: barf_sys.forward(
                exp.params, exp.cfg, None, origs, dirs, pw, 10.0, 4.0, stratified=False,
                fused=True))
            p = cuda_time_ms(lambda: plain_forward(exp.params, exp.cfg, origs, dirs, pw))
            times[f"serve_{name}"] = (k, p)
            log(f"serving forward {name} ({N_RAYS} rays): kernel path {k:.4f} ms = "
                f"{N_RAYS / k * 1e3:.0f} rays/s; plain path {p:.4f} ms = "
                f"{N_RAYS / p * 1e3:.0f} rays/s")
    return times


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 1
    from nerf_experiments_tpu_torch.ops import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    log(smi.stdout.strip())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    built = cuda_build.build()
    cuda_build.library()
    log(f"kernels built in {time.perf_counter() - t0:.2f} s (nvcc {built.seconds:.2f} s) "
        f"-> {built.path.name}")
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log("  ptxas: " + line.strip())

    k1_err = phase_compositing(dev)
    k2_err = phase_flagship(dev)
    with tempfile.TemporaryDirectory() as workdir:
        launches, exps = phase_slice(dev, workdir)
        times = phase_timing(dev, exps)

    kernels = {"kernels": [
        {"name": "render_fwd", "route": "cuda",
         "source": "nerf_experiments_tpu_torch/csrc/render.cu",
         "replaces": "nerf_experiments_tpu/ops/render_pallas.py:55",
         "launches": launches["northstar"]["render_fwd"], "max_abs_err": k1_err,
         "ms": times["K1_S64"][0], "plain_ms": times["K1_S64"][1]},
        {"name": "flagship_render", "route": "cuda",
         "source": "nerf_experiments_tpu_torch/csrc/flagship_render.cu",
         "replaces": "nerf_experiments_tpu/ops/train_megakernel.py:415",
         "launches": launches["dense"]["flagship_render"]
         + launches["northstar"]["flagship_render"], "max_abs_err": k2_err,
         "ms": times["K2_S128_fp32"][0], "plain_ms": times["K2_S128_fp32"][1]},
    ]}
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
