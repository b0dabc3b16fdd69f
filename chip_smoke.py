"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases, each raising on failure:
  1. print the card's name and power limit; build the CUDA kernels from
     `nerf_experiments_tpu_torch/csrc/` with nvcc and print the build time;
  2. hold the compositing kernel against `render.render_full` on the card at
     S = 64, 128 (BARF) and 192 (GARF validation);
  3. hold the bf16 linear's CUDA path (one tensor-core GEMM returning fp32)
     against the CPU path's rounded-fp32 product, forward and gradients; hold
     the flagship render kernel (K2) against `flagship_render_reference` at
     the flagship width, fp32 and bf16, at S = 128, 32 and a ragged 100, with
     ray counts that are no multiple of the kernel's ray packing (64 / S rays
     a block), with and without the weights; then at hidden widths 48 and
     100 (colour 24 and 50: padded to 16 inside), 512 (fp32 on 32-row tiles)
     and 1024 (bf16 on 32-row tiles);
  4. run the serving entry point `render_views.main` end to end on a
     generated synthetic scene for the dense flagship config (fp32) and the
     north-star hierarchical config (bf16), check the PSNR is finite, that
     the kernels were launched (K2; north-star also the proposal kernel),
     and that a crop of the render agrees with the plain CPU path;
  5. time kernel and plain paths at the 8192-ray serving chunk: the
     compositing kernel by its `torch.profiler` device time per call on
     inputs rotated past the L2 (`cold_copies`), the rest with CUDA events;
  6. hold the compositing backward kernel against `render_bwd_reference`;
  7. hold the flagship train kernel (K4) against
     `flagship_train_grads_reference` at the flagship width (1024 x 128 fp32
     and bf16; 1024 x 32 fp32 with loss_scale and weights; 8192 x 32 bf16, the
     north-star training shape; 1023 x 32 and 333 x 100, fp32 and bf16; then
     hidden 48 and 100, and 512 on 32-row tiles): rgb, geometry gradients,
     weights and every dW/db, and two launches bitwise equal; each setting's
     route (`train_route`) and its launches counted, both compute types
     launched, the flagship width in fp32 on the 64-row tile, and fp32
     hidden 632, wider than a tile, refused;
  8. one train step, `train_step_fused` against `train_step`, from the same
     state, batch and generator seed (dense fp32, north-star bf16): the
     loss, every gradient handed to Adam, and the update;
  9. the training entry point `run_barf.main --fused_kernel` end to end: the
     dense flagship at 32^2 (the logged train PSNR must rise by > 1 dB and
     end above 10 dB; every K4 launch on the fp32 tile), the north-star
     config at 100^2 with the kernel launches counted (every K4 launch on
     the bf16 tile), `--resume`, and `render_views` on the checkpoint;
     then `run_barf` at hidden 100 (fused, bf16) and 512 (plain step, fp32),
     each logging images through K2;
 10. time the train step (fused against plain) and the kernels alone at
     8192 rays (the compositing backward by its `torch.profiler` device
     time per call on inputs rotated past the L2; K4 fp32 also at 1024 rays,
     with its kernels' device ms), profile one fused step of each config, and
     time K4's weight packing (host and device) in bf16;
 11. hold the GARF render kernel (K6, tensor cores: bf16, or 3xTF32 in
     fp32) against `garf_radiance_render_reference` for gauss, gabor and
     sarf, fp32 and bf16, gamma 1 and 0.37, at 1024 rays x 192 samples and a
     ragged 50;
 12. hold the GARF train kernel (K5) against
     `garf_radiance_train_grads_reference` for the same settings at 1024 x
     192 and 256 x 50: rgb, weights, geometry gradients and every dW / db /
     d(activation parameter) by relative norm, two launches bitwise equal;
     in bf16 also print how far the kernel and the plain version each are
     from the plain version in fp32 (the size of bf16's own error);
 13. one GARF step, `train_step_fused` against `train_step` from the same
     state, batch and generator seed (gauss fp32, gabor bf16);
 14. `garf_main.main --fused_kernel` end to end on a generated 32^2 scene
     (gauss fp32: the train PSNR must rise by > 1 dB; `--resume`; short
     gabor bf16 and sarf runs), with K5, K6 and K1 launches counted;
 15. time K5 (4096 x 192) and K6 (8192 x 192) against their plain versions,
     the GARF train step fused against plain at 4096 rays, the proposal
     stage, profile one fused GARF step (K5's phase A against phase B), and
     time the GARF weight packing a step (host and device) and the render
     wrapper's cached weights;
 16. hold the hash-grid forward kernel (K7) against `encode_reference`: 3-D
     at run_3d_ingp's defaults and 524,288 points, 2-D at run_2d_ingp's, F =
     8 at 4 levels; xor and additive hash, fp32 and bf16 rows; N(0, 1)
     tables, points on grid vertices and at 0; relative norm 1e-5;
 17. hold the hash-grid backward kernel (K8) against
     the plain backward (autograd through `encode_reference`) for the same
     settings (d_table, d_x by relative norm 1e-5); d_table bitwise equal over
     two launches (with and without d_x) and to
     `dtable_fixed_point_reference` (K8's int64 fixed point emulated in torch);
 18. one INGP train step through K7 / K8 against the same step with the
     plain encoding (fp32, bf16): the loss and every gradient handed to Adam;
 19. the INGP entry points end to end with K7, K8, K1 and K3 counted:
     `run_3d_ingp.main` at full width on a generated 64^2 scene (300 steps
     fp32 with checkpoints: the train PSNR must rise by > 1 dB; 20 steps
     bf16), `render_views --entry ingp` on the checkpoint (a crop against the
     plain CPU path), `run_2d_ingp.main` at its defaults (val PSNR > 12 dB);
 20. time K7 / K8 at 524,288 and 262,144 points (K8 without d_x, the table
     gradient alone, and with d_x, as the INGP step launches it: its camera
     parameters require grad) against their plain versions, the library
     calls of their table access (`index_select`, `index_add_`) and their
     bounds; the INGP train step with kernels against the plain encoding at
     4096 rays, and profile one step (K7 / K8 device ms, idle share);
 21. hold the fused MLP chain's forward (K9) and backward (K10) against
     `fused_chain_reference` and autograd through it: run_mip_nerf's three
     chains and a one-layer chain at one step's 262,144 rows and the ragged
     40,037 and 1,000, fp32 and bf16, y, dx and every dW / db by relative
     norm, two K10 launches bitwise equal; in fp32 also, as a diagnostic, the
     plain chain's own error against float64 and the ReLU flips between
     K10's recomputed forward and the plain one;
 22. hold K11 (`render_megakernel.flagship_render`: equidistant bins with
     per-ray offsets through K2's kernel) against its plain version at 8192
     x 128 fp32 and bf16 and a ragged 37 rays, and its config refusal;
 23. one Mip-NeRF train step with `FusedNerfMLPDef` (K9 / K10) against the
     same step with `NerfMLPDef` (fp32, bf16): the loss and every gradient;
 24. the Mip / BIP entry points end to end on a generated 32^2 scene with
     K9, K10, K11, K1 and K3 counted: `run_mip_nerf.main` at full width (the
     train PSNR must rise by > 1 dB; `--resume`), `run_bip_barf.main`,
     `render_views --entry mip|bip` (crops against the plain CPU path), the
     `FusedNerfMLPDef` config through `build_barf_experiment` and the
     trainer, a few steps of each thin entry point, and phase 9's BARF
     checkpoint served through K11;
 25. time K9 / K10 at 262,144 rows (weights packed once, as `FusedChain`
     hands them) against their plain versions and the cuBLAS `addmm` chain
     and their bounds (3xTF32 too), K11 against its plain version and K2 at 8192 x
     128, the Mip-NeRF step with `FusedNerfMLPDef` against `NerfMLPDef`, and
     profile one step of each;
 26. the occupancy grid at full width (north_star_occ_S32: R 64, 64 coarse
     bins, 32 fine samples, batch 8192): its fused step (K4) against the
     plain step at 1024 rays (as phase 8), bf16 and fp32, step 0 refreshing
     the grid after the update; the
     refresh against a float64 refresh with the same jitter;
     `run_barf --occ_grid_resolution 64 --fused_kernel` (train PSNR rises by
     > 1 dB in 48 steps; 32 steps + `--resume` bitwise equal to 48 in one go,
     under torch's deterministic algorithms; the grid in the checkpoint);
     `render_views --serve_block 1 | 4` on its checkpoint through K2, and a
     serve_block 4 crop against the plain CPU path;
 27. block-coarse BARF: the north_star_S32_blk4 (K1 / K3 on every 4th ray)
     and north_star_occ_S32_blk4 fused steps, bf16 and fp32, against the same
     steps with every kernel's plain version (`plain_kernels`);
     `render_block_coarse` with block 1 bitwise equal to the deterministic
     `forward` (kernels on) and with block 4 against its plain version (the
     proposal kernel's included);
     `run_barf --train_coarse_block 4` trains and resumes;
 28. block-coarse GARF (garf_fused_blk4): the fused step with
     train_coarse_block 4 against its plain-kernel version (gauss fp32, gabor
     bf16); `garf_main --train_coarse_block 4` trains;
 29. train rays/s of each slice config against its counterpart (A, B, B, A;
     a 16-step window with one refresh for BARF at 8192 rays, 4 steps for
     GARF at 4096), the refresh alone and its share of the window, a profile
     of the occupancy steps (idle share), serving rays/s at 8192-ray chunks
     with serve_block 1 and 4;
 30. the target blur (`ops/image_blur.py`) against its float64 plain version
     at 100^2 and 32^2 with 81 taps (the folded reflect), and one re-blur of
     a 100 x 400^2 x 3 stack timed against its bounds;
 31. `garf_main --activation gabor --bf16 --fused_kernel --conv_blur` at
     100^2 with K5, K6, K1 and K3 counted: the targets swap as sigma decays,
     a `--resume` lands on the uninterrupted run's targets bit for bit, and
     the train rays/s stay within 2 % of the run without --conv_blur (A, B,
     B, A);
 32. SIREN at run_nerf_siren's defaults, fp32 and bf16: one plain step
     against the same step with K1 / K3 replaced by their plain versions
     (fine bins pinned), the step's K1 / K3 launches, `run_nerf_siren` at
     100^2 (validation PSNR on fixed rays rises over 100 steps), train rays/s
     at 1024 and 4096 rays;
 33. `run_2d_reconstruction` at its defaults: validation PSNR above 15 dB,
     steps/s;
 34. the scene generator (`data/synthetic_fast.py`): `validate` on the card,
     one 400^2 view at 128 samples, a 12-view 100^2 `generate_dataset` whose
     poses are byte for byte the numpy path's;
 35. `utils/profiling.trace` around two SIREN steps names the K1 / K3
     launches; `data/native.available()`;
 36. the mesh (`parallel/`), two ranks sharing cuda:0 over gloo
     (`parallel/launch.py:run_ranks`; the ranks load the library phase 1
     built and fail if they would build it again): two data-parallel fused
     steps (K4 on each rank's 4096 rays) of the north-star (bf16) and the
     dense flagship (fp32), and two plain steps (K1 / K3) of the dense
     flagship on stratified bins, each against the same steps in this
     process on the same 8192-ray global batch (phase 8's tolerances: loss,
     update of every parameter; the ranks' parameters bitwise equal);
     the plain step again on a 1 x 2 model axis (each rank updating half
     the columns of the 256-wide leaves) against the same reference;
     `sharded_render` of 8191 rays through K2 against the whole render; the
     fused north-star step timed on both ranks (two ranks sharing one card:
     not a scaling figure);
 37. one NCCL rank through the entry points: `run_barf.main --mesh auto
     --fused_kernel` (north-star, 32^2, 24 steps, K4 counted) bitwise equal
     to the run without --mesh (rows and parameters, under torch's
     deterministic algorithms), the same run under `torchrun --standalone
     --nproc_per_node=1`, and the fused north-star step at 8192 rays with
     and without a one-rank mesh (A, B, B, A) beside its two all-reduces
     alone (`sync_grads`, `sync_metrics`);
 38. hold the serving proposal kernel (`ops/proposal_bins.py`) against its
     plain version (the eager stage: cuBLAS GEMMs, K1, the PDF resample) at
     the north-star chunk, 8192 rays x 64 bins -> 32, every level on and
     fractional alphas: the coarse rgb and the fine bins; time both (the
     kernel by its `torch.profiler` device time per call, the plain stage
     with CUDA events) beside the kernel's bound.

Each phase prints its wall time. The second-to-last line of stdout is a JSON
summary of the kernels (`max_abs_err` is the largest absolute difference
from the plain version over the outputs of that kernel's fp32 checks;
`bound_ms` the least time the card could take for the timed call, from its
shapes, `kernel_bounds`; `library_ms` the one PyTorch call that does the same
work, or null); the last is `{"ok": true, "device": {...}}`. Without a CUDA
device it exits non-zero.
"""
from __future__ import annotations

import contextlib
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
# The bf16 linear on CUDA against the CPU path's product of the rounded
# operands in fp32: the same products summed in another order, both outputs
# rounded to bf16, so one bf16 ulp (2^-8 relative) apart at most; held by
# relative norm under TOL_BF16.
# K3: max abs error over the reference's max abs value (random cotangents;
# the suffix sums are a scan here and a cumsum there).
TOL_K3 = 1e-4
# K4: relative norm ||a - b|| / ||b|| of every output and every dW/db. fp32:
# summation order only (split-K rows, per-ray sums vs cuBLAS); bf16: both
# round matmul operands to bf16, the reference also rounds each layer's
# output and its cotangent where the kernel keeps fp32.
TOL_K4_FP32 = 1e-4
TOL_K4_BF16 = 5e-2
# One train step, fused against plain: the loss (relative), and the Adam
# update of every parameter by relative norm. Adam divides each gradient by
# its own magnitude, so a gradient element near zero can flip the sign of its
# update; the norm over all parameters stays small when the gradients agree.
TOL_STEP_LOSS = {False: 1e-5, True: 1e-2}
TOL_STEP_UPDATE = {False: 1e-2, True: 2e-1}
# ... and every gradient handed to Adam, by relative norm, as K4's outputs.
TOL_STEP_GRAD = {False: TOL_K4_FP32, True: TOL_K4_BF16}
FAR = 8.0
NORTHSTAR = ["--samples_per_ray", "32", "--samples_per_ray_proposal", "64",
             "--proposal_hidden_dim", "64", "--proposal_n_hidden", "1", "--bf16"]


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


def device_ms(fn, calls: int = 200, arg_sets=((),)) -> float:
    """Device time per call: the self time of every CUDA event (kernels,
    copies, fills) that `torch.profiler` records over `calls` back-to-back
    calls, divided by `calls`. For kernels whose launch costs more host time
    than they run, where CUDA events would time the host. Call i is
    `fn(*arg_sets[i % len(arg_sets)])`: with the sets of `cold_copies`, each
    call reads its inputs from HBM, not from the L2 an earlier call filled."""
    from torch.profiler import ProfilerActivity, profile

    for i in range(10):
        fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(calls):
            fn(*arg_sets[i % len(arg_sets)])
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type.name == "CUDA")
    require(total_us > 0, "torch.profiler recorded no device time")
    return total_us / 1e3 / calls


L2_BYTES = 50 * 2**20  # the H100's L2 cache


def cold_copies(*args) -> list:
    """`args` and copies of it (tensors cloned, the rest shared) that hold
    four times the L2 together: timed in turn by `device_ms`, every call's
    inputs come from HBM, as the bytes bound of `kernel_bounds` assumes."""
    n_bytes = sum(a.numel() * a.element_size() for a in args if torch.is_tensor(a))
    copies = max(1, math.ceil(4 * L2_BYTES / n_bytes))
    return [args] + [tuple(a.clone() if torch.is_tensor(a) else a for a in args)
                     for _ in range(copies - 1)]


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
    for s in (64, 128, 192):  # BARF's coarse and fine counts; GARF's validation
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
        worst = max(worst, *errs.values(), errs["depth"] * FAR)
    return worst


def check_bf16_linear(dev):
    """`linear_apply` in bf16 on CUDA (one tensor-core GEMM returning fp32)
    against the CPU path's product of the rounded operands in fp32, forward
    and the gradients of x, W and b, at a flagship layer's shape."""
    from nerf_experiments_tpu_torch.models import common

    gen = torch.Generator(device=dev).manual_seed(21)
    layer = common.linear_init(torch.Generator().manual_seed(22), 319, 256).to(dev)
    x = torch.randn((8192, 319), generator=gen, device=dev).requires_grad_(True)
    g = torch.randn((8192, 256), generator=gen, device=dev).bfloat16()
    y = common.linear_apply(layer, x, torch.bfloat16)
    got = (y, *torch.autograd.grad(y, (x, layer.w, layer.b), g))
    # the CPU path's arithmetic, on the card
    y = (x.bfloat16().float() @ layer.w.bfloat16().float() + layer.b).bfloat16()
    want = (y, *torch.autograd.grad(y, (x, layer.w, layer.b), g))
    errs = {n: rel_norm(a.float(), b.float()) for n, a, b in zip(("y", "dx", "dW", "db"),
                                                                 got, want)}
    log("bf16 linear on CUDA vs the rounded-fp32 product, rel norm "
        + json.dumps(errs) + f", tol {TOL_BF16}")
    require(got[0].dtype == torch.bfloat16, "bf16 linear: output not bf16")
    for k, v in errs.items():
        require(v <= TOL_BF16, f"bf16 linear {k} err {v} > {TOL_BF16}")


def phase_flagship(dev):
    from nerf_experiments_tpu_torch.models import nerf_mlp
    from nerf_experiments_tpu_torch.ops import sampling
    from nerf_experiments_tpu_torch.ops.train_megakernel import (
        flagship_render, flagship_render_reference, tile_rows)

    check_bf16_linear(dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    worst_abs_fp32 = 0.0
    # S = 32 packs 2 rays a block, S = 100 takes one ray in two tiles (64 +
    # 36 rows): the odd ray counts leave a block with fewer rays. Then other
    # hidden widths: 48 and 100 (colour 24 and 50, padded to 16 inside), 512
    # (fp32 on 32-row tiles) and 1024 (bf16 on 32-row tiles).
    for n, s, bf16, with_w, hidden in (
            (N_RAYS, 128, False, False, 256), (N_RAYS, 128, True, False, 256),
            (N_RAYS - 1, 32, False, True, 256), (N_RAYS - 1, 32, True, False, 256),
            (1001, 100, False, True, 256), (1001, 100, True, True, 256),
            (257, 100, False, True, 48), (257, 32, True, True, 48),
            (333, 32, False, False, 100), (333, 100, True, False, 100),
            (1001, 100, False, True, 512), (1001, 32, True, False, 512),
            (129, 100, True, True, 1024)):
        origs, dirs = random_rays(n, gen, dev)
        cfg = flagship_cfg(bf16, hidden_dim=hidden)
        params = nerf_mlp.init(torch.Generator().manual_seed(3), cfg).to(dev)
        ts, te = sampling.sample_stratified(None, n, s, 2.0, FAR, "equidistant", device=dev)
        args = (params, cfg, origs, dirs, ts, te, 7.5, 2.5)
        with torch.no_grad():
            got = flagship_render(*args, return_weights=with_w)
            ref = flagship_render_reference(*args, return_weights=with_w)
        torch.cuda.synchronize()
        tol = TOL_BF16 if bf16 else TOL_FP32
        names = ("rgb", "opacity", "depth", "weights")[:len(got)]
        errs = {n: max_err(g, r) / (FAR if n == "depth" else 1.0)
                for n, g, r in zip(names, got, ref)}
        rows = tile_rows(cfg, hidden, hidden // 2)
        log(f"K2 flagship_render {n}x{s} {'bf16' if bf16 else 'fp32'} hidden {hidden} "
            f"({rows}-row tiles) max abs err " + json.dumps(errs) + f" (depth / far), tol {tol}")
        for k, v in errs.items():
            require(v <= tol, f"K2 S={s} bf16={bf16} {k} err {v} > {tol}")
            require(math.isfinite(v), f"K2 {k} not finite")
        if not bf16:
            worst_abs_fp32 = max(worst_abs_fp32, *(max_err(g, r) for g, r in zip(got, ref)))
    return worst_abs_fp32


def phase_slice(dev, workdir):
    """render_views end to end for the dense and north-star configs."""
    import numpy as np

    from nerf_experiments_tpu_torch.experiments import render_views, run_barf
    from nerf_experiments_tpu_torch.ops.proposal_bins import proposal_bins
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
        cfg, dm = run_barf.build_config(run_barf.parse_args(common))
        params = barf_sys.init(torch.Generator().manual_seed(7), cfg).to(dev)
        ckpt = os.path.join(workdir, name, "ckpt")
        CheckpointManager(ckpt).save(1, params)
        argv = ["--ckpt_dir", ckpt, "--split", "test", "--n_images", "2",
                "--chunk", str(N_RAYS), "--device", str(dev),
                "--out_dir", os.path.join(workdir, name)] + common
        render_fwd_cuda.launches = 0
        flagship_render.launches = 0
        proposal_bins.launches = 0
        summary = render_views.main(argv)
        torch.cuda.synchronize()
        launches[name] = {"flagship_render": flagship_render.launches,
                          "render_fwd": render_fwd_cuda.launches,
                          "proposal_bins": proposal_bins.launches}
        log(f"slice {name}: mean_psnr {summary['mean_psnr']} launches {launches[name]}")
        require(math.isfinite(summary["mean_psnr"]), f"{name}: mean_psnr not finite")
        require(flagship_render.launches > 0, f"{name}: flagship_render never launched")
        if name == "northstar":  # its serving stage composites inside the proposal kernel
            require(proposal_bins.launches > 0, "northstar: proposal_bins never launched")

        # a crop of view 0 through the kernels vs the plain path on the CPU
        dm.setup("test")
        ds = dm.dataset_test
        params = CheckpointManager(ckpt).restore(params)
        raw = torch.as_tensor(dm.dataset_train.camera_origins)
        noisy = torch.as_tensor(dm.dataset_train.camera_origins_noisy)
        lo, hi = IMAGE_SIZE * IMAGE_SIZE // 2, IMAGE_SIZE * IMAGE_SIZE // 2 + 512
        args = (ds.ray_origins[0][lo:hi], ds.ray_directions[0][lo:hi])
        a_pos = float(cfg.radiance.position_encoder.levels)
        with torch.no_grad():
            gauge_dev = barf_sys.val_gauge(params, raw.to(dev), noisy.to(dev))
            cpu_params = params.to("cpu")
            gauge_cpu = barf_sys.val_gauge(cpu_params, raw, noisy)
            plain = render_views.render_image(cpu_params, cfg, *args, gauge_cpu,
                                              float(ds.pixel_width), 512, "cpu", a_pos, 4.0)
            params.to(dev)
            kern = render_views.render_image(params, cfg, *args, gauge_dev,
                                             float(ds.pixel_width), 512, dev, a_pos, 4.0)
        tol = TOL_BF16 if "--bf16" in flags else TOL_FP32
        err = float(np.abs(kern - plain).max())
        log(f"slice {name}: 512-ray crop, kernel path vs plain CPU path "
            f"max abs err {err}, tol {tol}")
        require(err <= tol, f"{name}: crop err {err} > {tol}")
        exps[name] = (cfg, params)
    return launches, exps


def rel_norm(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-30))


def phase_render_bwd(dev):
    """K3 against `render_bwd_reference` with random cotangents; each
    output's max abs error relative to the reference's max abs value."""
    from nerf_experiments_tpu_torch.ops import render
    from nerf_experiments_tpu_torch.ops.render_cuda import render_bwd_cuda

    gen = torch.Generator(device=dev).manual_seed(5)
    worst = 0.0
    for s in (64, 128):
        dens = torch.rand((N_RAYS, s), generator=gen, device=dev) * 8.0
        colors = torch.rand((N_RAYS, s, 3), generator=gen, device=dev)
        t = torch.sort(torch.rand((N_RAYS, s + 1), generator=gen, device=dev) * 6.0 + 2.0,
                       dim=-1).values
        dists = (t[:, 1:] - t[:, :-1]).contiguous()
        tmid = ((t[:, 1:] + t[:, :-1]) / 2.0).contiguous()
        gw, gt = (torch.randn((N_RAYS, s), generator=gen, device=dev) for _ in range(2))
        gs = torch.randn((N_RAYS, 5), generator=gen, device=dev)
        args = (dens, dists, tmid, colors, gw, gt, gs, render.DENSITY_SCALE)
        got = render_bwd_cuda(*args)
        ref = render.render_bwd_reference(*args)
        torch.cuda.synchronize()
        names = ("d_dens", "d_dists", "d_colors")
        abs_errs = {n: max_err(g, r) for n, g, r in zip(names, got, ref)}
        errs = {n: abs_errs[n] / float(r.abs().max()) for n, r in zip(names, ref)}
        log(f"K3 compositing backward ({N_RAYS}, {s}) fp32 max abs err "
            + json.dumps(abs_errs) + "; over max abs ref " + json.dumps(errs)
            + f", tol {TOL_K3}")
        for k, v in errs.items():
            require(v <= TOL_K3, f"K3 S={s} {k} err {v} > {TOL_K3}")
        worst = max(worst, *abs_errs.values())
    return worst


def phase_train_kernel(dev):
    """K4 against `flagship_train_grads_reference` at the flagship width:
    every output and every dW/db by relative norm, and two launches bitwise
    equal. The settings include the north-star training shape (8192 rays x
    32 samples, bf16, 16 row splits in the dW reduction); each logs its route
    (`train_route`: the compute type's tile and its rows) and must launch
    twice; both compute types must launch, the flagship width in fp32 must
    take the 64-row tile, and fp32 hidden 632, wider than a tile, must be
    refused. Returns the worst fp32 max abs error."""
    from nerf_experiments_tpu_torch.models import nerf_mlp
    from nerf_experiments_tpu_torch.ops import sampling
    from nerf_experiments_tpu_torch.ops.train_megakernel import (
        flagship_train_grads, flagship_train_grads_reference, train_route,
        train_workspace_bytes)

    gen = torch.Generator(device=dev).manual_seed(6)
    worst_abs_fp32 = 0.0
    # the flagship width, then hidden 48 and 100 (colour 24 and 50, padded to
    # 16 on the tensor cores) and 512 (on 32-row tiles)
    routes = {}
    for n, s, bf16, with_w, scale, hidden in ((1024, 128, False, False, 1.0, 256),
                                              (1024, 128, True, False, 1.0, 256),
                                              (1024, 32, False, True, 0.1, 256),
                                              (N_RAYS, 32, True, False, 1.0, 256),
                                              (1023, 32, False, False, 1.0, 256),
                                              (1023, 32, True, True, 1.0, 256),
                                              (333, 100, False, True, 1.0, 256),
                                              (333, 100, True, False, 0.5, 256),
                                              (257, 32, True, True, 1.0, 48),
                                              (257, 32, False, False, 1.0, 48),
                                              (333, 100, False, True, 1.0, 100),
                                              (333, 100, True, False, 1.0, 100),
                                              (255, 128, False, False, 1.0, 512),
                                              (255, 100, True, True, 1.0, 512),
                                              (255, 32, True, False, 1.0, 512)):
        origs, dirs = random_rays(n, gen, dev)
        targets = torch.rand((n, 3), generator=gen, device=dev)
        cfg = flagship_cfg(bf16, hidden_dim=hidden)
        params = nerf_mlp.init(torch.Generator().manual_seed(3), cfg).to(dev)
        ts, te = sampling.sample_stratified(None, n, s, 2.0, FAR, "equidistant", device=dev)
        args = (params, cfg, origs, dirs, ts, te, targets, 7.5, 2.5, scale, with_w)
        before = flagship_train_grads.launches
        got = flagship_train_grads(*args)
        again = flagship_train_grads(*args)
        ref = flagship_train_grads_reference(*args)
        torch.cuda.synchronize()
        counted = flagship_train_grads.launches - before
        kind, rows = train_route(cfg, hidden, hidden // 2)
        require(counted == 2, f"K4 hidden {hidden}: {counted} launches, want 2")
        routes[kind] = routes.get(kind, 0) + counted
        tag = (f"{n}x{s} {'bf16' if bf16 else 'fp32'} hidden {hidden} ({kind}, {rows}-row "
               f"tiles) loss_scale {scale}")
        flat = lambda out: [out[0], out[2], out[3], *out[1].values(), *out[4:]]
        require(all(torch.equal(a, b) for a, b in zip(flat(got), flat(again))),
                f"K4 {tag}: two launches differ")
        max_abs = max(max_err(a, b) for a, b in zip(flat(got), flat(ref)))
        tol = TOL_K4_BF16 if bf16 else TOL_K4_FP32
        errs = {"rgb": rel_norm(got[0], ref[0]), "d_origs": rel_norm(got[2], ref[2]),
                "d_dirs": rel_norm(got[3], ref[3])}
        if with_w:
            errs["weights"] = rel_norm(got[4], ref[4])
        for name, g in got[1].items():
            errs[name] = rel_norm(g, ref[1][name])
        worst = max(errs, key=errs.get)
        mb = train_workspace_bytes(cfg, n, s, hidden, hidden // 2) / 2**20
        log(f"K4 flagship_train {tag}: bitwise equal over two launches; workspace "
            f"{mb:.0f} MiB; rel norm err rgb {errs['rgb']:.3e} d_origs "
            f"{errs['d_origs']:.3e} d_dirs {errs['d_dirs']:.3e} worst {worst} "
            f"{errs[worst]:.3e} over {len(got[1])} grads, tol {tol}; max abs err "
            f"over all outputs {max_abs:.3e}")
        for k, v in errs.items():
            require(v <= tol and math.isfinite(v), f"K4 {tag} {k} err {v} > {tol}")
        if not bf16:
            worst_abs_fp32 = max(worst_abs_fp32, max_abs)
        del got, again, ref
        torch.cuda.empty_cache()
    log(f"K4 launches by route: {routes}")
    require(train_route(flagship_cfg(False), 256, 128) == ("tile_fp32", 64),
            "K4 fp32 at the flagship width: not on the 64-row tile")
    require(set(routes) == {"tile_bf16", "tile_fp32"}, f"K4: a route never launched: {routes}")
    # fp32 hidden 632: no tile fits, so no kernel (the plain step's width)
    wide = flagship_cfg(False, hidden_dim=632)
    require(train_route(wide, 632, 316) is None, "K4 fp32 hidden 632: a route was named")
    origs, dirs = random_rays(32, gen, dev)
    ts, te = sampling.sample_stratified(None, 32, 32, 2.0, FAR, "equidistant", device=dev)
    params = nerf_mlp.init(torch.Generator().manual_seed(3), wide).to(dev)
    before = flagship_train_grads.launches
    try:
        flagship_train_grads(params, wide, origs, dirs, ts, te, torch.rand_like(origs), 7.5,
                             2.5)
    except ValueError as err:
        log(f"K4 fp32 hidden 632 refused: {err}")
    else:
        require(False, "K4 fp32 hidden 632: launched where no tile fits")
    require(flagship_train_grads.launches == before, "K4 fp32 hidden 632: a launch was counted")
    return worst_abs_fp32


def train_configs():
    """(name, flags, BarfConfig) of the two training configs at full width."""
    from nerf_experiments_tpu_torch.experiments import run_barf

    out = []
    for name, flags in (("dense fp32", ["--samples_per_ray", "128"]),
                        ("dense bf16", ["--samples_per_ray", "128", "--bf16"]),
                        ("northstar bf16", NORTHSTAR)):
        args = run_barf.parse_args(["--image_size", str(IMAGE_SIZE), "--seed", "7"] + flags)
        out.append((name, flags, run_barf.build_config(args)[0]))
    return out


def train_batch(n: int, n_images: int, gen: torch.Generator, dev) -> dict:
    origs, dirs = random_rays(n, gen, dev)
    return {"origs_noisy": origs, "dirs_noisy": dirs,
            "colors": torch.rand((n, 2, 3), generator=gen, device=dev),
            "img_idx": torch.randint(0, n_images, (n,), generator=gen, device=dev),
            "pixel_width": torch.full((n, 1), 1e-3, device=dev)}


def step_pair(name: str, init_state, params, batch, steps, scalars, bf16: bool, dev,
              seed: int, gate: bool = True) -> None:
    """Two train steps from copies of `params`, one batch and one generator
    seed: `steps` = (the reference step, the step under test). Holds the
    second's loss, every gradient it hands to Adam and the update of every
    parameter and buffer (the occupancy grid's refresh included) against
    the first's, at phase 8's tolerances. A gradient or update that is 0 in
    the reference is left out of the relative norms. With gate=False the
    errors are only logged (a witness, not a check)."""
    import copy

    before = {k: v.clone() for k, v in params.state_dict().items()}
    out, grads = [], []
    for step in steps:
        state = init_state(copy.deepcopy(params))
        captured = {}

        def capture_then_step(state=state, captured=captured, adam_step=state.optimizer.step):
            # keep the gradients Adam is handed
            captured.update({k: p.grad.clone() for k, p in state.params.named_parameters()
                             if p.grad is not None})
            adam_step()

        state.optimizer.step = capture_then_step
        state, metrics = step(state, batch, torch.Generator(device=dev).manual_seed(seed),
                              *scalars)
        out.append((float(metrics["loss"]), state.params.state_dict(),
                    bool(metrics["grads_finite"])))
        grads.append(captured)
    torch.cuda.synchronize()
    (ref_loss, ref_sd, ref_ok), (loss, sd, ok) = out
    loss_err = abs(loss - ref_loss) / abs(ref_loss)
    require(set(grads[0]) == set(grads[1]) and grads[0],
            f"{name}: the two steps set gradients on different parameters")
    grad_errs = {k: rel_norm(grads[1][k], g) for k, g in grads[0].items()
                 if float(g.norm()) > 0}
    worst_g = max(grad_errs, key=grad_errs.get)
    upd = {k: rel_norm(sd[k] - before[k], ref_sd[k] - before[k]) for k in before
           if float((ref_sd[k] - before[k]).norm()) > 0}
    worst = max(upd, key=upd.get)
    log(f"{name}: loss {loss:.6f} reference {ref_loss:.6f} rel err {loss_err:.3e} (tol "
        f"{TOL_STEP_LOSS[bf16]}); gradient rel norm err worst {worst_g} "
        f"{grad_errs[worst_g]:.3e} over {len(grad_errs)} tensors (tol {TOL_STEP_GRAD[bf16]}); "
        f"update rel norm err worst {worst} {upd[worst]:.3e} over {len(upd)} tensors (tol "
        f"{TOL_STEP_UPDATE[bf16]})" + ("" if gate else ", logged only"))
    if not gate:
        return
    require(ok and ref_ok, f"{name}: non-finite gradients")
    require(loss_err <= TOL_STEP_LOSS[bf16], f"{name}: loss err {loss_err}")
    for k, v in grad_errs.items():
        require(v <= TOL_STEP_GRAD[bf16] and math.isfinite(v), f"{name}: gradient of {k} err {v}")
    for k, v in upd.items():
        require(v <= TOL_STEP_UPDATE[bf16], f"{name}: update of {k} err {v}")


def perturbed_camera(params, dev, seed: int):
    """`params` with the camera's rotation away from zero, so its gradients
    are general."""
    with torch.no_grad():
        params.camera.rotation.normal_(0.0, 0.05, generator=torch.Generator(dev).manual_seed(seed))
    return params


def phase_train_step(dev):
    """train_step_fused against train_step from one state, batch and seed."""
    import functools

    from nerf_experiments_tpu_torch.systems import barf as barf_sys

    for name, _, cfg in train_configs():
        if name == "dense bf16":
            continue
        params = perturbed_camera(barf_sys.init(torch.Generator().manual_seed(8), cfg).to(dev),
                                  dev, 9)
        batch = train_batch(1024, cfg.n_training_images,
                            torch.Generator(device=dev).manual_seed(10), dev)
        step_pair(f"train step {name}, fused against plain", functools.partial(
            barf_sys.init_state, cfg), params, batch,
            (barf_sys.make_train_step(cfg), barf_sys.make_train_step(cfg, fused=True)),
            (7.5, 2.5, 0.0), cfg.radiance.compute_dtype is not None, dev, 11)


def phase_training(dev, workdir):
    """run_barf.main --fused_kernel end to end, with launches counted."""
    from nerf_experiments_tpu_torch.experiments import render_views, run_barf
    from nerf_experiments_tpu_torch.ops.train_megakernel import train_route

    def counted(argv):
        return counted_run(run_barf.main, argv)

    def route(argv):  # K4's route for the run's radiance net
        mlp = run_barf.build_config(run_barf.parse_args(argv))[0].radiance
        return train_route(mlp, mlp.hidden_dim, mlp.hidden_dim // 2)

    # dense flagship, the JAX package's end-to-end test at full width
    out = os.path.join(workdir, "train_dense")
    dense = ["--image_size", "32", "--batch_size", "1024", "--max_steps", "300",
             "--samples_per_ray", "128", "--checkpoint_every_n_epochs", "10",
             "--camera_origin_noise_sigma", "0.0", "--camera_rotation_noise_sigma", "0.0",
             "--no-optimize_camera", "--alpha_decay_start_step", "0",
             "--alpha_decay_end_step", "1", "--fused_kernel", "--device", str(dev),
             "--out_dir", out]
    state, launches_dense = counted(dense)
    rows = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    psnrs = [r["psnr"] for r in rows if "psnr" in r and math.isfinite(r["psnr"])]
    rates = [r["train_rays_per_sec"] for r in rows if "train_rays_per_sec" in r]
    log(f"train dense fp32 32^2: {state.step} steps, psnr {psnrs[0]:.3f} -> {psnrs[-1]:.3f} "
        f"over {len(psnrs)} log rows, last train_rays_per_sec {rates[-1]:.0f}, "
        f"launches {launches_dense}")
    require(state.step == 300, "dense run did not reach 300 steps")
    require(psnrs[-1] > psnrs[0] + 1.0 and psnrs[-1] > 10.0, f"dense PSNR {psnrs}")
    require(launches_dense["flagship_train"] >= 300, "dense: K4 not on every step")
    require(route(dense) == ("tile_fp32", 64), f"dense: K4 route {route(dense)}")

    # other widths, each logging images through K2 from its first step: hidden
    # 100 fused in bf16 (tiles padded to 16), hidden 512 on the plain step in
    # fp32 (K2 on 32-row tiles)
    for hidden, flags in ((100, ["--fused_kernel", "--bf16"]), (512, [])):
        state, launches = counted(
            ["--image_size", "32", "--batch_size", "1024", "--max_steps", "4",
             "--samples_per_ray", "64", "--hidden_dim", str(hidden), "--device", str(dev),
             "--out_dir", os.path.join(workdir, f"train_hidden{hidden}")] + flags)
        log(f"train hidden {hidden} ({' '.join(flags) or 'plain step, fp32'}) 32^2: "
            f"{state.step} steps, launches {launches}")
        require(state.step == 4 and launches["flagship_render"] >= 1,
                f"hidden {hidden}: no image logged through K2")
        require(launches["flagship_train"] == (4 if flags else 0),
                f"hidden {hidden}: K4 launched {launches['flagship_train']} times")

    # north-star hierarchical, bf16, at the serving scene's size
    out = os.path.join(workdir, "train_northstar")
    ns = ["--image_size", str(IMAGE_SIZE), "--batch_size", str(N_RAYS), "--seed", "7",
          "--checkpoint_every_n_epochs", "10", "--log_every_n_steps", "10",
          "--fused_kernel", "--device", str(dev), "--out_dir", out] + NORTHSTAR
    steps = 50
    state, launches_ns = counted(ns + ["--max_steps", str(steps)])
    rows = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    losses = [r["loss"] for r in rows if "loss" in r]
    log(f"train northstar bf16 {IMAGE_SIZE}^2 batch {N_RAYS}: {state.step} steps, loss "
        f"{losses[0]:.5f} -> {losses[-1]:.5f}, launches {launches_ns}")
    require(all(math.isfinite(v) for v in losses), "northstar: non-finite loss")
    for k in ("flagship_train", "render_fwd", "render_bwd"):
        require(launches_ns[k] >= steps, f"northstar: {k} launched {launches_ns[k]} < {steps}")
    require(route(ns) == ("tile_bf16", 64), f"northstar: K4 route {route(ns)}")
    state, launches_resume = counted(ns + ["--max_steps", str(steps + 10), "--resume"])
    log(f"resume northstar: {state.step} steps, launches {launches_resume}")
    require(state.step == steps + 10 and launches_resume["flagship_train"] == 10,
            "resume did not continue from the checkpoint")
    summary = render_views.main(
        ["--ckpt_dir", os.path.join(out, "ckpt"), "--split", "test", "--n_images", "2",
         "--chunk", str(N_RAYS), "--device", str(dev), "--image_size", str(IMAGE_SIZE),
         "--seed", "7", "--out_dir", os.path.join(out, "render")] + NORTHSTAR)
    log(f"render_views on the trained northstar checkpoint (step {summary['ckpt_step']}): "
        f"mean_psnr {summary['mean_psnr']:.3f}")
    require(summary["ckpt_step"] == steps + 10 and math.isfinite(summary["mean_psnr"]),
            "render_views on the trained checkpoint")
    return {k: launches_dense[k] + launches_ns[k] for k in launches_dense}


def profile_step(step_fn, label: str) -> None:
    """Kernel time by name for one train step (torch.profiler): (host wall
    ms, device ms, {kernel name: device ms})."""
    from torch.profiler import ProfilerActivity, profile

    step_fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        step_fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"
              and e.self_device_time_total > 0]
    total = sum(e.self_device_time_total for e in events) / 1e3
    log(f"profile {label}: host wall {wall:.2f} ms, device kernels {total:.2f} ms "
        f"(idle share {max(0.0, 1 - total / wall):.3f})")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:90]}")
    return wall, total, {e.key: e.self_device_time_total / 1e3 for e in events}


def k4_kernels_ms(fn, label: str, calls: int = 10) -> dict:
    """Device ms a call of each kernel of one K4 call (`torch.profiler`,
    `calls` calls), by the kernel's name without return type, namespaces,
    template and arguments: phase A, phase B (dW), the reduction and the
    weight packing's PyTorch kernels."""
    from torch.profiler import ProfilerActivity, profile

    def short_name(name: str) -> str:
        name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
        cuts = [i for i in (name.find("<"), name.find("(")) if i > 0]
        return (name[:min(cuts)] if cuts else name).strip()

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ms = {}
    for e in prof.key_averages():
        if e.device_type.name == "CUDA" and e.self_device_time_total > 0:
            name = short_name(e.key)
            ms[name] = ms.get(name, 0.0) + e.self_device_time_total / 1e3 / calls
    log(f"time K4 {label} by kernel, device ms a call: "
        + ", ".join(f"{k} {v:.3f}" for k, v in sorted(ms.items(), key=lambda kv: -kv[1])))
    return ms


def phase_train_timing(dev):
    """Train step fused vs plain at 8192 rays, K3 and K4 alone vs plain (K4
    fp32 also at the dense cell's 1024 rays, with each of its kernels' device
    ms)."""
    import copy

    from nerf_experiments_tpu_torch.models import nerf_mlp
    from nerf_experiments_tpu_torch.ops import render, sampling
    from nerf_experiments_tpu_torch.ops.render_cuda import render_bwd_cuda
    from nerf_experiments_tpu_torch.ops.train_megakernel import (
        flagship_train_grads, flagship_train_grads_reference)
    from nerf_experiments_tpu_torch.systems import barf as barf_sys

    gen = torch.Generator(device=dev).manual_seed(12)
    times = {}
    # K3 by device time over 200 back-to-back calls, each on inputs out of
    # L2, at the north-star coarse shape (S = 64) and S = 128
    for s in (64, 128):
        dens = torch.rand((N_RAYS, s), generator=gen, device=dev) * 8.0
        colors = torch.rand((N_RAYS, s, 3), generator=gen, device=dev)
        ts, te = sampling.sample_stratified(None, N_RAYS, s, 2.0, FAR, "equidistant",
                                            device=dev)
        dists, tmid = (te - ts).contiguous(), ((ts + te) / 2).contiguous()
        g = [torch.randn((N_RAYS, s), generator=gen, device=dev) for _ in range(2)]
        gs = torch.randn((N_RAYS, 5), generator=gen, device=dev)
        sets = cold_copies(dens, dists, tmid, colors, g[0], g[1], gs, render.DENSITY_SCALE)
        k = device_ms(render_bwd_cuda, arg_sets=sets)
        p = device_ms(render.render_bwd_reference, arg_sets=sets)
        times[f"K3_S{s}"] = (k, p)
        log(f"time K3 compositing backward {N_RAYS}x{s} fp32, device time per call over "
            f"200 calls rotating {len(sets)} input sets (inputs from HBM): kernel {k:.4f} ms, "
            f"plain {p:.4f} ms")
        del sets
    # K4 alone at the dense and north-star fine shapes, and at the dense
    # benchmark cell's 1024 rays
    for n, s, bf16 in ((N_RAYS, 128, False), (1024, 128, False), (N_RAYS, 128, True),
                       (N_RAYS, 32, True)):
        origs, dirs = random_rays(n, gen, dev)
        targets = torch.rand((n, 3), generator=gen, device=dev)
        cfg = flagship_cfg(bf16)
        params = nerf_mlp.init(torch.Generator().manual_seed(3), cfg).to(dev)
        ts, te = sampling.sample_stratified(None, n, s, 2.0, FAR, "equidistant", device=dev)
        args = (params, cfg, origs, dirs, ts, te, targets, 7.5, 2.5)
        torch.cuda.reset_peak_memory_stats()
        k = cuda_time_ms(lambda: flagship_train_grads(*args), iters=3 if n == N_RAYS else 10,
                         warmup=1)
        mem_k = torch.cuda.max_memory_allocated() / 2**30
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        p = cuda_time_ms(lambda: flagship_train_grads_reference(*args), iters=3, warmup=1)
        mem_p = torch.cuda.max_memory_allocated() / 2**30
        torch.cuda.empty_cache()
        dtype = "bf16" if bf16 else "fp32"
        tag = f"K4_S{s}_{dtype}" if n == N_RAYS else f"K4_{n}_S{s}_{dtype}"
        times[tag] = (k, p)
        log(f"time K4 flagship_train {n}x{s} {dtype}: kernel {k:.3f} ms (peak {mem_k:.1f} "
            f"GiB), plain {p:.3f} ms (peak {mem_p:.1f} GiB)")
        if not bf16:  # each phase's device time, by kernel
            k4_kernels_ms(lambda: flagship_train_grads(*args), f"{n}x{s} {dtype}")
    # the train step at 8192 rays, fused vs plain, in turns
    for name, _, cfg in train_configs():
        params = barf_sys.init(torch.Generator().manual_seed(8), cfg).to(dev)
        batch = train_batch(N_RAYS, cfg.n_training_images,
                            torch.Generator(device=dev).manual_seed(13), dev)
        res = {}
        for fused in (False, True, True, False):
            state = barf_sys.init_state(cfg, copy.deepcopy(params))
            step = barf_sys.make_train_step(cfg, fused=fused)
            run = lambda: step(state, batch, torch.Generator(device=dev).manual_seed(14),
                               7.5, 2.5, 0.0)
            res.setdefault(fused, []).append(cuda_time_ms(run, iters=3, warmup=1))
            del state
            torch.cuda.empty_cache()
        k, p = min(res[True]), min(res[False])
        times[f"step_{name}"] = (k, p)
        log(f"train step {name} ({N_RAYS} rays): fused {res[True]} ms -> "
            f"{N_RAYS / k * 1e3:.0f} rays/s; plain {res[False]} ms -> "
            f"{N_RAYS / p * 1e3:.0f} rays/s")
        state = barf_sys.init_state(cfg, copy.deepcopy(params))
        fused_step = barf_sys.make_train_step(cfg, fused=True)
        profile_step(lambda: fused_step(state, batch, torch.Generator(device=dev).manual_seed(14),
                                        7.5, 2.5, 0.0), f"fused train step {name}")
        if cfg.radiance.compute_dtype is not None:
            times[f"pack_{name}"] = time_packing(params.radiance, cfg.radiance, dev, name)
        del state
        torch.cuda.empty_cache()
    return times


def host_ms(fn, calls: int = 50) -> float:
    """Host time per call of `fn` (what it costs the CPU to issue its work),
    the device left to catch up after the loop."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    ms = (time.perf_counter() - t) * 1e3 / calls
    torch.cuda.synchronize()
    return ms


def time_packing(params, cfg, dev, name: str):
    """K4's weight packing for one train step (`packed_weights`, forward and
    backward operands in one gather), host and device time a call, beside
    packing each operand on its own by `pack_b` (the layout's definition)."""
    from nerf_experiments_tpu_torch.ops.train_megakernel import (
        _layer_parts, _layers, pack_b, packed_weights)

    D, C = cfg.hidden_dim, cfg.hidden_dim // 2
    last = 2 * cfg.n_hidden + 1

    def each():
        for i, (layer, (parts, out)) in enumerate(zip(_layers(params),
                                                      _layer_parts(cfg, D, C))):
            w = layer.w.detach()
            n_fwd = D if i == last else out
            pack_b(w[:, :n_fwd], parts, [n_fwd], True)
            pack_b(w.t(), [out], parts, True)

    gather = lambda: packed_weights(params, cfg, dev, backward=True)
    h, d = host_ms(gather), device_ms(gather, calls=50)
    h_each, d_each = host_ms(each), device_ms(each, calls=50)
    log(f"weight packing {name} (bf16, forward and backward operands): one gather host "
        f"{h:.4f} ms, device {d:.4f} ms a step; pack_b per operand host {h_each:.4f} ms, "
        f"device {d_each:.4f} ms")
    return h, d, h_each, d_each


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
        dens, rgb = barf_sys._eval_model(*barf_sys._proposal_model(params, cfg), origs, dirs,
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
    from nerf_experiments_tpu_torch.ops.render_cuda import render_fwd_cuda
    from nerf_experiments_tpu_torch.ops.train_megakernel import (
        flagship_render, flagship_render_reference)
    from nerf_experiments_tpu_torch.systems import barf as barf_sys

    gen = torch.Generator(device=dev).manual_seed(4)
    times = {}
    # K1 by device time over 200 back-to-back calls (its launch takes longer
    # on the host than it runs), each on inputs out of L2, at the north-star
    # coarse shape (S = 64) and S = 128
    for s in (64, 128):
        dens = torch.rand((N_RAYS, s), generator=gen, device=dev) * 8.0
        colors = torch.rand((N_RAYS, s, 3), generator=gen, device=dev)
        ts, te = sampling.sample_stratified(None, N_RAYS, s, 2.0, FAR, "equidistant", device=dev)
        dists, tmid = (te - ts).contiguous(), ((ts + te) / 2).contiguous()
        sets = cold_copies(dens, dists, tmid, colors, ts, te)
        k = device_ms(lambda d, dt, tm, c, *_: render_fwd_cuda(d, dt, tm, c, render.DENSITY_SCALE),
                      arg_sets=sets)
        p = device_ms(lambda d, dt, tm, c, t0, t1: render.render_full(d, c, t0, t1),
                      arg_sets=sets)
        times[f"K1_S{s}"] = (k, p)
        log(f"time K1 compositing {N_RAYS}x{s} fp32, device time per call over 200 calls "
            f"rotating {len(sets)} input sets (inputs from HBM): kernel {k:.4f} ms, plain "
            f"{p:.4f} ms")
        del sets
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
        for name, (cfg, params) in exps.items():
            k = cuda_time_ms(lambda: barf_sys.forward(
                params, cfg, None, origs, dirs, pw, 10.0, 4.0, stratified=False,
                fused=True))
            p = cuda_time_ms(lambda: plain_forward(params, cfg, origs, dirs, pw))
            times[f"serve_{name}"] = (k, p)
            log(f"serving forward {name} ({N_RAYS} rays): kernel path {k:.4f} ms = "
                f"{N_RAYS / k * 1e3:.0f} rays/s; plain path {p:.4f} ms = "
                f"{N_RAYS / p * 1e3:.0f} rays/s")
    return times


# The proposal kernel against the plain stage, as tests/test_torch_proposal_bins.py
# holds it: bf16 roundings flip where the tensor cores add in another order
# than cuBLAS, moving the coarse rgb and the fine bins' edges a little.
TOL_PROPOSAL_RGB = 5e-4
TOL_PROPOSAL_T = 2e-3


def phase_proposal_bins(dev):
    """The serving proposal kernel against its plain version at the north-star
    chunk (8192 rays x 64 bins -> 32 fine bins), every level on and
    fractional alphas: the coarse rgb and the fine bins (max abs), two
    launches bitwise equal; then the kernel's device time per call and the
    plain stage's CUDA-event time. Returns (worst error, (kernel ms, plain
    ms))."""
    from nerf_experiments_tpu_torch.experiments import run_barf
    from nerf_experiments_tpu_torch.ops import proposal_bins as pb
    from nerf_experiments_tpu_torch.systems import barf as barf_sys

    cfg, _ = run_barf.build_config(run_barf.parse_args(
        ["--image_size", str(IMAGE_SIZE), "--seed", "7"] + NORTHSTAR))
    require(barf_sys.can_fuse_proposal(cfg), "north-star: the proposal kernel refuses it")
    params = barf_sys.init(torch.Generator().manual_seed(5), cfg).to(dev)
    gen = torch.Generator(device=dev).manual_seed(6)
    origs, dirs = random_rays(N_RAYS, gen, dev)

    def call(fn, a_pos=A_POS, a_dir=A_DIR):
        return fn(params.proposal, cfg.proposal, origs, dirs, cfg.near, cfg.far,
                  cfg.samples_per_ray_proposal, cfg.samples_per_ray_radiance, a_pos, a_dir)

    worst = 0.0
    with torch.no_grad():
        for a_pos, a_dir in ((A_POS, A_DIR), (6.5, 2.5), (0.0, A_DIR)):
            got = call(pb.proposal_bins, a_pos, a_dir)
            ref = call(pb.proposal_bins_reference, a_pos, a_dir)
            torch.cuda.synchronize()
            rgb_err = max_err(got[0], ref[0])
            t_err = max(max_err(got[1], ref[1]), max_err(got[2], ref[2]))
            log(f"proposal_bins {N_RAYS}x{cfg.samples_per_ray_proposal} -> "
                f"{cfg.samples_per_ray_radiance} bf16 alphas {a_pos} / {a_dir}: max abs err "
                f"rgb_coarse {rgb_err:.3e} (tol {TOL_PROPOSAL_RGB}), bins {t_err:.3e} (tol "
                f"{TOL_PROPOSAL_T})")
            require(rgb_err <= TOL_PROPOSAL_RGB and t_err <= TOL_PROPOSAL_T,
                    f"proposal_bins alphas {a_pos} / {a_dir}: rgb {rgb_err}, bins {t_err}")
            worst = max(worst, rgb_err, t_err)
        first, again = call(pb.proposal_bins), call(pb.proposal_bins)
        require(all(torch.equal(a, b) for a, b in zip(first, again)),
                "proposal_bins: two launches differ")
        k = device_ms(lambda: call(pb.proposal_bins), calls=100)
        p = cuda_time_ms(lambda: call(pb.proposal_bins_reference), iters=20)
    log(f"time proposal_bins {N_RAYS}x{cfg.samples_per_ray_proposal} -> "
        f"{cfg.samples_per_ray_radiance} bf16: kernel {k:.4f} ms (device time per call), "
        f"plain stage {p:.4f} ms (CUDA events)")
    return worst, (k, p)


GARF_FAMILIES = (("gauss", 1.0), ("gabor", 1.0), ("gabor", 0.37), ("sarf", 1.0),
                 ("sarf", 0.37))
GARF_FAR = 7.0
GARF_RAYS = 4096  # the GARF training batch timed in phase 15


def garf_cfg(activation: str, bf16: bool):
    from nerf_experiments_tpu_torch.models import garf

    lo = 0.0 if activation == "gabor" else 0.5  # garf_main's ACTIVATION_DEFAULTS
    return garf.GarfConfig(activation=activation, init_min=lo, init_max=2.0,
                           compute_dtype=torch.bfloat16 if bf16 else None)


def garf_inputs(n: int, s: int, activation: str, bf16: bool, seed: int, dev):
    """Random GARF radiance weights (seeded) and n rays with lindisp bins."""
    from nerf_experiments_tpu_torch.models import garf
    from nerf_experiments_tpu_torch.ops import sampling

    cfg = garf_cfg(activation, bf16)
    params = garf.radiance_init(torch.Generator().manual_seed(seed), cfg).to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    origs, dirs = random_rays(n, gen, dev)
    edges = sampling.lindisp_edges(n, s, 2.0, GARF_FAR, True, gen, device=dev)
    targets = torch.rand((n, 3), generator=gen, device=dev)
    return cfg, params, origs, dirs, edges[:, :-1].contiguous(), edges[:, 1:].contiguous(), \
        targets


def phase_garf_render(dev):
    """K6 against `garf_radiance_render_reference`: every family, fp32 and
    bf16, gamma 1 and 0.37 (gabor / sarf), S = 192 and a ragged 50."""
    from nerf_experiments_tpu_torch.ops.garf_megakernel import (
        garf_radiance_render, garf_radiance_render_reference)

    worst_abs_fp32 = 0.0
    for s in (192, 50):
        for activation, gamma in GARF_FAMILIES:
            for bf16 in (False, True):
                cfg, params, o, d, ts, te, _ = garf_inputs(1024, s, activation, bf16, 21, dev)
                with torch.no_grad():
                    got = garf_radiance_render(params, cfg, o, d, ts, te, gamma)
                    ref = garf_radiance_render_reference(params, cfg, o, d, ts, te, gamma)
                torch.cuda.synchronize()
                tol = TOL_BF16 if bf16 else TOL_FP32
                errs = {n: max_err(g, r) / (GARF_FAR if n == "depth" else 1.0)
                        for n, g, r in zip(("rgb", "opacity", "depth"), got, ref)}
                log(f"K6 garf_render {activation} gamma {gamma} 1024x{s} "
                    f"{'bf16' if bf16 else 'fp32'} max abs err "
                    + json.dumps({k: float(f"{v:.3e}") for k, v in errs.items()})
                    + f" (depth / far), tol {tol}; mean opacity {float(ref[1].mean()):.3f}")
                for k, v in errs.items():
                    require(v <= tol and math.isfinite(v),
                            f"K6 {activation} {gamma} S={s} bf16={bf16} {k} err {v} > {tol}")
                if not bf16:
                    worst_abs_fp32 = max(worst_abs_fp32,
                                         *(max_err(g, r) for g, r in zip(got, ref)))
    return worst_abs_fp32


def phase_garf_train_kernel(dev):
    """K5 against `garf_radiance_train_grads_reference`: rgb, weights, the
    geometry gradients and every dW / db / d(activation parameter) by
    relative norm, and two launches bitwise equal; every family, fp32 and
    bf16, at 1024 x 192 and 256 x 50."""
    import dataclasses

    from nerf_experiments_tpu_torch.ops.garf_megakernel import (
        garf_radiance_train_grads, garf_radiance_train_grads_reference,
        train_workspace_bytes)

    def errors(got, ref):
        errs = {"rgb": rel_norm(got[0], ref[0]), "weights": rel_norm(got[1], ref[1]),
                "d_origs": rel_norm(got[3], ref[3]), "d_dirs": rel_norm(got[4], ref[4])}
        for name, g in ref[2].items():
            errs[name] = rel_norm(got[2][name], g)
        return errs

    worst_abs_fp32 = 0.0
    for n, s in ((1024, 192), (256, 50)):
        for activation, gamma in GARF_FAMILIES:
            for bf16 in (False, True):
                cfg, params, o, d, ts, te, tg = garf_inputs(n, s, activation, bf16, 22, dev)
                args = (params, cfg, o, d, ts, te, tg, gamma)
                got = garf_radiance_train_grads(*args)
                again = garf_radiance_train_grads(*args)
                ref = garf_radiance_train_grads_reference(*args)
                torch.cuda.synchronize()
                tag = f"{activation} gamma {gamma} {n}x{s} {'bf16' if bf16 else 'fp32'}"
                flat = lambda out: [out[0], out[1], out[3], out[4], *out[2].values()]
                require(set(got[2]) == set(ref[2]), f"K5 {tag}: gradient names differ")
                require(all(torch.equal(a, b) for a, b in zip(flat(got), flat(again))),
                        f"K5 {tag}: two launches differ")
                max_abs = max(max_err(a, b) for a, b in zip(
                    [got[0], got[1], got[3], got[4], *(got[2][k] for k in ref[2])],
                    [ref[0], ref[1], ref[3], ref[4], *ref[2].values()]))
                tol = TOL_K4_BF16 if bf16 else TOL_K4_FP32
                errs = errors(got, ref)
                worst = max(errs, key=errs.get)
                mb = train_workspace_bytes(cfg, n, s) / 2**20
                log(f"K5 garf_train {tag}: bitwise equal over two launches; workspace "
                    f"{mb:.0f} MiB; rel norm err rgb {errs['rgb']:.3e} weights "
                    f"{errs['weights']:.3e} d_origs {errs['d_origs']:.3e} d_dirs "
                    f"{errs['d_dirs']:.3e} worst {worst} {errs[worst]:.3e} over "
                    f"{len(ref[2])} grads, tol {tol}; max abs err {max_abs:.3e}")
                if bf16:  # bf16's own error: both against the plain version in fp32
                    ref32 = garf_radiance_train_grads_reference(
                        params, dataclasses.replace(cfg, compute_dtype=None), *args[2:])
                    e_ref, e_got = errors(ref, ref32), errors(got, ref32)
                    log(f"  against the fp32 plain version: plain bf16 d_origs "
                        f"{e_ref['d_origs']:.3e} d_dirs {e_ref['d_dirs']:.3e} worst "
                        f"{max(e_ref.values()):.3e}; kernel bf16 d_origs {e_got['d_origs']:.3e} "
                        f"d_dirs {e_got['d_dirs']:.3e} worst {max(e_got.values()):.3e}")
                    del ref32
                for k, v in errs.items():
                    require(v <= tol and math.isfinite(v), f"K5 {tag} {k} err {v} > {tol}")
                if not bf16:
                    worst_abs_fp32 = max(worst_abs_fp32, max_abs)
                del got, again, ref
        torch.cuda.empty_cache()
    return worst_abs_fp32


def garf_system_cfg(activation: str, bf16: bool):
    from nerf_experiments_tpu_torch.systems import garf_system

    net = garf_cfg(activation, bf16)
    return garf_system.GarfSystemConfig(n_train_images=12, near=2.0, far=GARF_FAR, net=net,
                                        camera_learning_rate_start=4e-3,
                                        camera_learning_rate_stop=8e-4)


def garf_batch(n: int, gen: torch.Generator, dev) -> dict:
    origs, dirs = random_rays(n, gen, dev)
    return {"origs_noisy": origs, "dirs_noisy": dirs,
            "colors": torch.rand((n, 1, 3), generator=gen, device=dev),
            "img_idx": torch.randint(0, 12, (n,), generator=gen, device=dev)}


def phase_garf_train_step(dev):
    """The GARF `train_step_fused` against `train_step` from one state, batch
    and generator seed (gauss fp32, gabor bf16 at gamma 0.37): the loss,
    every gradient handed to Adam, and the update."""
    import functools

    from nerf_experiments_tpu_torch.systems import garf_system

    for activation, bf16 in (("gauss", False), ("gabor", True)):
        cfg = garf_system_cfg(activation, bf16)
        params = perturbed_camera(
            garf_system.init(torch.Generator().manual_seed(30), cfg).to(dev), dev, 31)
        batch = garf_batch(1024, torch.Generator(device=dev).manual_seed(32), dev)
        step_pair(f"GARF train step {activation} {'bf16' if bf16 else 'fp32'} (1024 rays, "
                  f"64 + 192 samples), fused against plain",
                  functools.partial(garf_system.init_state, cfg), params, batch,
                  (garf_system.make_train_step(cfg), garf_system.make_train_step_fused(cfg)),
                  (0.37,), bf16, dev, 33)


def phase_garf_training(dev, workdir):
    """`garf_main.main --fused_kernel` end to end on a generated 32^2 scene,
    with the K5, K6 (image logger) and K1 (validation) launches counted:
    gauss fp32 (train PSNR must rise by > 1 dB), then `--resume`; short
    gabor bf16 and sarf runs keep the loss finite."""
    from nerf_experiments_tpu_torch.experiments import garf_main

    def counted(argv):
        return counted_run(garf_main.main, argv)

    def rows(out):
        return [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]

    base = ["--image_size", "32", "--batch_size", "1024", "--log_every_n_steps", "10",
            "--fused_kernel", "--device", str(dev)]
    out = os.path.join(workdir, "garf_gauss")
    steps = 300
    # garf_main's default radiance LR (2e-4 -> 2e-5 over 6 epochs, an epoch
    # being 12 steps here) holds the train PSNR at the mean colour's ~11.7 dB
    # for hundreds of steps at 32^2; ten times it, decaying over the run's 25
    # epochs, lets the scene's structure appear within this run
    gauss = base + ["--activation", "gauss", "--out_dir", out,
                    "--radiance_learning_rate_start", "2e-3",
                    "--radiance_learning_rate_stop", "2e-4",
                    "--radiance_learning_rate_decay_end", "25",
                    "--checkpoint_every_n_epochs", "100"]  # and a checkpoint at the end
    state, launches = counted(gauss + ["--max_steps", str(steps)])
    r = rows(out)
    psnrs = [x["psnr"] for x in r if "psnr" in x and math.isfinite(x["psnr"])]
    rates = [x["train_rays_per_sec"] for x in r if "train_rays_per_sec" in x]
    vals = [x["val_psnr"] for x in r if "val_psnr" in x]
    log(f"garf_main gauss fp32 32^2 batch 1024: {state.step} steps, psnr {psnrs[0]:.3f} -> "
        f"{psnrs[-1]:.3f} over {len(psnrs)} log rows (validation {vals[0]:.3f} -> "
        f"{vals[-1]:.3f}, best {max(vals):.3f}), last train_rays_per_sec {rates[-1]:.0f}, "
        f"launches {launches}")
    require(state.step == steps, f"gauss run stopped at {state.step}")
    require(psnrs[-1] > psnrs[0] + 1.0, f"gauss PSNR did not rise by 1 dB: {psnrs}")
    require(launches["garf_train"] == steps, "gauss: K5 not on every step")
    require(launches["garf_render"] > 0 and launches["render_fwd"] > 0,
            "gauss: image logger (K6) or validation (K1) never launched")
    state, resumed = counted(gauss + ["--max_steps", str(steps + 10), "--resume"])
    log(f"garf_main --resume: {state.step} steps, launches {resumed}")
    require(state.step == steps + 10 and resumed["garf_train"] == 10,
            "resume did not continue from the checkpoint")
    total = {k: launches[k] + resumed[k] for k in launches}
    for activation, extra in (("gabor", ["--bf16"]), ("sarf", [])):
        out = os.path.join(workdir, f"garf_{activation}")
        state, launches = counted(base + ["--activation", activation, "--max_steps", "20",
                                          "--out_dir", out] + extra)
        losses = [x["loss"] for x in rows(out) if "loss" in x]
        log(f"garf_main {activation} {'bf16' if extra else 'fp32'}: {state.step} steps, loss "
            f"{losses[0]:.5f} -> {losses[-1]:.5f}, launches {launches}")
        require(state.step == 20 and all(math.isfinite(v) for v in losses),
                f"{activation}: non-finite loss")
        require(launches["garf_train"] == 20, f"{activation}: K5 not on every step")
        for k in total:
            total[k] += launches[k]
    return total


def time_garf_packing(params, cfg, dev, tag: str):
    """K5's weight packing for one train step (`packed_weights`, forward and
    backward operands of linears 1..9 in one gather, and linear 0's W and the
    density column in the compute type), host and device time a call, and
    the host time of K6's `render_weights` when the weights are unchanged
    (the cached packs)."""
    from nerf_experiments_tpu_torch.ops.garf_megakernel import packed_weights, render_weights

    pack = lambda: packed_weights(params, cfg, dev, backward=True)
    h, d = host_ms(pack), device_ms(pack, calls=50)
    cached = host_ms(lambda: render_weights(params, cfg, dev))
    log(f"GARF weight packing {tag}: one gather host {h:.4f} ms, device {d:.4f} ms a step; "
        f"render_weights with unchanged weights host {cached:.4f} ms a call")
    return h, d, cached


def phase_garf_timing(dev):
    """K5 and its plain version at 4096 x 192, K6 and its plain version at
    8192 x 192, the fused and plain train steps at batch 4096 (in turns), the
    proposal stage alone, and a profile of one fused step."""
    import copy

    from nerf_experiments_tpu_torch.ops import proposal
    from nerf_experiments_tpu_torch.ops.garf_megakernel import (
        garf_radiance_render, garf_radiance_render_reference, garf_radiance_train_grads,
        garf_radiance_train_grads_reference, train_workspace_bytes)
    from nerf_experiments_tpu_torch.systems import garf_system

    times = {}
    for activation, bf16 in (("gauss", False), ("gabor", True)):
        tag = f"{activation}_{'bf16' if bf16 else 'fp32'}"
        args = garf_inputs(GARF_RAYS, 192, activation, bf16, 40, dev)
        args = args[1:2] + args[:1] + args[2:] + (1.0,)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        k = cuda_time_ms(lambda: garf_radiance_train_grads(*args), iters=3, warmup=1)
        mem_k = torch.cuda.max_memory_allocated() / 2**30
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        p = cuda_time_ms(lambda: garf_radiance_train_grads_reference(*args), iters=3, warmup=1)
        mem_p = torch.cuda.max_memory_allocated() / 2**30
        torch.cuda.empty_cache()
        ws = train_workspace_bytes(args[1], GARF_RAYS, 192) / 2**30
        times[f"K5_{tag}"] = (k, p)
        log(f"time K5 garf_train {GARF_RAYS}x192 {tag}: kernel {k:.3f} ms (workspace "
            f"{ws:.2f} GiB, peak {mem_k:.1f} GiB), plain {p:.3f} ms (peak {mem_p:.1f} GiB)")
        del args
        rargs = garf_inputs(2 * GARF_RAYS, 192, activation, bf16, 41, dev)
        rargs = rargs[1:2] + rargs[:1] + rargs[2:6] + (1.0,)
        with torch.no_grad():
            k = cuda_time_ms(lambda: garf_radiance_render(*rargs), iters=3, warmup=1)
            p = cuda_time_ms(lambda: garf_radiance_render_reference(*rargs), iters=3, warmup=1)
        times[f"K6_{tag}"] = (k, p)
        log(f"time K6 garf_render {2 * GARF_RAYS}x192 {tag}: kernel {k:.3f} ms, plain "
            f"{p:.3f} ms")
        del rargs
        torch.cuda.empty_cache()

        cfg = garf_system_cfg(activation, bf16)
        params = garf_system.init(torch.Generator().manual_seed(42), cfg).to(dev)
        batch = garf_batch(GARF_RAYS, torch.Generator(device=dev).manual_seed(43), dev)
        res = {}
        for fused in (False, True, True, False):
            state = garf_system.init_state(cfg, copy.deepcopy(params))
            step = (garf_system.make_train_step_fused(cfg) if fused
                    else garf_system.make_train_step(cfg))
            run = lambda: step(state, batch, torch.Generator(device=dev).manual_seed(44), 1.0)
            res.setdefault(fused, []).append(cuda_time_ms(run, iters=3, warmup=1))
            del state
            torch.cuda.empty_cache()
        k, p = min(res[True]), min(res[False])
        times[f"step_{tag}"] = (k, p)
        log(f"GARF train step {tag} ({GARF_RAYS} rays, 64 + 192 samples): fused {res[True]} ms "
            f"-> {GARF_RAYS / k * 1e3:.0f} rays/s; plain {res[False]} ms -> "
            f"{GARF_RAYS / p * 1e3:.0f} rays/s")

        def proposal_stage():  # forward, interlevel loss against fixed weights, backward
            t_s, t_e, aux = garf_system._sample_bins(
                params, cfg, torch.Generator(device=dev).manual_seed(44),
                batch["origs_noisy"], batch["dirs_noisy"], True, 1.0)
            proposal.compute_loss(aux, torch.full_like(t_s, 1.0 / 192)).backward()

        prop_ms = cuda_time_ms(proposal_stage, iters=3, warmup=1)
        log(f"GARF proposal stage {tag} ({GARF_RAYS} rays, 64 bins, fwd + interlevel loss "
            f"+ bwd): {prop_ms:.3f} ms")
        params.zero_grad(set_to_none=True)
        state = garf_system.init_state(cfg, copy.deepcopy(params))
        fused_step = garf_system.make_train_step_fused(cfg)
        profile_step(lambda: fused_step(state, batch,
                                        torch.Generator(device=dev).manual_seed(44), 1.0),
                     f"GARF fused train step {tag}")
        times[f"pack_{tag}"] = time_garf_packing(params.radiance, cfg.net, dev, tag)
        del state, params
        torch.cuda.empty_cache()
    return times


INGP_RAYS = 4096  # bench.py's `ingp` batch
INGP_POINTS = INGP_RAYS * 128  # the fine stage's samples at that batch
INGP_IMAGE = 64
# K7 / K8: relative norm against the plain version; summation order and FMA
# contraction only (both round the same rows to bf16 when asked; K8 sums
# d_table exactly in int64 fixed point and rounds each sum once).
TOL_HASH = 1e-5
HASH_VARIANTS = (("xor", None), ("xor", torch.bfloat16), ("additive", None),
                 ("additive", torch.bfloat16))
# (name, HashGridConfig kwargs, points, variants). An odd table size puts
# every odd level's first row off a row-pair boundary, where the kernels must
# not take their paired row load; the additive hash needs a power of two.
HASH_GRIDS = (
    ("3-D L16 F2 res 16-512", dict(dim=3), INGP_POINTS, HASH_VARIANTS),
    ("2-D L16 F2 res 16-2048", dict(dim=2, resolution_max=2048), 8192, HASH_VARIANTS),
    ("3-D L4 F8 res 16-512", dict(dim=3, n_levels=4, n_features=8), 65536, HASH_VARIANTS),
    ("3-D L16 F2 T 2^16 - 1", dict(dim=3, table_size=2**16 - 1), 65536, HASH_VARIANTS[:2]),
    ("2-D L16 F1 T 2^14 - 1", dict(dim=2, n_features=1, table_size=2**14 - 1,
                                   resolution_max=2048), 8192, HASH_VARIANTS[:2]),
)


def hash_inputs(grid_kw: dict, n: int, seed: int, dev):
    """An N(0, 1) table and n points: random in [0, 1), a quarter of them on
    the grid vertices k / 2^m (exact in fp32 at every level's resolution
    where k res / 2^m is whole), and the origin."""
    from nerf_experiments_tpu_torch.ops import hashgrid

    cfg = hashgrid.HashGridConfig(**grid_kw)
    gen = torch.Generator(device=dev).manual_seed(seed)
    table = torch.randn((cfg.n_levels, cfg.table_size, cfg.n_features), generator=gen,
                        device=dev)
    x = torch.rand((n, cfg.dim), generator=gen, device=dev)
    m = n // 4
    denom = torch.tensor([16.0, 256.0, 512.0], device=dev)[
        torch.randint(0, 3, (m, 1), generator=gen, device=dev)]
    x[:m] = torch.floor(torch.rand((m, cfg.dim), generator=gen, device=dev) * denom) / denom
    x[0] = 0.0
    return cfg, table, x


def phase_hash_forward(dev):
    """K7 against `encode_reference` on the card: 3-D at run_3d_ingp's
    defaults and 524,288 points, 2-D at run_2d_ingp's, F = 8 at 4 levels,
    and odd table sizes (F 2 and 1); xor and additive, fp32 and bf16 rows."""
    from nerf_experiments_tpu_torch.ops import hashgrid

    worst_abs_fp32 = 0.0
    for name, grid_kw, n, variants in HASH_GRIDS:
        cfg, table, x = hash_inputs(grid_kw, n, 50, dev)
        for hash_kind, gather in variants:
            got = hashgrid.hash_encode_fwd_cuda(table, x, cfg, hash_kind, gather)
            ref = hashgrid.encode_reference(table, cfg, x, hash_kind, gather)
            torch.cuda.synchronize()
            err, abs_err = rel_norm(got, ref), max_err(got, ref)
            log(f"K7 hash_encode_fwd {name}, {n} points, {hash_kind} "
                f"{'bf16' if gather else 'fp32'} rows: rel norm err {err:.3e}, max abs err "
                f"{abs_err:.3e}, tol {TOL_HASH}")
            require(err <= TOL_HASH and math.isfinite(err), f"K7 {name} {hash_kind} {gather}")
            if gather is None:
                worst_abs_fp32 = max(worst_abs_fp32, abs_err)
        del table, x
    torch.cuda.empty_cache()
    return worst_abs_fp32


def plain_hash_grads(table, cfg, x, g, hash_kind="xor", gather=None):
    """(d_table, d_x) of the plain version: torch autograd through
    `encode_reference` for the cotangent g (its forward included)."""
    from nerf_experiments_tpu_torch.ops import hashgrid

    table, x = table.detach().requires_grad_(True), x.detach().requires_grad_(True)
    enc = hashgrid.encode_reference(table, cfg, x, hash_kind, gather)
    return torch.autograd.grad(enc, (table, x), g)


def phase_hash_backward(dev):
    """K8 against the plain backward (`plain_hash_grads`) for the same
    settings: d_table and d_x by relative norm; d_table bitwise equal over two
    launches (with d_x and without) and to its
    emulation `dtable_fixed_point_reference` (int64 sums do not depend on the
    order of the atomics); d_x bitwise equal over two launches."""
    from nerf_experiments_tpu_torch.ops import hashgrid

    worst_abs_fp32 = 0.0
    for name, grid_kw, n, variants in HASH_GRIDS:
        cfg, table, x = hash_inputs(grid_kw, n, 51, dev)
        g = torch.randn((n, cfg.output_dim), generator=torch.Generator(dev).manual_seed(52),
                        device=dev)
        for hash_kind, gather in variants:
            got = hashgrid.hash_encode_bwd_cuda(table, x, g, cfg, hash_kind, gather)
            again = hashgrid.hash_encode_bwd_cuda(table, x, g, cfg, hash_kind, gather)
            step = hashgrid.hash_encode_bwd_cuda(table, x, g, cfg, hash_kind, gather,
                                                 need_dx=False)
            ref = plain_hash_grads(table, cfg, x, g, hash_kind, gather)
            emulated = hashgrid.dtable_fixed_point_reference(cfg, x, g, hash_kind)
            torch.cuda.synchronize()
            errs = {"d_table": rel_norm(got[0], ref[0]), "d_x": rel_norm(got[1], ref[1])}
            bitwise = {"two launches": torch.equal(got[0], again[0]),
                       "without d_x": torch.equal(got[0], step[0]),
                       "emulation": torch.equal(got[0], emulated)}
            abs_err = max(max_err(got[0], ref[0]), max_err(got[1], ref[1]))
            log(f"K8 hash_encode_bwd {name}, {n} points, {hash_kind} "
                f"{'bf16' if gather else 'fp32'} rows: rel norm err "
                + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
                + ", d_table bitwise equal over "
                + ", ".join(f"{k}: {v}" for k, v in bitwise.items())
                + f"; max abs err {abs_err:.3e}, tol {TOL_HASH}")
            for k, v in errs.items():
                require(v <= TOL_HASH and math.isfinite(v), f"K8 {name} {hash_kind} {k} {v}")
            for k, v in bitwise.items():
                require(v, f"K8 {name} {hash_kind} {gather}: d_table not bitwise equal ({k})")
            require(torch.equal(got[1], again[1]), f"K8 {name}: d_x differs between launches")
            if gather is None:
                worst_abs_fp32 = max(worst_abs_fp32, abs_err)
            del got, again, step, ref, emulated
        del table, x, g
    cfg, table, x = hash_inputs(dict(dim=3), 4096, 53, dev)
    g = torch.randn((4096, cfg.output_dim), generator=torch.Generator(dev).manual_seed(54),
                    device=dev)
    g[7, 3] = float("nan")
    d_table, _ = hashgrid.hash_encode_bwd_cuda(table, x, g, cfg, need_dx=False)
    require(bool(torch.isnan(d_table).all()), "K8: a NaN cotangent must give a NaN d_table")
    log("K8 with a NaN in the cotangent: d_table all NaN (the trainer's finite guard sees it)")
    torch.cuda.empty_cache()
    return worst_abs_fp32


def fixed_point_precision(table, cfg, x, g, got, hash_kind, label: str) -> dict:
    """K8's d_table `got` for one launch's (x, g) against the sums of its fp32
    terms in float64 (`hashgrid.dtable_terms`) and against the plain fp32
    scatter (`plain_hash_grads`), element by element: K8 cuts every term
    into up to four int64 words, down to a quantum 2^-(s+(W-1)K) (absolute),
    the plain sum's error is relative. Logs the elements that the plain
    backward gives as nonzero and K8 as 0, the smallest |exact| / max|g| of
    the plain backward's nonzero elements, and per band of |exact| / max|g|
    the worst and median relative error of both. Requires every element
    within its terms x 2^-(s+(W-1)K+1) of the exact sum, plus fp32's last
    rounding and the float64 sum's own (2^-46 of its terms' |c|), and no
    element that the plain backward keeps to be 0 in K8 (ROADMAP C4)."""
    from nerf_experiments_tpu_torch.ops import hashgrid

    x, g = x.detach(), g.detach()
    gmax = float(g.abs().max())
    s = hashgrid.fixed_point_shift(gmax, x.shape[0], cfg.dim)
    k = hashgrid.fixed_point_lo_shift(x.shape[0], cfg.dim)
    words = hashgrid.fixed_point_words(s, k)
    last = s + (words - 1) * k
    L, T, F = cfg.n_levels, cfg.table_size, cfg.n_features
    exact = torch.zeros((L * T, F), dtype=torch.float64, device=x.device)
    mass = torch.zeros_like(exact)
    terms = torch.zeros((L * T,), dtype=torch.float64, device=x.device)
    for rows, c in hashgrid.dtable_terms(cfg, x, g, hash_kind):
        exact.index_add_(0, rows, c.double())
        mass.index_add_(0, rows, c.double().abs())
        terms.index_add_(0, rows, torch.ones_like(rows, dtype=torch.float64))
    plain = plain_hash_grads(table, cfg, x, g, hash_kind)[0].reshape(-1).double()
    got, exact, mass = got.reshape(-1).double(), exact.reshape(-1), mass.reshape(-1)
    terms = terms[:, None].expand(-1, F).reshape(-1)
    err = (got - exact).abs()
    allowed = (terms * 2.0 ** -(last + 1) * (1 + 2.0**-22) + exact.abs() * 2.0**-23
               + mass * 2.0**-46)
    require(bool((err <= allowed).all()), f"K8 {label}: an element beyond its quantum")
    lost = int(((plain != 0) & (got == 0)).sum())
    nonzero = int((plain != 0).sum())
    ratio = exact.abs() / gmax
    smallest = float(ratio[(plain != 0) & (exact != 0)].min())
    out = {"shift": s, "lo_shift": k, "words": words, "max_abs_g": gmax,
           "plain_nonzero": nonzero, "k8_zero_of_those": lost, "smallest_ratio": smallest,
           "bands": {}}
    edges = (float("inf"), 2.0**-17, 2.0**-30, 2.0**-40, 2.0**-60, 0.0)
    parts = []
    for hi, lo in zip(edges, edges[1:]):
        sel = (ratio < hi) & (ratio >= lo) & (exact != 0)
        n_sel = int(sel.sum())
        if n_sel == 0:
            continue
        rel_k8 = (err[sel] / exact[sel].abs())
        rel_plain = ((plain[sel] - exact[sel]).abs() / exact[sel].abs())
        band = {"elements": n_sel, "k8_zero": int((got[sel] == 0).sum()),
                "k8_worst": float(rel_k8.max()), "k8_median": float(rel_k8.median()),
                "plain_worst": float(rel_plain.max()), "plain_median": float(rel_plain.median())}
        out["bands"][f"[{lo:.3g}, {hi:.3g})"] = band
        parts.append(f"|exact|/max|g| in [{lo:.3g}, {hi:.3g}): {n_sel} elements, K8 0 in "
                     f"{band['k8_zero']}, rel err K8 worst {band['k8_worst']:.3e} median "
                     f"{band['k8_median']:.3e}, plain worst {band['plain_worst']:.3e} median "
                     f"{band['plain_median']:.3e}")
    log(f"K8 fixed point on {label} ({x.shape[0]} points, max|g| {gmax:.6e}, s {s}, K {k}, "
        f"{words} words, last quantum 2^-{last}): {lost} of the plain backward's {nonzero} "
        f"nonzero d_table elements are 0 in K8 (k8_zero_of_those {lost}); smallest "
        f"|exact|/max|g| of those {smallest:.3e}; " + "; ".join(parts))
    require(lost == 0, f"K8 {label}: {lost} elements the plain backward keeps are 0 in K8")
    return out


def plain_hash_encoding():
    """A context in which the hash encoding runs its plain version
    (`encode_reference` under autograd) on any device: the plain step of
    phases 18 and 20."""
    from unittest import mock

    from nerf_experiments_tpu_torch.ops import hashgrid

    def plain(table, x, cfg, hash_kind, gather_dtype):
        return hashgrid.encode_reference(table, cfg, x, hash_kind, gather_dtype)

    return mock.patch.object(hashgrid.HashEncode, "apply", plain)


def ingp_cfg(bf16: bool):
    """run_3d_ingp's system at its defaults (and the generated 64^2 scene)."""
    from nerf_experiments_tpu_torch.experiments import run_3d_ingp

    args = run_3d_ingp.parse_args(["--image_size", str(INGP_IMAGE), "--seed", "7"]
                                  + (["--bf16"] if bf16 else []))
    return run_3d_ingp.build_config(args)[0]


def ingp_batch(n: int, n_images: int, seed: int, dev) -> dict:
    batch = train_batch(n, n_images, torch.Generator(device=dev).manual_seed(seed), dev)
    batch["colors"] = batch["colors"][:, :1].contiguous()  # no blur pyramid
    return batch


def phase_ingp_train_step(dev):
    """One INGP train step through K7 / K8 against the same step with the
    plain encoding, from one state, batch and generator seed, on the card:
    the loss and every gradient handed to Adam, fp32 and bf16, by relative
    norm. The kernel step takes the plain step's fine bins: they are
    resampled from the coarse weights, which the two encodings round
    differently, and a sample moved by that rounding across a grid cell's
    face changes its coordinate gradient by a step (the interpolant's
    derivative jumps there), which is no error of either."""
    import copy
    from unittest import mock

    from nerf_experiments_tpu_torch.ops import sampling
    from nerf_experiments_tpu_torch.systems import barf as barf_sys

    resample = sampling.sample_pdf_weighted_intervals
    for bf16 in (False, True):
        cfg = ingp_cfg(bf16)
        params = barf_sys.init(torch.Generator().manual_seed(60), cfg).to(dev)
        with torch.no_grad():  # tables away from the init's 1e-4, a camera away from zero
            for net in (params.radiance, params.proposal):
                net.grid.table.uniform_(-0.1, 0.1, generator=torch.Generator(dev).manual_seed(61))
            params.camera.rotation.normal_(0.0, 0.05, generator=torch.Generator(dev).manual_seed(62))
        batch = ingp_batch(INGP_RAYS, cfg.n_training_images, 63, dev)
        out, grads, fine_bins = {}, {}, []
        for kernels in (False, True):
            state = barf_sys.init_state(cfg, copy.deepcopy(params))
            grads[kernels] = {}
            adam_step = state.optimizer.step

            def capture_then_step():  # keep the gradients Adam is handed
                grads[kernels].update({k: p.grad.clone()
                                       for k, p in state.params.named_parameters()})
                adam_step()

            def pinned_fine_bins(*a, **k):
                if kernels:
                    return fine_bins[0]
                fine_bins.append(resample(*a, **k))
                return fine_bins[0]

            state.optimizer.step = capture_then_step
            step = barf_sys.make_train_step(cfg)
            gen = torch.Generator(device=dev).manual_seed(64)
            with mock.patch.object(sampling, "sample_pdf_weighted_intervals", pinned_fine_bins):
                if kernels:
                    state, metrics = step(state, batch, gen, 0.0, 0.0, 0.0)
                else:
                    with plain_hash_encoding():
                        state, metrics = step(state, batch, gen, 0.0, 0.0, 0.0)
            out[kernels] = (float(metrics["loss"]), bool(metrics["grads_finite"]))
        torch.cuda.synchronize()
        loss_err = abs(out[True][0] - out[False][0]) / abs(out[False][0])
        grad_errs = {k: rel_norm(grads[True][k], grads[False][k]) for k in grads[False]}
        worst = max(grad_errs, key=grad_errs.get)
        log(f"INGP train step {'bf16' if bf16 else 'fp32'} ({INGP_RAYS} rays, 64 + 128 "
            f"samples): loss kernels {out[True][0]:.6f} plain {out[False][0]:.6f} rel err "
            f"{loss_err:.3e} (tol {TOL_STEP_LOSS[bf16]}); gradient rel norm err worst {worst} "
            f"{grad_errs[worst]:.3e} over {len(grad_errs)} tensors (tables "
            f"{grad_errs['radiance.grid.table']:.3e} / {grad_errs['proposal.grid.table']:.3e}, "
            f"camera {grad_errs['camera.rotation']:.3e} / {grad_errs['camera.translation']:.3e}"
            f"), tol {TOL_STEP_GRAD[bf16]}")
        require(out[True][1] and out[False][1], "INGP step: non-finite gradients")
        require(loss_err <= TOL_STEP_LOSS[bf16], f"INGP step loss err {loss_err}")
        for k, v in grad_errs.items():
            require(v <= TOL_STEP_GRAD[bf16] and math.isfinite(v), f"INGP gradient {k} err {v}")
        del params, grads, fine_bins
        torch.cuda.empty_cache()


def phase_ingp_training(dev, workdir):
    """The INGP entry points end to end, with K7, K8, K1 and K3 counted:
    `run_3d_ingp.main` at full width on the 64^2 scene (300 steps fp32 with
    checkpoints: the train PSNR must rise by > 1 dB; 20 steps --bf16),
    `render_views --entry ingp` on the checkpoint (a crop against the plain
    CPU path), and `run_2d_ingp.main` at its defaults (val PSNR > 12 dB).
    The fp32 run's last K8 launches (coarse and fine) are kept, and
    `fixed_point_precision` reads K8's d_table for their cotangents."""
    from unittest import mock

    import numpy as np

    from nerf_experiments_tpu_torch.experiments import render_views, run_2d_ingp, run_3d_ingp
    from nerf_experiments_tpu_torch.ops import hashgrid
    from nerf_experiments_tpu_torch.ops.hashgrid import hash_encode_bwd_cuda, hash_encode_fwd_cuda
    from nerf_experiments_tpu_torch.ops.render_cuda import render_bwd_cuda, render_fwd_cuda
    from nerf_experiments_tpu_torch.systems import barf as barf_sys
    from nerf_experiments_tpu_torch.training.checkpoints import CheckpointManager

    fns = {"hash_encode_fwd": hash_encode_fwd_cuda, "hash_encode_bwd": hash_encode_bwd_cuda,
           "render_fwd": render_fwd_cuda, "render_bwd": render_bwd_cuda}
    total = dict.fromkeys(fns, 0)

    def counted(entry, argv):
        for fn in fns.values():
            fn.launches = 0
        result = entry(argv)
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in fns.items()}
        for k, v in launches.items():
            total[k] += v
        return result, launches

    def rows(out):
        return [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]

    base = ["--image_size", str(INGP_IMAGE), "--batch_size", str(INGP_RAYS), "--seed", "7",
            "--device", str(dev)]
    out = os.path.join(workdir, "ingp_fp32")
    steps = 300
    last_launch = {}  # points -> the last K8 launch's (table, x, g, cfg, hash)
    backward = hashgrid.HashEncode.backward

    def keep(ctx, g):
        table, x = ctx.saved_tensors
        last_launch[x.shape[0]] = (table, x, g.contiguous()) + ctx.args[:2]
        return backward(ctx, g)

    with mock.patch.object(hashgrid.HashEncode, "backward", staticmethod(keep)):
        state, launches = counted(run_3d_ingp.main, base + [
            "--max_steps", str(steps), "--checkpoint_every_n_epochs", "10", "--out_dir", out])
    r = rows(out)
    psnrs = [x["psnr"] for x in r if "psnr" in x and math.isfinite(x["psnr"])]
    rates = [x["train_rays_per_sec"] for x in r if "train_rays_per_sec" in x]
    vals = [x["val_psnr"] for x in r if "val_psnr" in x]
    ckpts = CheckpointManager(os.path.join(out, "ckpt")).all_steps()
    log(f"run_3d_ingp fp32 {INGP_IMAGE}^2 batch {INGP_RAYS}: {state.step} steps, psnr "
        f"{psnrs[0]:.3f} -> {psnrs[-1]:.3f} over {len(psnrs)} log rows (validation "
        f"{vals[0]:.3f} -> {vals[-1]:.3f}), last train_rays_per_sec {rates[-1]:.0f}, "
        f"checkpoints {ckpts}, launches {launches}")
    require(state.step == steps and ckpts[-1] == steps, "run_3d_ingp fp32 run")
    require(psnrs[-1] > psnrs[0] + 1.0, f"run_3d_ingp PSNR did not rise by 1 dB: {psnrs}")
    require(launches["hash_encode_bwd"] == 2 * steps, "K8 not twice on every step")
    require(launches["hash_encode_fwd"] >= 2 * steps, "K7 not twice on every step")
    require(launches["render_fwd"] >= 2 * steps and launches["render_bwd"] == 2 * steps,
            "K1 / K3 not on every step")
    for n, (table, x, g, cfg, hash_kind) in sorted(last_launch.items()):
        d_table, _ = hash_encode_bwd_cuda(table, x, g, cfg, hash_kind, need_dx=False)
        fixed_point_precision(table, cfg, x, g, d_table, hash_kind,
                              f"run_3d_ingp fp32 step {steps}'s {n}-point launch")
    del last_launch
    torch.cuda.empty_cache()

    out_bf16 = os.path.join(workdir, "ingp_bf16")
    state, launches = counted(run_3d_ingp.main, base + [
        "--max_steps", "20", "--bf16", "--out_dir", out_bf16])
    losses = [x["loss"] for x in rows(out_bf16) if "loss" in x]
    log(f"run_3d_ingp bf16: {state.step} steps, loss {losses[-1]:.5f}, launches {launches}")
    require(state.step == 20 and all(math.isfinite(v) for v in losses), "run_3d_ingp bf16")
    require(launches["hash_encode_bwd"] == 40, "bf16: K8 not twice on every step")

    ckpt = os.path.join(out, "ckpt")
    serve = ["--entry", "ingp", "--samples_per_ray", "128", "--samples_per_ray_proposal", "64",
             "--hidden_dim", "64", "--n_hidden", "2", "--image_size", str(INGP_IMAGE),
             "--seed", "7"]
    summary, launches = counted(render_views.main, [
        "--ckpt_dir", ckpt, "--split", "test", "--n_images", "2", "--chunk", str(INGP_RAYS),
        "--device", str(dev), "--out_dir", os.path.join(out, "render")] + serve)
    log(f"render_views --entry ingp on the trained checkpoint (step {summary['ckpt_step']}): "
        f"mean_psnr {summary['mean_psnr']:.3f}, launches {launches}")
    require(summary["ckpt_step"] == steps and math.isfinite(summary["mean_psnr"]),
            "render_views --entry ingp")
    require(launches["hash_encode_fwd"] > 0 and launches["render_fwd"] > 0,
            "render_views --entry ingp: K7 / K1 never launched")

    # a crop of test view 0 through the kernels vs the plain path on the CPU
    cfg, dm = render_views._build_ingp(render_views.parse_args(["--ckpt_dir", ckpt] + serve))
    params = CheckpointManager(ckpt).restore(barf_sys.init(torch.Generator().manual_seed(7), cfg))
    dm.setup("test")
    ds = dm.dataset_test
    raw = torch.as_tensor(dm.dataset_train.camera_origins)
    noisy = torch.as_tensor(dm.dataset_train.camera_origins_noisy)
    lo, hi = INGP_IMAGE * INGP_IMAGE // 2, INGP_IMAGE * INGP_IMAGE // 2 + 512
    rays = (ds.ray_origins[0][lo:hi], ds.ray_directions[0][lo:hi])
    with torch.no_grad():
        plain = render_views.render_image(params, cfg, *rays, barf_sys.val_gauge(params, raw, noisy),
                                          float(ds.pixel_width), 512, "cpu", 0.0, 0.0)
        params.to(dev)
        kern = render_views.render_image(
            params, cfg, *rays, barf_sys.val_gauge(params, raw.to(dev), noisy.to(dev)),
            float(ds.pixel_width), 512, dev, 0.0, 0.0)
    err = float(np.abs(kern - plain).max())
    log(f"render_views --entry ingp: 512-ray crop, kernel path vs plain CPU path max abs err "
        f"{err:.3e}, tol {TOL_FP32}")
    require(err <= TOL_FP32, f"ingp crop err {err}")

    out_2d = os.path.join(workdir, "ingp_2d")
    (_, _, result), launches = counted(run_2d_ingp.main, ["--device", str(dev),
                                                          "--out_dir", out_2d])
    log(f"run_2d_ingp at its defaults (256^2, batch 8192, 2000 steps): val_psnr "
        f"{result['val_psnr']:.3f} (JAX test gate 12 dB), launches {launches}")
    require(result["val_psnr"] > 12.0, f"run_2d_ingp val_psnr {result['val_psnr']}")
    require(launches["hash_encode_bwd"] == 2000, "run_2d_ingp: K8 not on every step")
    return total


def phase_ingp_timing(dev):
    """K7 / K8 by device time per call at run_3d_ingp's defaults, at the fine
    stage's 524,288 points (4096 rays x 128 samples) and the coarse stage's
    262,144 (x 64): K8 without d_x (the table gradient alone, `index_add_`'s
    work) and with d_x (as the INGP step launches it), against
    their plain versions, the library calls that do their table access alone
    (`index_select` of the precomputed global rows, `index_add_` of the
    contributions) and their bounds; the INGP train step with the kernels
    against the plain encoding at 4096 rays, in turns; a profile of one step
    with K7's and K8's device ms and the idle share."""
    import copy

    from nerf_experiments_tpu_torch.ops import hashgrid
    from nerf_experiments_tpu_torch.systems import barf as barf_sys

    times = {}
    calls = 50
    for n in (INGP_POINTS, INGP_POINTS // 2):
        cfg, table, x = hash_inputs(dict(dim=3), n, 70, dev)
        g = torch.randn((n, cfg.output_dim), generator=torch.Generator(dev).manual_seed(71),
                        device=dev)
        T, F = cfg.table_size, cfg.n_features
        rows = torch.cat([hashgrid._level_rows_and_offsets(cfg, res, x, "xor")[0].reshape(-1)
                          + l * T for l, res in enumerate(cfg.level_resolutions)])
        flat = table.reshape(-1, F)
        contrib = torch.randn((rows.shape[0], F), generator=torch.Generator(dev).manual_seed(72),
                              device=dev)
        # the 8 MiB table stays in L2 from call to call, as it does through a
        # step, and the bound counts it once; the output (K7) and the
        # cotangent (K8), 67 MB at 524,288 points, exceed the L2
        t = {"K7": (device_ms(lambda: hashgrid.hash_encode_fwd_cuda(table, x, cfg), calls),
                    device_ms(lambda: hashgrid.encode_reference(table, cfg, x), calls),
                    device_ms(lambda: torch.index_select(flat, 0, rows), calls)),
             "K8_no_dx": (device_ms(lambda: hashgrid.hash_encode_bwd_cuda(
                 table, x, g, cfg, need_dx=False), calls),),
             "K8": (device_ms(lambda: hashgrid.hash_encode_bwd_cuda(table, x, g, cfg), calls),
                    device_ms(lambda: plain_hash_grads(table, cfg, x, g), calls),
                    device_ms(lambda: torch.zeros_like(flat).index_add_(0, rows, contrib),
                              calls))}
        b = hash_bounds(n)
        library = {"K7": "index_select", "K8_no_dx": "index_add_", "K8": "index_add_"}
        for k, name, key in (("K7", "hash_encode_fwd", "hash_encode_fwd"),
                             ("K8_no_dx", "hash_encode_bwd without d_x", "hash_encode_bwd_no_dx"),
                             ("K8", "hash_encode_bwd with d_x", "hash_encode_bwd")):
            ms = t[k][0]
            lib_ms = t["K8"][2] if k == "K8_no_dx" else t[k][2]
            line = (f"time {k.split('_')[0]} {name} {n} points 3-D L16 F2 T 2^16 fp32, device "
                    f"time per call over {calls} calls: kernel {ms:.4f} ms, bound "
                    f"{b[key][0]:.4f} ms ({b[key][1]}, {b[key][0] / ms:.3f} of it), "
                    f"library ({library[k]} of {rows.shape[0]} rows) {lib_ms:.4f} ms "
                    f"(kernel / library {ms / lib_ms:.3f})")
            if k != "K8_no_dx":
                line += f", plain {t[k][1]:.4f} ms" + (" (d_table and d_x)" if k == "K8" else "")
            log(line)
        suffix = "" if n == INGP_POINTS else f"_{n}"
        times.update({k + suffix: v for k, v in t.items()})
        del table, x, g, rows, flat, contrib
        torch.cuda.empty_cache()

    for bf16 in (False, True):
        tag = "bf16" if bf16 else "fp32"
        cfg = ingp_cfg(bf16)
        params = barf_sys.init(torch.Generator().manual_seed(73), cfg).to(dev)
        batch = ingp_batch(INGP_RAYS, cfg.n_training_images, 74, dev)
        res = {}
        for kernels in (False, True, True, False):
            state = barf_sys.init_state(cfg, copy.deepcopy(params))
            step = barf_sys.make_train_step(cfg)
            run = lambda: step(state, batch, torch.Generator(device=dev).manual_seed(75),
                               0.0, 0.0, 0.0)
            if kernels:
                ms = cuda_time_ms(run, iters=5, warmup=2)
            else:
                with plain_hash_encoding():
                    ms = cuda_time_ms(run, iters=5, warmup=2)
            res.setdefault(kernels, []).append(ms)
            del state
            torch.cuda.empty_cache()
        k, p = min(res[True]), min(res[False])
        times[f"step_{tag}"] = (k, p)
        log(f"INGP train step {tag} ({INGP_RAYS} rays, 64 + 128 samples): kernels {res[True]} "
            f"ms -> {INGP_RAYS / k * 1e3:.0f} rays/s; plain encoding {res[False]} ms -> "
            f"{INGP_RAYS / p * 1e3:.0f} rays/s")
        state = barf_sys.init_state(cfg, copy.deepcopy(params))
        step = barf_sys.make_train_step(cfg)
        wall, total, by_name = profile_step(
            lambda: step(state, batch, torch.Generator(device=dev).manual_seed(75), 0.0, 0.0,
                         0.0), f"INGP train step {tag}")
        k7 = sum(v for k, v in by_name.items() if "hash_fwd_kernel" in k)
        k8 = sum(v for k, v in by_name.items() if any(
            f in k for f in ("hash_bwd_", "hash_dx_kernel", "abs_max_kernel", "fixed_to_float")))
        times[f"profile_{tag}"] = (wall, total, k7, k8)
        log(f"profile INGP train step {tag}: K7 {k7:.4f} ms, K8 {k8:.4f} ms (its kernels; its "
            f"two memsets are counted with the step's) of {total:.4f} ms device time, host "
            f"wall {wall:.4f} ms, idle share {max(0.0, 1 - total / wall):.4f}")
        del state, params
        torch.cuda.empty_cache()
    return times


# ---- the Mip / BIP slice: K9 / K10 (the fused MLP chain) and K11


MIP_RAYS = 1024  # the train batch of phases 23-25
MIP_ROWS = MIP_RAYS * (192 + 64)  # the rows one step's chains take: fine + proposal samples
MIP_IMAGE = 32
# K9 / K10: relative norm of y, dx and every dW / db against the plain
# version, as K4's: fp32 summation order only; bf16 both round the same
# operands, and the summation order can move an activation by a bf16 step.
TOL_CHAIN = {False: TOL_K4_FP32, True: TOL_K4_BF16}


def mip_config(bf16: bool = False, fused: bool = False):
    """(BarfConfig, data module) of run_mip_nerf at its full width (IPE 10 /
    Fourier 4, 4x256 x 2 segments, 192 + 64 samples with a shared net,
    density scale 21) on the 32^2 scene, batch 1024; with `fused` the
    radiance field is the fused-chain plug `FusedNerfMLPDef` of the same
    config, as `BarfConfig(radiance=FusedNerfMLPDef(cfg))` builds it."""
    import dataclasses

    from nerf_experiments_tpu_torch.experiments import run_mip_nerf
    from nerf_experiments_tpu_torch.systems import barf as barf_sys

    args = run_mip_nerf.parse_args(["--image_size", str(MIP_IMAGE), "--batch_size",
                                    str(MIP_RAYS), "--seed", "7"] + (["--bf16"] if bf16 else []))
    cfg, dm = run_mip_nerf.build_config(args)
    if fused:
        cfg = dataclasses.replace(cfg, radiance=barf_sys.FusedNerfMLPDef(cfg.radiance))
    return cfg, dm


def chain_layers(params):
    """The three chains of a NerfMLP: (name, layers) of segment 1, segment 2
    and the colour head."""
    return [("segment 1", list(params.segments[0].layers)),
            ("segment 2", list(params.segments[1].layers)),
            ("colour head", list(params.color))]


def chain_dims(layers) -> list:
    return [layers[0].w.shape[0]] + [l.w.shape[1] for l in layers]


def chain_name(layers) -> str:
    return "->".join(map(str, chain_dims(layers)))


def chain_inputs(layers, rows: int, seed: int, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.rand((rows, layers[0].w.shape[0]), generator=gen, device=dev) * 2.0 - 1.0
    g = torch.randn((rows, layers[-1].w.shape[1]), generator=gen, device=dev)
    return x, g


def plain_chain64(x, layers, g):
    """The plain chain and its backward in float64: (y, dx, [dW_i], [db_i])."""
    leaves = [x.double().requires_grad_(True)]
    leaves += [t.detach().double().requires_grad_(True) for l in layers for t in (l.w, l.b)]
    with torch.enable_grad():
        h = leaves[0]
        for i in range(len(layers)):
            h = h @ leaves[1 + 2 * i] + leaves[2 + 2 * i]
            if i < len(layers) - 1:
                h = torch.relu(h)
        grads = torch.autograd.grad(h, leaves, g.double())
    return h.detach(), grads[0], list(grads[1::2]), list(grads[2::2])


def relu_flips(x, layers, g) -> int:
    """The hidden units whose ReLU K10's recomputed forward (the activations
    its row pass stores, fp32) and the plain fp32 forward decide
    differently."""
    from nerf_experiments_tpu_torch.ops import fused_mlp as fm

    dims = chain_dims(layers)
    act = torch.empty((x.shape[0], sum(dims[:-1])), device=x.device)
    fm.fused_mlp_bwd_cuda(x, layers, g, False, act=act)
    flips, off, h = 0, dims[0], x
    with torch.no_grad():
        for i, layer in enumerate(layers[:-1]):
            h = torch.relu(h @ layer.w + layer.b)
            flips += int(((act[:, off:off + dims[i + 1]] > 0) != (h > 0)).sum())
            off += dims[i + 1]
    return flips


def phase_fused_mlp(dev):
    """K9 / K10 against the plain chain (`fused_chain_reference`, and
    autograd through it) on the card: run_mip_nerf's three chains (63 ->
    4x256 -> 256, 319 -> 4x256 -> 257, 280 -> 128 -> 3) and a one-layer
    chain (319 -> 256) at one step's 262,144 rows and the ragged 40,037 (3
    dW splits) and 1,000, fp32 and bf16; y, dx and every dW / db by relative
    norm, and two K10 launches bitwise equal. fp32 also prints, as a
    diagnostic beside the gate, the plain fp32 chain's own error against a
    float64 chain and the ReLUs K10's forward and the plain one decide
    differently (`relu_flips`)."""
    from nerf_experiments_tpu_torch.models import nerf_mlp
    from nerf_experiments_tpu_torch.ops import fused_mlp as fm

    worst = {"fused_mlp_fwd": 0.0, "fused_mlp_bwd": 0.0}
    for bf16 in (False, True):
        dtype = torch.bfloat16 if bf16 else None
        cfg, _ = mip_config(bf16)
        params = nerf_mlp.init(torch.Generator().manual_seed(20), cfg.radiance).to(dev)
        chains = chain_layers(params) + [("one layer", [params.segments[1].layers[0]])]
        for name, layers in chains:
            for rows in (MIP_ROWS, 40_037, 1000):
                x, g = chain_inputs(layers, rows, 21, dev)
                with torch.no_grad():
                    y = fm.fused_mlp_fwd_cuda(x, layers, bf16)
                    y_ref = fm.fused_chain_reference(x, layers, dtype)
                got = fm.fused_mlp_bwd_cuda(x, layers, g, bf16)
                again = fm.fused_mlp_bwd_cuda(x, layers, g, bf16)
                ref = fm.fused_chain_bwd_reference(x, layers, g, dtype)
                torch.cuda.synchronize()
                got_all, ref_all = [got[0], *got[1], *got[2]], [ref[0], *ref[1], *ref[2]]
                bitwise = all(torch.equal(a, b) for a, b in
                              zip(got_all, [again[0], *again[1], *again[2]]))
                names = (["dx"] + [f"dW{i}" for i in range(len(layers))]
                         + [f"db{i}" for i in range(len(layers))])
                errs = {"y": rel_norm(y, y_ref)}
                errs.update({n: rel_norm(a, b) for n, a, b in zip(names, got_all, ref_all)})
                worst_k = max(errs, key=errs.get)
                tol = TOL_CHAIN[bf16]
                diag = ""
                if not bf16:  # diagnostic only: the gate is TOL_CHAIN
                    y64, dx64, dw64, db64 = plain_chain64(x, layers, g)
                    plain = dict(zip(["y"] + names, [rel_norm(a, b) for a, b in zip(
                        [y_ref, *ref_all], [y64, dx64, *dw64, *db64])]))
                    plain_k = max(plain, key=plain.get)
                    units = rows * sum(chain_dims(layers)[1:-1])
                    diag = (f"; plain fp32 vs float64: y {plain['y']:.3e} dx {plain['dx']:.3e}, "
                            f"worst {plain_k} {plain[plain_k]:.3e}; ReLU flips kernel vs plain "
                            f"{relu_flips(x, layers, g)} of {units}")
                    del y64, dx64, dw64, db64
                log(f"K9/K10 fused_mlp {name} {chain_name(layers)} {rows} rows "
                    f"{'bf16' if bf16 else 'fp32'}: rel norm err y {errs['y']:.3e} dx "
                    f"{errs['dx']:.3e}, worst {worst_k} {errs[worst_k]:.3e} over {len(errs)} "
                    f"outputs, tol {tol}; K10 bitwise equal over two launches: {bitwise}{diag}")
                require(bitwise, f"K10 {name} {rows} rows: two launches differ")
                for k, v in errs.items():
                    require(v <= tol and math.isfinite(v),
                            f"K9/K10 {name} {rows} bf16={bf16} {k} err {v} > {tol}")
                if not bf16:
                    worst["fused_mlp_fwd"] = max(worst["fused_mlp_fwd"], max_err(y, y_ref))
                    worst["fused_mlp_bwd"] = max(worst["fused_mlp_bwd"], *(
                        max_err(a, b) for a, b in zip(got_all, ref_all)))
                del x, g, y, y_ref, got, again, ref, got_all, ref_all
        del params
        torch.cuda.empty_cache()
    return worst


def phase_render_megakernel(dev):
    """K11 (`render_megakernel.flagship_render`: equidistant bins shifted by
    a per-ray offset, through K2's kernel) against its plain version at the
    flagship width: 8192 rays x 128 samples fp32 and bf16 and a ragged 37
    rays, offsets in [-interval, 0) as run_barf's offset -1 draws them; and
    its refusal of a config that is not the flagship's."""
    import dataclasses

    from nerf_experiments_tpu_torch.models import nerf_mlp
    from nerf_experiments_tpu_torch.ops import render_megakernel as rm

    gen = torch.Generator(device=dev).manual_seed(30)
    s, near = 128, 2.0
    worst = 0.0
    for n, bf16 in ((N_RAYS, False), (N_RAYS, True), (37, False)):
        cfg = flagship_cfg(bf16)
        params = nerf_mlp.init(torch.Generator().manual_seed(3), cfg).to(dev)
        origs, dirs = random_rays(n, gen, dev)
        offsets = -torch.rand((n, 1), generator=gen, device=dev) * (FAR - near) / s
        args = (params, cfg, origs, dirs, offsets, 7.5, 2.5, s, near, FAR)
        with torch.no_grad():
            got = rm.flagship_render(*args)
            ref = rm.render_megakernel_reference(*args)
        torch.cuda.synchronize()
        err = max_err(got, ref)
        tol = TOL_BF16 if bf16 else TOL_FP32
        log(f"K11 render_megakernel {n}x{s} {'bf16' if bf16 else 'fp32'}, per-ray offsets: "
            f"rgb max abs err {err:.3e}, tol {tol}")
        require(err <= tol and math.isfinite(err), f"K11 n={n} bf16={bf16} err {err}")
        if not bf16:
            worst = max(worst, err)
    bad = dataclasses.replace(flagship_cfg(False), delayed_density=True)
    try:
        rm.flagship_render(params, bad, origs, dirs, offsets, 7.5, 2.5, s, near, FAR)
    except ValueError:
        log("K11 refuses a config that is not the flagship's (ValueError)")
    else:
        raise AssertionError("K11 took a config that is not the flagship's")
    return worst


def mip_batch(dm, n: int, seed: int, dev) -> dict:
    """A train batch of n rays from the scene's ray store on the card (the
    Mip config's near / far 1/10 - 1/3 hold in its space transform, not for
    `random_rays`)."""
    from nerf_experiments_tpu_torch.data import sampler

    dm.setup("fit")
    store = sampler.make_ray_store(dm.dataset_train, dev)
    idx = torch.randint(0, store.n_rays, (n,), generator=torch.Generator(dev).manual_seed(seed),
                        device=dev)
    return sampler.gather_batch_arrays(store.arrays(), store.pixel_width, idx)


def phase_fused_plug_step(dev):
    """One plain train step of the Mip-NeRF config with `FusedNerfMLPDef`
    (K9 / K10 in both stages) against the same step with `NerfMLPDef`, from
    one state, batch and generator seed, fp32 and bf16: the loss and every
    gradient handed to Adam at phase 8's tolerances. The fused step takes
    the plain step's fine bins, which are resampled from coarse weights that
    the two paths round differently (phase 18's reason)."""
    import copy
    from unittest import mock

    from nerf_experiments_tpu_torch.ops import sampling
    from nerf_experiments_tpu_torch.systems import barf as barf_sys

    resample = sampling.sample_pdf_weighted_intervals
    for bf16 in (False, True):
        cfgs = {fused: mip_config(bf16, fused)[0] for fused in (False, True)}
        cfg, dm = mip_config(bf16)
        params = barf_sys.init(torch.Generator().manual_seed(40), cfg).to(dev)
        batch = mip_batch(dm, MIP_RAYS, 41, dev)
        out, grads, fine_bins = {}, {}, []
        for fused in (False, True):
            state = barf_sys.init_state(cfgs[fused], copy.deepcopy(params))
            grads[fused] = {}
            adam_step = state.optimizer.step

            def capture_then_step():  # keep the gradients Adam is handed
                grads[fused].update({k: p.grad.clone()
                                     for k, p in state.params.named_parameters()})
                adam_step()

            def pinned_fine_bins(*a, **k):
                if not fine_bins:
                    fine_bins.append(resample(*a, **k))
                return fine_bins[0]

            state.optimizer.step = capture_then_step
            step = barf_sys.make_train_step(cfgs[fused])
            gen = torch.Generator(device=dev).manual_seed(42)
            with mock.patch.object(sampling, "sample_pdf_weighted_intervals", pinned_fine_bins):
                state, metrics = step(state, batch, gen, 0.0, 0.0, 0.0)
            out[fused] = (float(metrics["loss"]), bool(metrics["grads_finite"]))
        torch.cuda.synchronize()
        loss_err = abs(out[True][0] - out[False][0]) / abs(out[False][0])
        grad_errs = {k: rel_norm(grads[True][k], grads[False][k]) for k in grads[False]}
        worst = max(grad_errs, key=grad_errs.get)
        log(f"Mip-NeRF train step {'bf16' if bf16 else 'fp32'} ({MIP_RAYS} rays, 192 + 64 "
            f"samples): loss FusedNerfMLPDef {out[True][0]:.6f} NerfMLPDef {out[False][0]:.6f} "
            f"rel err {loss_err:.3e} (tol {TOL_STEP_LOSS[bf16]}); gradient rel norm err worst "
            f"{worst} {grad_errs[worst]:.3e} over {len(grad_errs)} tensors, tol "
            f"{TOL_STEP_GRAD[bf16]}")
        require(out[True][1] and out[False][1], "Mip step: non-finite gradients")
        require(loss_err <= TOL_STEP_LOSS[bf16], f"Mip step loss err {loss_err}")
        for k, v in grad_errs.items():
            require(v <= TOL_STEP_GRAD[bf16] and math.isfinite(v), f"Mip gradient {k} err {v}")
        del params, grads, fine_bins
        torch.cuda.empty_cache()


def phase_mip_training(dev, workdir):
    """The slice's entry points end to end on the 32^2 scene, with K9, K10,
    K11, K1 and K3 counted: `run_mip_nerf.main` at full width (300 steps: the
    train PSNR must rise by > 1 dB; then --resume), `run_bip_barf.main` (20
    steps), `render_views --entry mip|bip` on their checkpoints (each a crop
    against the plain CPU path), the `FusedNerfMLPDef` configuration through
    `build_barf_experiment` and the trainer (200 steps: K9 / K10 on every
    chain of both stages, the PSNR rises by > 1 dB), a few steps of each
    thin entry point, and phase 9's BARF checkpoint served through K11."""
    import numpy as np

    from nerf_experiments_tpu_torch.cameras import calibration
    from nerf_experiments_tpu_torch.experiments import (
        common, render_views, run_barf, run_bip_barf, run_mip_blur_test, run_mip_nerf,
        run_naive_as_barf, run_naive_to_vanilla, run_sampling_test, run_vanilla_as_barf)
    from nerf_experiments_tpu_torch.ops import render_megakernel
    from nerf_experiments_tpu_torch.ops.fused_mlp import fused_mlp_bwd_cuda, fused_mlp_fwd_cuda
    from nerf_experiments_tpu_torch.ops.render_cuda import render_bwd_cuda, render_fwd_cuda
    from nerf_experiments_tpu_torch.systems import barf as barf_sys
    from nerf_experiments_tpu_torch.training.checkpoints import CheckpointManager
    from nerf_experiments_tpu_torch.training.trainer import TrainerConfig

    fns = {"fused_mlp_fwd": fused_mlp_fwd_cuda, "fused_mlp_bwd": fused_mlp_bwd_cuda,
           "render_megakernel": render_megakernel.flagship_render,
           "render_fwd": render_fwd_cuda, "render_bwd": render_bwd_cuda}
    total = dict.fromkeys(fns, 0)

    def counted(entry, *a):
        for fn in fns.values():
            fn.launches = 0
        result = entry(*a)
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in fns.items()}
        for k, v in launches.items():
            total[k] += v
        return result, launches

    def psnrs(out):
        rows = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
        return ([r["psnr"] for r in rows if "psnr" in r and math.isfinite(r["psnr"])],
                [r["train_rays_per_sec"] for r in rows if "train_rays_per_sec" in r])

    base = ["--image_size", str(MIP_IMAGE), "--batch_size", str(MIP_RAYS), "--seed", "7",
            "--device", str(dev)]
    out_mip = os.path.join(workdir, "mip")
    steps = 300
    state, launches = counted(run_mip_nerf.main, base + [
        "--max_steps", str(steps), "--checkpoint_every_n_epochs", "10", "--out_dir", out_mip])
    p, rates = psnrs(out_mip)
    log(f"run_mip_nerf fp32 {MIP_IMAGE}^2 batch {MIP_RAYS} (192 + 64 samples, 4x256): "
        f"{state.step} steps, psnr {p[0]:.3f} -> {p[-1]:.3f} over {len(p)} log rows, last "
        f"train_rays_per_sec {rates[-1]:.0f}, launches {launches}")
    require(state.step == steps and p[-1] > p[0] + 1.0, f"run_mip_nerf PSNR {p}")
    require(launches["render_bwd"] == 2 * steps and launches["render_fwd"] >= 2 * steps,
            "run_mip_nerf: K1 / K3 not in both stages of every step")
    state, launches = counted(run_mip_nerf.main, base + [
        "--max_steps", str(steps + 10), "--resume", "--checkpoint_every_n_epochs", "10",
        "--out_dir", out_mip])
    log(f"run_mip_nerf --resume: {state.step} steps, launches {launches}")
    require(state.step == steps + 10 and launches["render_bwd"] == 20, "run_mip_nerf --resume")

    out_bip = os.path.join(workdir, "bip")
    state, launches = counted(run_bip_barf.main, base + [
        "--max_steps", "20", "--out_dir", out_bip])
    p, _ = psnrs(out_bip)
    log(f"run_bip_barf fp32 {MIP_IMAGE}^2 (126 samples, offset -1, blur and IPE sigma 200): "
        f"{state.step} steps, psnr {p[-1]:.3f}, launches {launches}")
    require(state.step == 20 and launches["render_bwd"] == 20, "run_bip_barf")

    serve = {"mip": (out_mip, ["--samples_per_ray", "192", "--samples_per_ray_proposal", "64"],
                     steps + 10),
             "bip": (out_bip, ["--samples_per_ray", "126"], 20)}
    for entry, (out, flags, last) in serve.items():
        ckpt = os.path.join(out, "ckpt")
        argv = (["--ckpt_dir", ckpt, "--entry", entry, "--image_size", str(MIP_IMAGE),
                 "--seed", "7"] + flags)
        summary, launches = counted(render_views.main, argv + [
            "--split", "test", "--n_images", "2", "--chunk", "4096", "--device", str(dev),
            "--out_dir", os.path.join(out, "render")])
        log(f"render_views --entry {entry} (step {summary['ckpt_step']}): mean_psnr "
            f"{summary['mean_psnr']:.3f}, launches {launches}")
        require(summary["ckpt_step"] == last and math.isfinite(summary["mean_psnr"])
                and launches["render_fwd"] > 0, f"render_views --entry {entry}")
        # a crop of test view 0 on the card vs the plain path on the CPU
        cfg, dm = {"mip": render_views._build_mip, "bip": render_views._build_bip}[entry](
            render_views.parse_args(argv))
        params = CheckpointManager(ckpt).restore(
            barf_sys.init(torch.Generator().manual_seed(7), cfg))
        dm.setup("test")
        ds = dm.dataset_test
        raw = torch.as_tensor(dm.dataset_train.camera_origins)
        noisy = torch.as_tensor(dm.dataset_train.camera_origins_noisy)
        lo = MIP_IMAGE * MIP_IMAGE // 2
        rays = (ds.ray_origins[0][lo:lo + 256], ds.ray_directions[0][lo:lo + 256])
        alphas = barf_sys.model_def(cfg.radiance).full_alphas()
        with torch.no_grad():
            plain = render_views.render_image(params, cfg, *rays,
                                              barf_sys.val_gauge(params, raw, noisy),
                                              float(ds.pixel_width), 256, "cpu", *alphas)
            params.to(dev)
            kern = render_views.render_image(
                params, cfg, *rays, barf_sys.val_gauge(params, raw.to(dev), noisy.to(dev)),
                float(ds.pixel_width), 256, dev, *alphas)
        err = float(np.abs(kern - plain).max())
        log(f"render_views --entry {entry}: 256-ray crop, card vs plain CPU path max abs err "
            f"{err:.3e}, tol {TOL_FP32}")
        require(err <= TOL_FP32, f"{entry} crop err {err}")

    # the fused-chain plug, as the JAX package's tests reach it
    cfg, dm = mip_config(fused=True)
    out_fused = os.path.join(workdir, "mip_fused")
    fused_steps = 200
    exp = common.build_barf_experiment(
        cfg, dm, TrainerConfig(max_steps=fused_steps, batch_size=MIP_RAYS, seed=7),
        out_fused, device=dev, image_log_names=((), ["r_2"]))
    state, launches = counted(exp.fit)
    p, rates = psnrs(out_fused)
    log(f"FusedNerfMLPDef Mip-NeRF fp32 through build_barf_experiment: {state.step} steps, "
        f"psnr {p[0]:.3f} -> {p[-1]:.3f} over {len(p)} log rows, last train_rays_per_sec "
        f"{rates[-1]:.0f}, launches {launches}")
    require(state.step == fused_steps and p[-1] > p[0] + 1.0, f"FusedNerfMLPDef PSNR {p}")
    require(launches["fused_mlp_bwd"] == 6 * fused_steps
            and launches["fused_mlp_fwd"] >= 6 * fused_steps,
            "FusedNerfMLPDef: K9 / K10 not on the 3 chains of both stages of every step")
    require(launches["render_bwd"] == 2 * fused_steps, "FusedNerfMLPDef: K3 not on every step")

    thin = (("run_vanilla_as_barf", run_vanilla_as_barf.main, []),
            ("run_naive_as_barf", run_naive_as_barf.main, []),
            ("run_mip_blur_test", run_mip_blur_test.main, []),
            ("run_naive_to_vanilla", run_naive_to_vanilla.main, []),
            ("run_sampling_test", run_sampling_test.main, ["--steps_per_cell", "3"]))
    for name, main_fn, extra in thin:
        out = os.path.join(workdir, name)
        steps_flag = [] if extra else ["--max_steps", "5", "--checkpoint_every_n_epochs", "0"]
        result, launches = counted(main_fn, base + steps_flag + extra + ["--out_dir", out])
        log(f"{name}: {len(result) if isinstance(result, list) else result.step} "
            f"{'cells' if isinstance(result, list) else 'steps'}, launches {launches}")
        require(launches["render_bwd"] >= 5 or (extra and launches["render_bwd"] >= 6 * 3),
                f"{name}: the compositing backward not on every step")

    # serving through K11: phase 9's dense BARF checkpoint, test view 0
    dense = run_barf.parse_args(["--image_size", "32", "--samples_per_ray", "128",
                                 "--camera_origin_noise_sigma", "0.0",
                                 "--camera_rotation_noise_sigma", "0.0"])
    cfg, dm = run_barf.build_config(dense)
    params = CheckpointManager(os.path.join(workdir, "train_dense", "ckpt")).restore(
        barf_sys.init(torch.Generator().manual_seed(7), cfg)).to(dev)
    dm.setup("test")
    ds = dm.dataset_test
    raw = torch.as_tensor(dm.dataset_train.camera_origins, device=dev)
    noisy = torch.as_tensor(dm.dataset_train.camera_origins_noisy, device=dev)
    target = torch.as_tensor(ds.images[0, :, :, -1, :].reshape(-1, 3), device=dev)
    with torch.no_grad():
        gauge = barf_sys.val_gauge(params, raw, noisy)
        o, d = calibration.validation_transform_rays(
            torch.as_tensor(ds.ray_origins[0], device=dev),
            torch.as_tensor(ds.ray_directions[0], device=dev), gauge)
        o, d = o.contiguous(), d.contiguous()
        alphas = barf_sys.model_def(cfg.radiance).full_alphas()
        n = o.shape[0]
        interval = (cfg.far - cfg.near) / cfg.samples_per_ray_radiance
        offsets = {"0": torch.zeros((n, 1), device=dev),
                   "-U(0, 1) interval": -torch.rand(
                       (n, 1), generator=torch.Generator(dev).manual_seed(43), device=dev)
                   * interval}
        images = {}
        for tag, off in offsets.items():
            rgb, launches = counted(render_megakernel.flagship_render, params.radiance,
                                    cfg.radiance, o, d, off, *alphas,
                                    cfg.samples_per_ray_radiance, cfg.near, cfg.far,
                                    cfg.density_scale)
            images[tag] = rgb.clamp(0.0, 1.0)
            mse = float(((images[tag] - target) ** 2).mean())
            log(f"K11 serving phase 9's BARF checkpoint, test view 0 ({n} rays x "
                f"{cfg.samples_per_ray_radiance} samples), offsets {tag}: psnr "
                f"{-10 * math.log10(mse):.3f}, launches {launches}")
            require(launches["render_megakernel"] == 1, "K11 not launched")
    k2 = render_views.render_image(params, cfg, ds.ray_origins[0], ds.ray_directions[0],
                                   gauge, float(ds.pixel_width), n, dev, *alphas)
    err = max_err(images["0"].cpu(), torch.as_tensor(k2))
    log(f"K11 with zero offsets vs render_views' K2 path on the same view: max abs err "
        f"{err:.3e}, tol {TOL_FP32}")
    require(err <= TOL_FP32, f"K11 vs K2 view err {err}")
    return total


def library_chain(x, ws, bs):
    """The chain as one cuBLAS call a layer (`torch.addmm`) and a ReLU, in
    the inputs' type (fp32; or bf16 on the tensor cores, bf16 outputs)."""
    h = x
    for i, (w, b) in enumerate(zip(ws, bs)):
        h = torch.addmm(b, h, w)
        if i < len(ws) - 1:
            h = torch.relu(h)
    return h


def time_chains(dev) -> dict:
    """K9 / K10 on run_mip_nerf's three chains at 262,144 rows (one step's
    rows), summed, against the plain version and the cuBLAS chain
    (`torch.addmm` + ReLU a layer, fp32 with TF32 off, and bf16; K10's: its
    forward and autograd's backward), fp32 and bf16. The kernels take the
    packs `FusedChain` would hand them (packed once, outside the timing; the
    packing's own time is printed)."""
    from nerf_experiments_tpu_torch.models import nerf_mlp
    from nerf_experiments_tpu_torch.ops import fused_mlp as fm

    times = {}
    cfg, _ = mip_config()
    params = nerf_mlp.init(torch.Generator().manual_seed(20), cfg.radiance).to(dev)
    for bf16 in (False, True):
        tag = "bf16" if bf16 else "fp32"
        dtype = torch.bfloat16 if bf16 else None
        lib_dtype = torch.bfloat16 if bf16 else torch.float32
        tot = dict.fromkeys(("k9", "p9", "l9", "k10", "p10", "l10", "pack"), 0.0)
        for name, layers in chain_layers(params):
            x, g = chain_inputs(layers, MIP_ROWS, 22, dev)
            lw = [l.w.detach().to(lib_dtype).requires_grad_(True) for l in layers]
            lb = [l.b.detach().to(lib_dtype).requires_grad_(True) for l in layers]
            xl, gl = x.to(lib_dtype).requires_grad_(True), g.to(lib_dtype)
            packs = fm.pack_chain(layers, bf16, True, dev)

            def lib_bwd():
                y = library_chain(xl, lw, lb)
                return torch.autograd.grad(y, [xl, *lw, *lb], gl)

            with torch.no_grad():
                t = {"k9": cuda_time_ms(lambda: fm.fused_mlp_fwd_cuda(x, layers, bf16,
                                                                      packed=packs[0])),
                     "p9": cuda_time_ms(lambda: fm.fused_chain_reference(x, layers, dtype)),
                     "l9": cuda_time_ms(lambda: library_chain(xl, lw, lb))}
            t.update(k10=cuda_time_ms(lambda: fm.fused_mlp_bwd_cuda(x, layers, g, bf16,
                                                                    packed=packs)),
                     p10=cuda_time_ms(lambda: fm.fused_chain_bwd_reference(x, layers, g, dtype)),
                     l10=cuda_time_ms(lib_bwd),
                     pack=host_ms(lambda: fm.pack_chain(layers, bf16, True, dev)))
            log(f"time K9/K10 {name} {chain_name(layers)} {MIP_ROWS} rows {tag}: K9 "
                f"{t['k9']:.3f} ms (plain {t['p9']:.3f}, cuBLAS addmm chain {t['l9']:.3f}); K10 "
                f"{t['k10']:.3f} ms (plain {t['p10']:.3f}, cuBLAS chain forward + backward "
                f"{t['l10']:.3f}; workspace "
                f"{fm.bwd_workspace_bytes(MIP_ROWS, chain_dims(layers), bf16) / 2**30:.2f} GiB); "
                f"packing W and W^T {t['pack']:.3f} ms host")
            for k in tot:
                tot[k] += t[k]
            del x, g, xl, gl, lw, lb, packs
            torch.cuda.empty_cache()
        times[f"K9_{tag}"] = (tot["k9"], tot["p9"], tot["l9"])
        times[f"K10_{tag}"] = (tot["k10"], tot["p10"], tot["l10"])
        log(f"time K9/K10 the three chains, {MIP_ROWS} rows {tag}: K9 {tot['k9']:.3f} ms "
            f"(plain {tot['p9']:.3f}, cuBLAS {tot['l9']:.3f}), K10 {tot['k10']:.3f} ms (plain "
            f"{tot['p10']:.3f}, cuBLAS {tot['l10']:.3f}); packing {tot['pack']:.3f} ms host")
    return times


def phase_mip_timing(dev):
    """K9 / K10 against the plain chain and the cuBLAS chain (`time_chains`),
    K11 against its plain version and K2 at 8192 x 128, and the Mip-NeRF
    train step at batch 1024 with `FusedNerfMLPDef` against `NerfMLPDef`, in
    turns, with a profile of one step of each."""
    import copy

    from nerf_experiments_tpu_torch.models import nerf_mlp
    from nerf_experiments_tpu_torch.ops import render_megakernel as rm
    from nerf_experiments_tpu_torch.ops import train_megakernel
    from nerf_experiments_tpu_torch.systems import barf as barf_sys

    times = time_chains(dev)
    _, dm = mip_config()
    gen = torch.Generator(device=dev).manual_seed(31)
    s, near = 128, 2.0
    origs, dirs = random_rays(N_RAYS, gen, dev)
    offsets = -torch.rand((N_RAYS, 1), generator=gen, device=dev) * (FAR - near) / s
    fcfg = flagship_cfg(False)
    fparams = nerf_mlp.init(torch.Generator().manual_seed(3), fcfg).to(dev)
    args = (fparams, fcfg, origs, dirs, offsets, 7.5, 2.5, s, near, FAR)
    ts, te = rm.equidistant_bins(offsets, s, near, FAR)
    with torch.no_grad():
        k = cuda_time_ms(lambda: rm.flagship_render(*args))
        p = cuda_time_ms(lambda: rm.render_megakernel_reference(*args))
        k2 = cuda_time_ms(lambda: train_megakernel.flagship_render(
            fparams, fcfg, origs, dirs, ts, te, 7.5, 2.5))
    times["K11"] = (k, p, k2)
    log(f"time K11 render_megakernel {N_RAYS}x{s} fp32: kernel {k:.3f} ms, plain {p:.3f} ms; "
        f"K2 on the same bins {k2:.3f} ms")

    batch = mip_batch(dm, MIP_RAYS, 44, dev)
    for bf16 in (False, True):
        tag = "bf16" if bf16 else "fp32"
        cfgs = {fused: mip_config(bf16, fused)[0] for fused in (False, True)}
        bparams = barf_sys.init(torch.Generator().manual_seed(45), cfgs[False]).to(dev)
        res = {}
        for fused in (False, True, True, False):
            state = barf_sys.init_state(cfgs[fused], copy.deepcopy(bparams))
            step = barf_sys.make_train_step(cfgs[fused])
            run = lambda: step(state, batch, torch.Generator(device=dev).manual_seed(46),
                               0.0, 0.0, 0.0)
            res.setdefault(fused, []).append(cuda_time_ms(run, iters=3, warmup=1))
            del state
            torch.cuda.empty_cache()
        k, p = min(res[True]), min(res[False])
        times[f"step_{tag}"] = (k, p)
        log(f"Mip-NeRF train step {tag} ({MIP_RAYS} rays, 192 + 64 samples): FusedNerfMLPDef "
            f"{res[True]} ms -> {MIP_RAYS / k * 1e3:.0f} rays/s; NerfMLPDef {res[False]} ms -> "
            f"{MIP_RAYS / p * 1e3:.0f} rays/s")
        for fused in (True, False):
            state = barf_sys.init_state(cfgs[fused], copy.deepcopy(bparams))
            step = barf_sys.make_train_step(cfgs[fused])
            profile_step(lambda: step(state, batch, torch.Generator(device=dev).manual_seed(46),
                                      0.0, 0.0, 0.0),
                         f"Mip-NeRF train step {tag} {'FusedNerfMLPDef' if fused else 'NerfMLPDef'}")
            del state
            torch.cuda.empty_cache()
    return times


# Peak rates of one H100 SXM (NVIDIA's data sheet), for the bounds: HBM, fp32
# on the CUDA cores, and the dense tensor-core rates of TF32 and bf16.
# ---- the occupancy grid and block-coarse training and serving (phases 26-29)

# north_star_occ_S32's grid (bench.py:66-130, :413-445): R 64 (262,144
# cells), 64 coarse bins, a refresh every 16 steps; 32 fine samples
OCC_S32 = ["--samples_per_ray", "32", "--occ_grid_resolution", "64"]
BLK4 = ["--train_coarse_block", "4", "--fused_kernel"]
# the slice's BARF configs at full width: north_star_occ_S32 and the blk4
# rows in bf16, and their fp32 counterparts (K4's fp32 tile)
SLICE_CONFIGS = {
    "north_star_S32 bf16": NORTHSTAR,
    "north_star_occ_S32 bf16": OCC_S32 + ["--bf16"],
    "north_star_S32_blk4 bf16": NORTHSTAR + BLK4,
    "north_star_occ_S32_blk4 bf16": OCC_S32 + ["--bf16"] + BLK4,
    "north_star_S32 fp32": NORTHSTAR[:-1],
    "north_star_occ_S32 fp32": OCC_S32,
    "north_star_S32_blk4 fp32": NORTHSTAR[:-1] + BLK4,
    "north_star_occ_S32_blk4 fp32": OCC_S32 + BLK4,
}
A_POS, A_DIR = 10.0, 4.0  # every level on, the serving direction alpha
STEP_RAYS = 1024  # the rays of a step comparison (phase 8's)


def slice_config(name: str):
    from nerf_experiments_tpu_torch.experiments import run_barf

    args = run_barf.parse_args(["--image_size", str(IMAGE_SIZE), "--seed", "7"]
                               + SLICE_CONFIGS[name])
    return run_barf.build_config(args)[0]


def launch_counters() -> dict:
    from nerf_experiments_tpu_torch.ops.garf_megakernel import (
        garf_radiance_render, garf_radiance_train_grads)
    from nerf_experiments_tpu_torch.ops.render_cuda import render_bwd_cuda, render_fwd_cuda
    from nerf_experiments_tpu_torch.ops.train_megakernel import (
        flagship_render, flagship_train_grads)

    return {"render_fwd": render_fwd_cuda, "render_bwd": render_bwd_cuda,
            "flagship_render": flagship_render, "flagship_train": flagship_train_grads,
            "garf_train": garf_radiance_train_grads, "garf_render": garf_radiance_render}


def counted_run(main, argv):
    """`main(argv)` with every count set to 0 just before and read just
    after: (its result, {kernel: launches})."""
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    out = main(argv)
    torch.cuda.synchronize()
    return out, {k: fn.launches for k, fn in counters.items()}


def add_launches(total: dict, launches: dict) -> dict:
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v
    return total


@contextlib.contextmanager
def plain_kernels(compositing: bool = True):
    """The flagship train and render kernels, the serving proposal kernel
    and the GARF train kernel (and, with `compositing`, the compositing
    kernels) replaced by their plain versions on any device: the reference of
    a step or render that has no plain counterpart of its own (block-coarse)."""
    from unittest import mock

    from nerf_experiments_tpu_torch.ops import (
        garf_megakernel, proposal_bins, render, train_megakernel)
    from nerf_experiments_tpu_torch.systems import barf, garf_system

    with contextlib.ExitStack() as stack:
        for module, name, plain in (
                (barf, "flagship_train_grads", train_megakernel.flagship_train_grads_reference),
                (barf, "flagship_render", train_megakernel.flagship_render_reference),
                (barf, "proposal_bins", proposal_bins.proposal_bins_reference),
                (garf_system, "garf_radiance_train_grads",
                 garf_megakernel.garf_radiance_train_grads_reference),
                (render, "render_rays_auto", render.render_rays if compositing else None)):
            if plain is not None:
                stack.enter_context(mock.patch.object(module, name, plain))
        yield


def under_plain_kernels(fn, compositing: bool = True):
    def run(*args, **kw):
        with plain_kernels(compositing):
            return fn(*args, **kw)
    return run


@contextlib.contextmanager
def fine_bins(record=None, pinned=None):
    """`sampling.sample_pdf_weighted_intervals` (the fine bins' resampling)
    with its bins appended to the list `record`, or replaced by `pinned`
    (t_start, t_end)."""
    from unittest import mock

    from nerf_experiments_tpu_torch.ops import sampling

    real = sampling.sample_pdf_weighted_intervals

    def resample(*args, **kw):
        if pinned is not None:
            return pinned
        out = real(*args, **kw)
        record.append(tuple(t.clone() for t in out))
        return out

    with mock.patch.object(sampling, "sample_pdf_weighted_intervals", resample):
        yield


def with_fine_bins(fn, **kw):
    def run(*args, **fkw):
        with fine_bins(**kw):
            return fn(*args, **fkw)
    return run


def check_coarse_compositing(cfg, params, batch, dev, name: str) -> None:
    """K1 / K3 on the block-coarse proposal stage's own inputs (every 4th ray
    of the batch, 64 coarse samples through the proposal net) against the
    plain compositing: rgb and weights forward, the gradients of the
    densities and colours for random cotangents; max abs error over the
    reference's max abs value, TOL_K3."""
    from nerf_experiments_tpu_torch.cameras import calibration
    from nerf_experiments_tpu_torch.ops import render, sampling
    from nerf_experiments_tpu_torch.ops.render_cuda import render_rays_cuda
    from nerf_experiments_tpu_torch.systems import barf as barf_sys

    blk = cfg.train_coarse_block
    with torch.no_grad():
        origs, dirs = calibration.training_transform_rays(
            params.camera, batch["img_idx"], batch["origs_noisy"], batch["dirs_noisy"])
        origs, dirs = origs[::blk].contiguous(), dirs[::blk].contiguous()
        ts, te = sampling.sample_stratified(
            torch.Generator(device=dev).manual_seed(46), origs.shape[0],
            cfg.samples_per_ray_proposal, cfg.near, cfg.far, cfg.uniform_sampling_strategy,
            cfg.uniform_sampling_offset_size, device=dev)
        dens, rgb = barf_sys._eval_model(*barf_sys._proposal_model(params, cfg), origs, dirs,
                                         ts, te, batch["pixel_width"][::blk], 7.5, 2.5,
                                         cfg.integration_strategy)
    gen = torch.Generator(device=dev).manual_seed(47)
    g_rgb = torch.randn(rgb.shape[:1] + (3,), generator=gen, device=dev)
    g_w = torch.randn(dens.shape, generator=gen, device=dev)
    out = {}
    for tag, fn in (("kernel", render_rays_cuda), ("plain", render.render_rays)):
        d, c = dens.float().clone().requires_grad_(True), rgb.float().clone().requires_grad_(True)
        fwd = fn(d, c, te - ts)
        out[tag] = (*(t.detach() for t in fwd), *torch.autograd.grad(fwd, (d, c), (g_rgb, g_w)))
    errs = {k: max_err(a, b) / max(float(b.abs().max()), 1e-30)
            for k, a, b in zip(("rgb", "weights", "d_densities", "d_colours"),
                               out["kernel"], out["plain"])}
    log(f"K1 / K3 on the {name} coarse stage ({dens.shape[0]} rays x {dens.shape[1]}): "
        f"max abs err / max abs " + json.dumps({k: float(f"{v:.3e}") for k, v in errs.items()})
        + f", tol {TOL_K3}")
    for k, v in errs.items():
        require(v <= TOL_K3 and math.isfinite(v), f"{name} coarse compositing {k} err {v}")


@contextlib.contextmanager
def deterministic():
    """torch's deterministic algorithms (the camera gather's backward sums
    without atomics), warnings only where an op has none: for the bitwise
    resume checks. Logs which ops warned."""
    import warnings

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield
    finally:
        torch.use_deterministic_algorithms(False)
    ops = sorted({str(w.message).split(" does not have")[0][:80] for w in caught
                  if "deterministic" in str(w.message)})
    if ops:
        log(f"  deterministic mode: no deterministic version of {ops}")


def check_refresh(cfg, params, dev, name: str) -> None:
    """The occupancy refresh (`occgrid.update_grid` over the radiance net's
    density at 262,144 jittered cell centres, through `_occ_density_fn`)
    against the same refresh with the net in float64 (TF32 off) and the same
    jitter. Both refresh a zero grid, so every cell takes the net's density
    (softplus: positive); at least 0.999 of the cells must. A random net's
    densities sit at softplus(~0) = 0.69 with a spread of ~0.2 %, so the error
    is taken relative to the reference's spread about its mean, ||got - want||
    / ||want - mean(want)||, which a norm relative to the densities
    themselves would hide: fp32 within TOL_FP32, bf16 within TOL_K4_BF16 (its
    weights and activations rounded to bf16)."""
    import copy
    import dataclasses

    from nerf_experiments_tpu_torch.ops import occgrid
    from nerf_experiments_tpu_torch.systems import barf as barf_sys

    u = torch.rand((cfg.occ.n_cells, 3), generator=torch.Generator(dev).manual_seed(40),
                   device=dev)
    grid = torch.zeros(cfg.occ.n_cells, device=dev)
    cfg64 = dataclasses.replace(cfg, radiance=dataclasses.replace(cfg.radiance,
                                                                  compute_dtype=None))
    with torch.no_grad():
        got = occgrid.update_grid(grid, cfg.occ, barf_sys._occ_density_fn(
            cfg, params.radiance, A_POS, A_DIR), u=u)
        want = occgrid.update_grid(grid.double(), cfg64.occ, barf_sys._occ_density_fn(
            cfg64, copy.deepcopy(params.radiance).double(), A_POS, A_DIR), u=u.double())
    bf16 = cfg.radiance.compute_dtype is not None
    tol = TOL_K4_BF16 if bf16 else TOL_FP32
    spread = want - want.mean()
    err = float((got.double() - want).norm() / spread.norm().clamp_min(1e-30))
    moved = float((got > 0).float().mean())
    log(f"occupancy refresh {name} ({cfg.occ.n_cells} cells, from a zero grid) against "
        f"float64: {moved:.4f} of the cells took the net's density; densities mean "
        f"{float(want.mean()):.4f}, spread (std / mean) {float(spread.std() / want.mean()):.3e}; "
        f"err / spread {err:.3e} (tol {tol}); rel norm err {rel_norm(got, want):.3e}")
    require(moved >= 0.999, f"refresh {name}: only {moved} of the cells took the density")
    require(err <= tol and math.isfinite(err), f"refresh {name}: err {err}")


def check_step_refresh(cfg, params, batch, dev, seed: int, name: str) -> None:
    """The refresh inside the fused step at step 0, from a zero grid: the
    grid the step leaves is bitwise the refresh of its updated net at the
    step's alphas with the jitter stream the step derives (mix_seed(seed,
    0x0CC)), and every cell holds the net's density."""
    import copy

    from nerf_experiments_tpu_torch.ops import occgrid
    from nerf_experiments_tpu_torch.systems import barf as barf_sys
    from nerf_experiments_tpu_torch.utils.seeds import mix_seed

    state = barf_sys.init_state(cfg, copy.deepcopy(params))
    state.params.occ.zero_()
    state, _ = barf_sys.make_train_step(cfg, fused=True)(
        state, batch, torch.Generator(device=dev).manual_seed(seed), 7.5, 2.5, 0.0)
    with torch.no_grad():
        again = occgrid.update_grid(
            torch.zeros_like(state.params.occ), cfg.occ,
            barf_sys._occ_density_fn(cfg, state.params.radiance, 7.5, 2.5),
            torch.Generator(dev).manual_seed(mix_seed(seed, 0x0CC)))
    same = torch.equal(state.params.occ, again)
    filled = float((state.params.occ > 0).float().mean())
    log(f"fused step {name} at step 0 from a zero grid: the grid it leaves is bitwise the "
        f"refresh of its updated net: {same}; {filled:.4f} of the cells hold a density")
    require(same and filled >= 0.999, f"{name}: the step's refresh")


def occupied(params, cfg):
    """`params` with an occupancy grid that is not uniform: a refresh of an
    empty grid from a dense ball of radius 0.6 at the origin (a random net's
    density fills every cell about alike)."""
    from nerf_experiments_tpu_torch.ops import occgrid

    def ball(pos):
        return torch.where(pos.norm(dim=-1) < 0.6, 50.0, 0.0)

    with torch.no_grad():
        params.occ.copy_(occgrid.update_grid(torch.zeros_like(params.occ), cfg.occ, ball,
                                             torch.Generator(params.occ.device).manual_seed(42)))
    return params


def phase_occ(dev, workdir):
    """The occupancy grid at full width: the north_star_occ_S32 fused step
    (K4) against the plain step (bf16, fp32), the refresh against float64,
    `run_barf --occ_grid_resolution 64 --fused_kernel` (train PSNR rises; a
    resume bitwise equal to the uninterrupted run; the grid in the
    checkpoint) and `render_views --serve_block 1 | 4` on its checkpoint."""
    import functools

    import numpy as np

    from nerf_experiments_tpu_torch.experiments import render_views, run_barf
    from nerf_experiments_tpu_torch.systems import barf as barf_sys
    from nerf_experiments_tpu_torch.training.checkpoints import CheckpointManager

    for name in ("north_star_occ_S32 bf16", "north_star_occ_S32 fp32"):
        cfg = slice_config(name)
        params = perturbed_camera(barf_sys.init(torch.Generator().manual_seed(8), cfg).to(dev),
                                  dev, 9)
        batch = train_batch(STEP_RAYS, cfg.n_training_images,
                            torch.Generator(device=dev).manual_seed(10), dev)
        with torch.no_grad():  # the step-0 refresh then writes the net's density everywhere
            params.occ.zero_()
        step_pair(f"train step {name} (step 0 from a zero grid: the refresh follows the "
                  f"update), fused against plain", functools.partial(barf_sys.init_state, cfg),
                  params, batch,
                  (barf_sys.make_train_step(cfg), barf_sys.make_train_step(cfg, fused=True)),
                  (7.5, 2.5, 0.0), cfg.radiance.compute_dtype is not None, dev, 11)
        check_step_refresh(cfg, params, batch, dev, 11, name)
        check_refresh(cfg, params, dev, name)

    flags = SLICE_CONFIGS["north_star_occ_S32 bf16"]
    base = ["--image_size", str(IMAGE_SIZE), "--batch_size", str(N_RAYS), "--seed", "7",
            "--log_every_n_steps", "8", "--alpha_decay_start_step", "0",
            "--alpha_decay_end_step", "1", "--fused_kernel", "--device", str(dev),
            "--checkpoint_every_n_epochs", "100"] + flags
    steps, split = 48, 32
    straight_dir, split_dir = (os.path.join(workdir, d) for d in ("occ_straight", "occ_split"))
    total = {}
    with deterministic():
        straight, launches = counted_run(run_barf.main, base + [
            "--max_steps", str(steps), "--out_dir", straight_dir])
        first, _ = counted_run(run_barf.main, base + [
            "--max_steps", str(split), "--out_dir", split_dir])
        resumed, resumed_launches = counted_run(run_barf.main, base + [
            "--max_steps", str(steps), "--out_dir", split_dir, "--resume"])
    add_launches(total, launches)
    rows = [json.loads(line) for line in open(os.path.join(straight_dir, "metrics.jsonl"))]
    psnrs = [r["psnr"] for r in rows if "psnr" in r and math.isfinite(r["psnr"])]
    rates = [r["train_rays_per_sec"] for r in rows if "train_rays_per_sec" in r]
    blob = torch.load(os.path.join(split_dir, "ckpt", f"ckpt_{split}.pt"), weights_only=True)
    diff = [k for (k, a), b in zip(resumed.params.state_dict().items(),
                                   straight.params.state_dict().values()) if not torch.equal(a, b)]
    log(f"run_barf north_star_occ_S32 bf16 {IMAGE_SIZE}^2 batch {N_RAYS}: {straight.step} "
        f"steps, psnr {psnrs[0]:.3f} -> {psnrs[-1]:.3f} over {len(psnrs)} log rows, last "
        f"train_rays_per_sec {rates[-1]:.0f}, launches {launches}; {split} steps + --resume to "
        f"{resumed.step} ({resumed_launches['flagship_train']} K4 launches) against {steps} in "
        f"one go: tensors that differ {diff}; the grid in the checkpoint: "
        f"{torch.equal(blob['params']['occ'], first.params.occ.cpu())}")
    require(straight.step == steps and resumed.step == steps, "occ runs")
    require(psnrs[-1] > psnrs[0] + 1.0, f"occ run: PSNR did not rise by 1 dB: {psnrs}")
    require(launches["flagship_train"] == steps, "occ run: K4 not on every step")
    require(resumed_launches["flagship_train"] == steps - split, "occ resume: K4 launches")
    require(not diff, f"occ resume not bitwise equal to the uninterrupted run: {diff}")
    require(torch.equal(blob["params"]["occ"], first.params.occ.cpu())
            and not bool((blob["params"]["occ"] == 1.0).all()), "occ grid not in the checkpoint")

    ckpt = os.path.join(straight_dir, "ckpt")
    serve = ["--ckpt_dir", ckpt, "--split", "test", "--n_images", "2", "--chunk", str(N_RAYS),
             "--device", str(dev), "--image_size", str(IMAGE_SIZE), "--seed", "7"] + flags
    for block in (1, 4):
        summary, launches = counted_run(render_views.main, serve + [
            "--serve_block", str(block), "--out_dir", os.path.join(workdir, f"occ_serve{block}")])
        add_launches(total, launches)
        log(f"render_views --serve_block {block} on the occupancy checkpoint (step "
            f"{summary['ckpt_step']}): mean_psnr {summary['mean_psnr']:.3f}, launches {launches}")
        require(summary["ckpt_step"] == steps and math.isfinite(summary["mean_psnr"]),
                f"render_views --serve_block {block}")
        require(launches["flagship_render"] > 0, f"serve_block {block}: K2 never launched")

    # a crop of a test view served with block 4: the kernel path against the
    # plain path on the CPU
    cfg = slice_config("north_star_occ_S32 bf16")
    dm = run_barf.build_config(run_barf.parse_args(
        ["--image_size", str(IMAGE_SIZE), "--seed", "7"] + flags))[1]
    dm.setup("test")
    ds = dm.dataset_test
    params = CheckpointManager(ckpt).restore(barf_sys.init(torch.Generator(), cfg))
    raw = torch.as_tensor(dm.dataset_train.camera_origins)
    noisy = torch.as_tensor(dm.dataset_train.camera_origins_noisy)
    lo = IMAGE_SIZE * IMAGE_SIZE // 2
    args = (ds.ray_origins[0][lo:lo + 512], ds.ray_directions[0][lo:lo + 512])
    with torch.no_grad():
        plain = render_views.render_image(params, cfg, *args, barf_sys.val_gauge(params, raw,
                                                                                 noisy),
                                          float(ds.pixel_width), 512, "cpu", A_POS, A_DIR, 4)
        params.to(dev)
        kern = render_views.render_image(params, cfg, *args, barf_sys.val_gauge(
            params, raw.to(dev), noisy.to(dev)), float(ds.pixel_width), 512, dev, A_POS, A_DIR, 4)
    err = float(np.abs(kern - plain).max())
    log(f"serve_block 4, 512-ray crop: kernel path against the plain CPU path max abs err "
        f"{err:.3e}, tol {TOL_BF16}")
    require(err <= TOL_BF16, f"serve_block 4 crop err {err}")
    return total


def phase_block_coarse(dev, workdir):
    """Block-coarse BARF at full width: the north_star_S32_blk4 and
    north_star_occ_S32_blk4 fused steps (bf16, fp32) against the same steps
    with K4's plain version, and (proposal) with every kernel's plain
    version on the kernel step's fine bins, the bins' shift between K1 and
    plain compositing and the all-plain step on its own bins logged beside
    (gated in bf16); K1 / K3 on the coarse stage's inputs;
    `render_block_coarse` with block 1 bitwise equal to the deterministic
    `forward` (kernels on), and with block 4 against its plain-kernel
    version; `run_barf --train_coarse_block 4` trains and resumes."""
    import copy
    import functools

    from nerf_experiments_tpu_torch.experiments import run_barf
    from nerf_experiments_tpu_torch.systems import barf as barf_sys

    # K4 against its plain version, then (proposal configs) every kernel
    # against its plain version on the kernel step's own fine bins: K1's last
    # bits move some resampled bins, and the 10-level encoding magnifies a
    # moved bin in the first layer's gradient, so the all-plain step that
    # resamples its own bins is logged beside them as the witness
    for name in ("north_star_S32_blk4 bf16", "north_star_occ_S32_blk4 bf16",
                 "north_star_S32_blk4 fp32", "north_star_occ_S32_blk4 fp32"):
        cfg = slice_config(name)
        params = perturbed_camera(barf_sys.init(torch.Generator().manual_seed(8), cfg).to(dev),
                                  dev, 9)
        batch = train_batch(STEP_RAYS, cfg.n_training_images,
                            torch.Generator(device=dev).manual_seed(10), dev)
        step = barf_sys.make_train_step(cfg, fused=True)
        bf16 = cfg.radiance.compute_dtype is not None
        pair = functools.partial(step_pair, init_state=functools.partial(barf_sys.init_state, cfg),
                                 params=params, batch=batch, scalars=(7.5, 2.5, 0.0), bf16=bf16,
                                 dev=dev, seed=11)
        pair(f"train step {name}, K4 against its plain version",
             steps=(under_plain_kernels(step, compositing=False), step))
        if not cfg.use_proposal:
            continue  # the occupancy grid has no kernel: K4 is every kernel of this step
        check_coarse_compositing(cfg, params, train_batch(
            N_RAYS, cfg.n_training_images, torch.Generator(device=dev).manual_seed(12), dev),
            dev, name)
        bins = {}
        for tag, fn in (("kernel", step), ("plain", under_plain_kernels(step))):
            with fine_bins(record=bins.setdefault(tag, [])):
                fn(barf_sys.init_state(cfg, copy.deepcopy(params)), batch,
                   torch.Generator(device=dev).manual_seed(11), 7.5, 2.5, 0.0)
        (ks, ke), (ps, pe) = bins["kernel"][0], bins["plain"][0]
        shift = torch.maximum((ks - ps).abs(), (ke - pe).abs())
        width = (cfg.far - cfg.near) / ks.shape[1]
        log(f"{name} fine bins, K1 against plain compositing ({ks.shape[0]} x {ks.shape[1]}): "
            f"{float((shift > 0).float().mean()):.4f} of the bin edges moved, the largest by "
            f"{float(shift.max()):.3e} ({float(shift.max()) / width:.3e} of a uniform bin)")
        pair(f"train step {name}, every kernel against its plain version, each resampling "
             f"its own fine bins", steps=(under_plain_kernels(step), step), gate=bf16)
        again = []
        pair(f"train step {name}, every kernel against its plain version on the kernel "
             f"step's fine bins", steps=(with_fine_bins(under_plain_kernels(step),
                                                        pinned=bins["kernel"][0]),
                                         with_fine_bins(step, record=again)))
        require(torch.equal(again[0][0], ks) and torch.equal(again[0][1], ke),
                f"{name}: the kernel step's fine bins are not repeatable")

    gen = torch.Generator(device=dev).manual_seed(43)
    origs, dirs = random_rays(N_RAYS, gen, dev)
    pw = torch.full((N_RAYS, 1), 1e-3, device=dev)
    for name in ("north_star_occ_S32 bf16", "north_star_S32 bf16"):
        cfg = slice_config(name)
        params = barf_sys.init(torch.Generator().manual_seed(44), cfg).to(dev)
        if cfg.use_occ:
            occupied(params, cfg)
        with torch.no_grad():
            one = barf_sys.render_block_coarse(params, cfg, origs, dirs, A_POS, A_DIR, block=1)
            ref, _ = barf_sys.forward(params, cfg, None, origs, dirs, pw, A_POS, A_DIR,
                                      stratified=False, fused=True)
            four = barf_sys.render_block_coarse(params, cfg, origs, dirs, A_POS, A_DIR, block=4)
            with plain_kernels():
                four_plain = barf_sys.render_block_coarse(params, cfg, origs, dirs, A_POS,
                                                          A_DIR, block=4)
        torch.cuda.synchronize()
        err = max_err(four, four_plain)
        log(f"render_block_coarse {name} ({N_RAYS} rays): block 1 bitwise equal to forward: "
            f"{torch.equal(one, ref)}; block 4 kernels against plain versions max abs err "
            f"{err:.3e} (tol {TOL_BF16}); block 4 against block 1 max abs diff "
            f"{max_err(four, one):.3e}")
        require(torch.equal(one, ref), f"render_block_coarse {name}: block 1 is not forward")
        require(err <= TOL_BF16, f"render_block_coarse {name}: block 4 err {err}")

    out = os.path.join(workdir, "blk4")
    base = ["--image_size", str(IMAGE_SIZE), "--batch_size", str(N_RAYS), "--seed", "7",
            "--log_every_n_steps", "10", "--device", str(dev), "--out_dir", out,
            "--checkpoint_every_n_epochs", "100"] + SLICE_CONFIGS["north_star_S32_blk4 bf16"]
    state, launches = counted_run(run_barf.main, base + ["--max_steps", "20"])
    state, resumed = counted_run(run_barf.main, base + ["--max_steps", "30", "--resume"])
    losses = [json.loads(line).get("loss") for line in open(os.path.join(out, "metrics.jsonl"))]
    losses = [v for v in losses if v is not None]
    log(f"run_barf north_star_S32_blk4 bf16 {IMAGE_SIZE}^2 batch {N_RAYS}: 20 steps, then "
        f"--resume to {state.step}; loss {losses[0]:.5f} -> {losses[-1]:.5f}, launches "
        f"{launches} and {resumed}")
    require(state.step == 30 and all(math.isfinite(v) for v in losses), "blk4 run")
    for k in ("flagship_train", "render_bwd"):  # K1 also runs validation and images
        require(launches[k] == 20 and resumed[k] == 10, f"blk4 run: {k} not once a step")
    require(launches["render_fwd"] >= 20 and resumed["render_fwd"] >= 10,
            "blk4 run: K1 not on every step")
    return add_launches(launches, resumed)


def phase_garf_block_coarse(dev, workdir):
    """Block-coarse GARF (garf_fused_blk4, bench.py:197-208, :443-445): the
    fused step with train_coarse_block 4 against the same step with K5's and
    the compositing kernels' plain versions (gauss fp32, gabor bf16; 1024
    rays, 64 + 192 samples); `garf_main --train_coarse_block 4` trains."""
    import dataclasses
    import functools

    from nerf_experiments_tpu_torch.experiments import garf_main
    from nerf_experiments_tpu_torch.systems import garf_system

    for activation, bf16 in (("gauss", False), ("gabor", True)):
        cfg = dataclasses.replace(garf_system_cfg(activation, bf16), train_coarse_block=4)
        params = perturbed_camera(
            garf_system.init(torch.Generator().manual_seed(30), cfg).to(dev), dev, 31)
        batch = garf_batch(STEP_RAYS, torch.Generator(device=dev).manual_seed(32), dev)
        step = garf_system.make_train_step_fused(cfg)
        step_pair(f"GARF blk4 train step {activation} {'bf16' if bf16 else 'fp32'}, kernels "
                  f"against their plain versions", functools.partial(garf_system.init_state, cfg),
                  params, batch, (under_plain_kernels(step), step), (0.37,), bf16, dev, 33)

    out = os.path.join(workdir, "garf_blk4")
    state, launches = counted_run(garf_main.main, [
        "--image_size", "32", "--batch_size", str(STEP_RAYS), "--log_every_n_steps", "5",
        "--fused_kernel", "--train_coarse_block", "4", "--device", str(dev), "--max_steps", "20",
        "--out_dir", out])
    losses = [json.loads(line).get("loss") for line in open(os.path.join(out, "metrics.jsonl"))]
    losses = [v for v in losses if v is not None]
    log(f"garf_main --train_coarse_block 4 gauss fp32 32^2 batch 1024: {state.step} steps, "
        f"loss {losses[0]:.5f} -> {losses[-1]:.5f}, launches {launches}")
    require(state.step == 20 and all(math.isfinite(v) for v in losses), "garf blk4 run")
    require(launches["garf_train"] == 20, "garf blk4: K5 not on every step")
    return launches


def time_steps(step_fn, state, batch, dev, n: int, first_seed: int) -> float:
    """ms of `n` consecutive steps (CUDA events), each with its own
    generator, the state advancing."""
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for i in range(n):
        state, _ = step_fn(state, batch, torch.Generator(device=dev).manual_seed(first_seed + i))
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop)


def phase_slice_timing(dev):
    """Train rays/s of each slice config against its counterpart, in turns
    (A, B, B, A), over a 16-step window that holds one occupancy refresh
    (BARF at 8192 rays) or 4 steps (GARF at 4096); the refresh alone and its
    share of the window; a profile of the occupancy steps; serving rays/s at
    8192-ray chunks with serve_block 1 and 4."""
    import dataclasses

    from nerf_experiments_tpu_torch.systems import barf as barf_sys
    from nerf_experiments_tpu_torch.systems import garf_system

    times = {}

    def barf_run(name):
        cfg = slice_config(name)
        params = barf_sys.init(torch.Generator().manual_seed(8), cfg).to(dev)
        batch = train_batch(N_RAYS, cfg.n_training_images,
                            torch.Generator(device=dev).manual_seed(13), dev)
        fn = barf_sys.make_train_step(cfg, fused=True)
        return cfg, params, batch, lambda st, b, g: fn(st, b, g, 7.5, 2.5, 0.0)

    window = 16
    for dtype in ("bf16", "fp32"):
        for a, b in (("north_star_S32", "north_star_occ_S32"),
                     ("north_star_S32", "north_star_S32_blk4"),
                     ("north_star_occ_S32", "north_star_occ_S32_blk4")):
            res = {}
            for name in (a, b, b, a):
                cfg, params, batch, fn = barf_run(f"{name} {dtype}")
                state = barf_sys.init_state(cfg, params)
                time_steps(fn, state, batch, dev, 1, 100)  # step 0 (a refresh), warm-up
                ms = time_steps(fn, state, batch, dev, window, 101)  # steps 1-16
                res.setdefault(name, []).append(N_RAYS * window / ms * 1e3)
                del state, params
                torch.cuda.empty_cache()
            for name, rates in res.items():
                times[f"{name} {dtype}"] = max(rates)
            log(f"train rays/s at {N_RAYS} rays, {window} steps (one refresh where there is "
                f"a grid), {dtype}: {a} {res[a]} against {b} {res[b]}")
        cfg, params, _, _ = barf_run(f"north_star_occ_S32 {dtype}")
        gen = torch.Generator(device=dev).manual_seed(0)
        refresh = cuda_time_ms(lambda: barf_sys._maybe_refresh_occ(cfg, params, 0, gen, A_POS,
                                                                   A_DIR), iters=5)
        step_ms = N_RAYS * window / times[f"north_star_occ_S32 {dtype}"] * 1e3
        times[f"refresh {dtype}"] = refresh
        log(f"occupancy refresh {dtype} ({cfg.occ.n_cells} cells through the radiance net): "
            f"{refresh:.3f} ms, {refresh / step_ms:.3f} of a {window}-step window "
            f"({step_ms:.2f} ms)")

    for name in ("north_star_occ_S32 bf16", "north_star_occ_S32_blk4 bf16",
                 "north_star_occ_S32 fp32"):
        cfg, params, batch, fn = barf_run(name)
        state = barf_sys.init_state(cfg, params)
        time_steps(fn, state, batch, dev, 1, 100)
        wall, device, _ = profile_step(
            lambda: fn(state, batch, torch.Generator(device=dev).manual_seed(200)),
            f"fused train step {name} (no refresh)")
        times[f"profile {name}"] = (wall, device)

    for activation, bf16 in (("gauss", False), ("gabor", True)):
        res = {}
        for block in (1, 4, 4, 1):
            cfg = dataclasses.replace(garf_system_cfg(activation, bf16), train_coarse_block=block)
            params = garf_system.init(torch.Generator().manual_seed(30), cfg).to(dev)
            batch = garf_batch(GARF_RAYS, torch.Generator(device=dev).manual_seed(34), dev)
            state = garf_system.init_state(cfg, params)
            fn = garf_system.make_train_step_fused(cfg)

            def step(st, b, g, fn=fn):
                return fn(st, b, g, 1.0)

            time_steps(step, state, batch, dev, 1, 300)
            ms = time_steps(step, state, batch, dev, 4, 301)
            res.setdefault(block, []).append(GARF_RAYS * 4 / ms * 1e3)
            del state, params
            torch.cuda.empty_cache()
        tag = f"{activation} {'bf16' if bf16 else 'fp32'}"
        times[f"garf_fused {tag}"], times[f"garf_fused_blk4 {tag}"] = max(res[1]), max(res[4])
        log(f"GARF train rays/s at {GARF_RAYS} rays, {tag}: garf_fused {res[1]} against "
            f"garf_fused_blk4 {res[4]}")

    gen = torch.Generator(device=dev).manual_seed(45)
    origs, dirs = random_rays(N_RAYS, gen, dev)
    for name in ("north_star_occ_S32 bf16", "north_star_S32 bf16", "north_star_occ_S32 fp32"):
        cfg = slice_config(name)
        params = barf_sys.init(torch.Generator().manual_seed(44), cfg).to(dev)
        if cfg.use_occ:
            occupied(params, cfg)
        rates = {}
        with torch.no_grad():
            for block in (1, 4):
                ms = cuda_time_ms(lambda: barf_sys.render_block_coarse(
                    params, cfg, origs, dirs, A_POS, A_DIR, block=block))
                rates[block] = N_RAYS / ms * 1e3
                times[f"serve {name} block {block}"] = rates[block]
        log(f"serving {name} at {N_RAYS}-ray chunks: serve_block 1 {rates[1]:.0f} rays/s, "
            f"serve_block 4 {rates[4]:.0f} rays/s")
    return times


# ---- the modules without kernels of their own (phases 30-35): the target
# blur, GaborF with it, SIREN, the 2-D reconstruction, the scene generator and
# the tools

BLUR_STACK = (100, 400, 400)  # a 100-view 400^2 train stack: 192 MB of fp32 colour
SIREN_RAYS = 1024  # run_nerf_siren's batch
TOL_BLUR = 1e-5  # the fp32 blur against float64: max error over the reference's max
# GaborF at 100^2, batch 1024: an epoch is 117 steps (validation, through K1,
# once in 120), a sigma period ~2.3; the rate comparison takes 60 steps
GARF_BLUR_STEPS = 120
GARF_RATE_STEPS = 60
RATE_SLACK = 0.02  # the blur may cost at most 2 % of the training rays/s


def blur_plain(images, kernel):
    """The separable blur in float64 numpy through the same folded band
    matrices: the plain version of `image_blur.separable_gaussian_blur`."""
    import numpy as np

    from nerf_experiments_tpu_torch.ops import image_blur

    img = images.double().cpu().numpy()
    m_h = image_blur.blur_matrix(img.shape[1], kernel).cpu().numpy()
    m_w = image_blur.blur_matrix(img.shape[2], kernel).cpu().numpy()
    return np.einsum("uw,nvwc->nvuc", m_w, np.einsum("vh,nhwc->nvwc", m_h, img))


def phase_blur(dev):
    """The target blur on the card against its float64 plain version at 100^2
    and 32^2 with 81 taps (at 32^2 the half width 40 passes the side: the
    folded reflect), then one re-blur of a 100 x 400^2 x 3 stack, as the
    trainer takes it at a sigma milestone (`ConvBlurTargets.flat_colors`:
    the taps and band matrices on the card, two fp32 matmuls, the flat
    colours)."""
    import numpy as np

    from nerf_experiments_tpu_torch.ops import image_blur

    gen = torch.Generator(device=dev).manual_seed(60)
    for side in (100, 32):
        images = torch.rand((4, side, side, 3), generator=gen, device=dev)
        for rel in (0.015, 0.1, 0.0):
            k = image_blur.gaussian_kernel(81, rel, side, device=dev)
            got = image_blur.separable_gaussian_blur(images, k)
            want = blur_plain(images, k)
            err = float(np.abs(got.double().cpu().numpy() - want).max() / np.abs(want).max())
            log(f"blur {side}^2 K 81 relative sigma {rel}: max err / max {err:.3e} "
                f"(tol {TOL_BLUR})")
            require(err <= TOL_BLUR, f"blur at {side}^2, sigma {rel}: err {err}")
    images = torch.rand(BLUR_STACK + (3,), generator=gen, device=dev)
    blur = image_blur.ConvBlurTargets(images, relative_sigma_start=0.015)
    ms = cuda_time_ms(blur.flat_colors, iters=5)
    dev_ms = device_ms(blur.flat_colors, calls=5)
    n, h, w = BLUR_STACK
    elems = n * h * w * 3
    band_flops = 2 * elems * (h + w)  # the two dense band products
    tap_flops = 2 * elems * 2 * 81  # what 81 taps a pass need
    t_bytes = 2 * elems * 4 / HBM_BYTES_PER_S * 1e3
    log(f"re-blur of {n} x {h}^2 x 3 ({elems * 4 / 1e6:.0f} MB): {ms:.4f} ms a call (CUDA "
        f"events), {dev_ms:.4f} ms of device time; bounds: bytes (read + write once) "
        f"{t_bytes:.4f} ms, 81 taps a pass {tap_flops / FP32_FLOP_PER_S * 1e3:.4f} ms, the "
        f"band products' {band_flops / 1e9:.1f} GFLOP {band_flops / FP32_FLOP_PER_S * 1e3:.4f} "
        f"ms at the fp32 rate")
    return {"reblur_ms": ms, "reblur_device_ms": dev_ms}


def garf_blur_fit(argv, strip_loggers=False, capture_at=None):
    """`garf_main.build` + fit with the launches counted: (state, trainer,
    ConvBlurTargets or None, launches, the targets before the fit, the
    targets after step `capture_at`). With `strip_loggers` only the target
    blur stays among the callbacks (a training-rate comparison)."""
    from nerf_experiments_tpu_torch.experiments import garf_main
    from nerf_experiments_tpu_torch.ops.image_blur import ConvBlurTargets

    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    _, state, trainer = garf_main.build(garf_main.parse_args(argv))
    blur = next((cb for cb in trainer.callbacks if isinstance(cb, ConvBlurTargets)), None)
    if strip_loggers:
        trainer.callbacks = [blur] if blur is not None else []
    captured = {}
    if capture_at is not None:
        def capture(tr, st, step, ef):
            if step == capture_at:
                captured["colors"] = tr._train_arrays["colors"].clone()
        trainer.callbacks.append(capture)
    start = trainer._train_arrays["colors"].clone()
    state = trainer.fit(state)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    return state, trainer, blur, launches, start, captured.get("colors")


def phase_gaborf_blur(dev, workdir):
    """`garf_main --activation gabor --bf16 --fused_kernel --conv_blur` at
    100^2 for 120 steps with K5 (every step), K6 (the image logger) and K1
    (the validation at the epoch; the proposal stage composites in plain
    torch) counted: the targets swap as sigma decays; 60 steps, a checkpoint
    and `--resume` to 120 give the targets of 120 steps in one go bit for bit
    (also at the resume point); train rays/s over steps 10-60 with and without
    --conv_blur in turns (A, B, B, A; only the blur among the callbacks)
    within 2 %."""
    base = ["--activation", "gabor", "--bf16", "--fused_kernel", "--image_size",
            str(IMAGE_SIZE), "--batch_size", "1024", "--log_every_n_steps", "10", "--device",
            str(dev)]
    blurred = base + ["--conv_blur"]
    half = GARF_BLUR_STEPS // 2
    out = os.path.join(workdir, "gaborf_blur")
    state, trainer, blur, total, start, at_half = garf_blur_fit(
        blurred + ["--max_steps", str(GARF_BLUR_STEPS), "--out_dir", out], capture_at=half)
    colors = trainer._train_arrays["colors"]
    rows = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    losses = [r["loss"] for r in rows if "loss" in r]
    swapped = float((colors - start).abs().max())
    log(f"garf_main gabor bf16 --conv_blur at {IMAGE_SIZE}^2: {state.step} steps, "
        f"{blur.n_applied} sigma milestones, sigma {blur.sigma0} -> {blur.sigma:.6f}, targets "
        f"moved by up to {swapped:.4f} from the start, loss {losses[0]:.5f} -> "
        f"{losses[-1]:.5f}, launches {total}")
    require(state.step == GARF_BLUR_STEPS and all(math.isfinite(v) for v in losses),
            "conv_blur run: wrong step count or a non-finite loss")
    require(blur.n_applied >= 1 and blur.sigma < blur.sigma0 and swapped > 0,
            "conv_blur run: the targets never swapped")
    require(torch.equal(colors, blur.flat_colors()), "conv_blur: targets not at the ladder")
    require(total["garf_train"] == GARF_BLUR_STEPS and total["garf_render"] > 0
            and total["render_fwd"] > 0, f"conv_blur: K5 / K6 / K1 not launched: {total}")

    split = os.path.join(workdir, "gaborf_blur_split")
    _, first, _, launches, _, _ = garf_blur_fit(
        blurred + ["--max_steps", str(half), "--resume", "--out_dir", split])
    add_launches(total, launches)
    state, resumed, _, launches, at_resume, _ = garf_blur_fit(
        blurred + ["--max_steps", str(GARF_BLUR_STEPS), "--resume", "--out_dir", split])
    add_launches(total, launches)
    log(f"conv_blur resume at step {half}: targets at the resume point equal the "
        f"uninterrupted run's {torch.equal(at_resume, at_half)} (and the first half's "
        f"{torch.equal(at_resume, first._train_arrays['colors'])}), at step {state.step} "
        f"{torch.equal(resumed._train_arrays['colors'], colors)}")
    require(torch.equal(at_resume, at_half) and torch.equal(at_resume,
                                                            first._train_arrays["colors"]),
            "conv_blur resume: targets at the resume point differ")
    require(state.step == GARF_BLUR_STEPS
            and torch.equal(resumed._train_arrays["colors"], colors),
            "conv_blur resume: targets differ from the uninterrupted run's")

    rates = {}
    for tag, argv in (("plain", base), ("conv_blur", blurred), ("conv_blur", blurred),
                      ("plain", base)):
        out = os.path.join(workdir, f"gaborf_rate_{len(rates.get(tag, []))}_{tag}")
        _, _, _, launches, _, _ = garf_blur_fit(
            argv + ["--max_steps", str(GARF_RATE_STEPS), "--out_dir", out], strip_loggers=True)
        add_launches(total, launches)
        rows = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
        rows = [r for r in rows if "wall_s" in r]
        # the window from the first log row (step 10) to the last (step 60)
        rate = 1024 * (GARF_RATE_STEPS - 10) / (rows[-1]["wall_s"] - rows[0]["wall_s"])
        rates.setdefault(tag, []).append(rate)
    ratio = max(rates["conv_blur"]) / max(rates["plain"])
    log(f"GaborF train rays/s at 1024 rays, steps 10-60 (A, B, B, A): plain {rates['plain']}, "
        f"--conv_blur {rates['conv_blur']}: ratio of the best {ratio:.4f} (must be >= "
        f"{1 - RATE_SLACK})")
    require(ratio >= 1 - RATE_SLACK, f"--conv_blur costs more than 2 % of the rays/s: {ratio}")
    return total, {"gaborf_plain": max(rates["plain"]),
                   "gaborf_conv_blur": max(rates["conv_blur"])}


def siren_cfg(bf16: bool):
    from nerf_experiments_tpu_torch.experiments import run_nerf_siren

    args = run_nerf_siren.parse_args(["--image_size", str(IMAGE_SIZE)]
                                     + (["--bf16"] if bf16 else []))
    return run_nerf_siren.build_config(args)[0]


def phase_siren(dev, workdir):
    """run_nerf_siren at its defaults (hidden 256, 64 + 128 samples, omega
    30, batch 1024), fp32 and bf16: one plain step against the same step
    with K1 / K3 replaced by their plain versions (the fine bins pinned to
    the kernel step's; unpinned logged), its K1 / K3 launches; the entry
    point at 100^2 for 100 steps (validation PSNR on fixed rays rises) with
    its launches counted, a short bf16 run; train rays/s at 1024 and 4096."""
    import copy
    import functools

    from nerf_experiments_tpu_torch.data import sampler
    from nerf_experiments_tpu_torch.experiments import run_nerf_siren
    from nerf_experiments_tpu_torch.systems import barf as barf_sys

    scalars = (0.0, 0.0, 0.0)
    times = {}
    for bf16 in (False, True):
        tag = "bf16" if bf16 else "fp32"
        cfg = siren_cfg(bf16)
        params = barf_sys.init(torch.Generator().manual_seed(70), cfg).to(dev)
        batch = train_batch(SIREN_RAYS, cfg.n_training_images,
                            torch.Generator(device=dev).manual_seed(71), dev)
        step = barf_sys.make_train_step(cfg)
        init_state = functools.partial(barf_sys.init_state, cfg)
        counters = launch_counters()
        for fn in counters.values():
            fn.launches = 0
        record = []
        with fine_bins(record=record):
            step(init_state(copy.deepcopy(params)), batch,
                 torch.Generator(device=dev).manual_seed(72), *scalars)
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in counters.items() if fn.launches}
        log(f"SIREN step {tag}: launches {launches}")
        require(launches.get("render_fwd") == 2 and launches.get("render_bwd") == 2,
                f"SIREN step {tag}: K1 / K3 not on both stages: {launches}")
        pinned = record[0]
        step_pair(f"SIREN step {tag} at {SIREN_RAYS} rays, K1 / K3 against their plain "
                  f"versions (fine bins pinned)", init_state, params, batch,
                  (under_plain_kernels(with_fine_bins(step, pinned=pinned)),
                   with_fine_bins(step, pinned=pinned)), scalars, bf16, dev, 72)
        step_pair(f"SIREN step {tag}, fine bins resampled from each step's own weights",
                  init_state, params, batch, (under_plain_kernels(step), step), scalars, bf16,
                  dev, 72, gate=False)
        for n in (SIREN_RAYS, 4096):
            b = train_batch(n, cfg.n_training_images,
                            torch.Generator(device=dev).manual_seed(73), dev)
            state = init_state(copy.deepcopy(params))
            def fn(st, bb, g, step=step):
                return step(st, bb, g, *scalars)

            time_steps(fn, state, b, dev, 1, 500)
            ms = time_steps(fn, state, b, dev, 5, 501)
            times[f"siren {tag} {n}"] = n * 5 / ms * 1e3
            log(f"SIREN train rays/s {tag} at {n} rays: {times[f'siren {tag} {n}']:.0f} "
                f"({ms / 5:.2f} ms a step)")
            del state, b
            torch.cuda.empty_cache()

    total = {}
    for bf16, steps in ((False, 100), (True, 20)):
        tag = "bf16" if bf16 else "fp32"
        out = os.path.join(workdir, f"siren_{tag}")
        args = run_nerf_siren.parse_args(
            ["--image_size", str(IMAGE_SIZE), "--max_steps", str(steps), "--device", str(dev),
             "--out_dir", out] + (["--bf16"] if bf16 else []))
        counters = launch_counters()
        for fn in counters.values():
            fn.launches = 0
        exp = run_nerf_siren.build(args)
        store = exp.train_store if exp.trainer.val_store is None else exp.trainer.val_store
        idx = torch.randint(0, store.n_rays, (4096,), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(74))
        val_batch = sampler.gather_batch_arrays(store.arrays(), store.pixel_width, idx)
        with torch.no_grad():
            before = float(exp.trainer.val_fn(exp.state.params, val_batch)["psnr"])
        t = time.perf_counter()
        state = exp.fit()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        with torch.no_grad():
            after = float(exp.trainer.val_fn(state.params, val_batch)["psnr"])
        launches = {k: fn.launches for k, fn in counters.items()}
        add_launches(total, launches)
        log(f"run_nerf_siren {tag} at {IMAGE_SIZE}^2: {state.step} steps in {wall:.2f} s, "
            f"PSNR on 4096 fixed rays {before:.3f} -> {after:.3f}, launches {launches}")
        require(state.step == steps and math.isfinite(after), f"run_nerf_siren {tag} failed")
        require(launches["render_fwd"] >= 2 * steps and launches["render_bwd"] == 2 * steps,
                f"run_nerf_siren {tag}: K1 / K3 not on every step")
        if not bf16:
            require(after > before, f"run_nerf_siren: PSNR did not rise ({before} -> {after})")
    return total, times


def phase_2d_reconstruction(dev, workdir):
    """run_2d_reconstruction at its defaults (64^2, hidden 256, 10 levels,
    batch 4096, 2000 steps): validation PSNR above the JAX package's 15 dB
    gate (`tests/test_end_to_end.py`), and its steps/s."""
    from nerf_experiments_tpu_torch.experiments import run_2d_reconstruction

    t = time.perf_counter()
    _, _, result = run_2d_reconstruction.main(
        ["--device", str(dev), "--out_dir", os.path.join(workdir, "2d"), "--save_image"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    log(f"run_2d_reconstruction defaults: {result}, {wall:.2f} s for 2000 steps "
        f"({2000 / wall:.1f} steps/s, data and image included)")
    require(result["val_psnr"] > 15.0, f"2-D reconstruction val PSNR {result['val_psnr']}")
    return {"2d_steps_per_s": 2000 / wall, "2d_val_psnr": result["val_psnr"]}


def phase_scene_generator(dev, workdir):
    """`synthetic_fast.validate` on the card; one 400^2 view at 128 samples
    (CUDA events) against the same view through the numpy marcher (host
    clock);
    a 12-view 100^2 `generate_dataset` (20 views with val and test) whose
    transforms are byte for byte, and images within 2/255 on 0.97 of the
    pixels, those of the numpy path's scene (`common.resolve_scene`)."""
    import numpy as np
    from PIL import Image

    from nerf_experiments_tpu_torch.data import synthetic, synthetic_fast
    from nerf_experiments_tpu_torch.experiments import common

    frac, err = synthetic_fast.validate(device=dev)
    log(f"scene generator validate on the card: {frac:.4f} of the pixels within 1/255, mean "
        f"error {err:.3e} (gate >= {synthetic_fast.GATE_FRAC_SAME}, < "
        f"{synthetic_fast.GATE_MEAN_ERR})")
    c2w = synthetic.look_at_c2w(np.array([2.5, 2.0, 2.2]), np.zeros(3),
                                np.array([0.0, 0.0, 1.0]))
    c2w_t = torch.as_tensor(c2w, dtype=torch.float32, device=dev)
    view_ms = cuda_time_ms(lambda: synthetic_fast.render_view(c2w_t, 400, 400, n_samples=128),
                           iters=3, warmup=1)
    t = time.perf_counter()
    synthetic.render_image(c2w, 400, 400, n_samples=128)
    numpy_s = time.perf_counter() - t
    ref = common.resolve_scene("synthetic", IMAGE_SIZE)
    out = os.path.join(workdir, "fast_scene")
    t = time.perf_counter()
    synthetic_fast.generate_dataset(out, device=dev, image_size=IMAGE_SIZE)
    gen_s = time.perf_counter() - t
    worst = 1.0
    for split in ("train", "val", "test"):
        ta = open(os.path.join(ref, f"transforms_{split}.json")).read()
        require(ta == open(os.path.join(out, f"transforms_{split}.json")).read(),
                f"scene generator: {split} poses differ from the numpy path's")
        for name in os.listdir(os.path.join(ref, split)):
            ia, ib = (np.asarray(Image.open(os.path.join(d, split, name)), np.float32) / 255.0
                      for d in (ref, out))
            worst = min(worst, float((np.abs(ia - ib).max(axis=-1) <= 2.0 / 255.0).mean()))
    log(f"scene generator: one 400^2 view at 128 samples {view_ms:.2f} ms on the card, "
        f"{numpy_s:.2f} s through the numpy marcher on the host; "
        f"generate_dataset 12 + 4 + 4 views at {IMAGE_SIZE}^2 (96 samples, validate "
        f"included) {gen_s:.2f} s; poses byte for byte the numpy path's, worst image "
        f"{worst:.4f} of the pixels within 2/255")
    require(worst >= 0.97, f"scene generator images differ from the numpy path's: {worst}")
    return {"view_400_ms": view_ms, "numpy_view_400_s": numpy_s, "generate_100_s": gen_s}


def phase_tools(dev, workdir):
    """`profiling.trace` around two SIREN steps writes a Chrome trace that
    names the K1 / K3 launches; `native.available()`."""
    import copy

    from nerf_experiments_tpu_torch.data import native
    from nerf_experiments_tpu_torch.systems import barf as barf_sys
    from nerf_experiments_tpu_torch.utils import profiling

    cfg = siren_cfg(False)
    params = barf_sys.init(torch.Generator().manual_seed(80), cfg).to(dev)
    batch = train_batch(SIREN_RAYS, cfg.n_training_images,
                        torch.Generator(device=dev).manual_seed(81), dev)
    state = barf_sys.init_state(cfg, copy.deepcopy(params))
    step = barf_sys.make_train_step(cfg)
    step(state, batch, torch.Generator(device=dev).manual_seed(82), 0.0, 0.0, 0.0)
    trace_dir = os.path.join(workdir, "trace")
    with profiling.trace(trace_dir):
        for i in range(2):
            with profiling.annotate(f"siren_step_{i}"):
                step(state, batch, torch.Generator(device=dev).manual_seed(83 + i), 0.0, 0.0,
                     0.0)
    with open(os.path.join(trace_dir, profiling.TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    k1 = sum("render_fwd_kernel" in n for n in names)
    k3 = sum("render_bwd_kernel" in n for n in names)
    annotated = sum(e.get("name", "").startswith("siren_step_") for e in events)
    log(f"profiling.trace around 2 SIREN steps: {len(names)} kernel events, render_fwd_kernel "
        f"x{k1}, render_bwd_kernel x{k3}, {annotated} annotated ranges")
    require(k1 == 4 and k3 == 4, f"the trace does not name the K1 / K3 launches: {k1}, {k3}")
    log(f"native.available() = {native.available()} ({native.library_path()})")
    return {"native": native.available()}


# ---------------------------------------------------------------- phases 36-37: the mesh

MESH_RAYS = 8192  # the global batch of the mesh steps (the north-star preset's)
MESH_RENDER_RAYS = 8191  # no multiple of two ranks: the padding is exercised
MESH_STEPS = 2
MESH_SCALARS = (7.5, 2.5, 0.0)  # alpha_pos, alpha_dir, blur sigma (phase 8's)
MESH_TIMED_STEPS = 10
TIMING_KEYS = ("train_rays_per_sec", "wall_s")
MODEL_AXIS = ", 1 x 2 model axis"  # the plain step on a (data 1, model 2) mesh


def mesh_configs():
    """(name, BarfConfig, fused) of phase 36's steps at full width: the
    north-star (bf16) and the dense flagship (fp32, 128 samples) through K4
    on equidistant bins without the offset (the seeds folded with the rank
    then draw nothing, so the ranks' bins are the single process's), and the
    dense flagship's plain step (K1 / K3) on stratified bins: the global
    draws."""
    import dataclasses

    from nerf_experiments_tpu_torch.experiments import run_barf

    def cfg(flags, **kw):
        args = run_barf.parse_args(["--image_size", str(IMAGE_SIZE), "--seed", "7"] + flags)
        return dataclasses.replace(run_barf.build_config(args)[0],
                                   uniform_sampling_offset_size=0.0, **kw)

    return [("fused northstar bf16", cfg(NORTHSTAR), True),
            ("fused dense fp32", cfg(["--samples_per_ray", "128"]), True),
            ("plain dense fp32 stratified",
             cfg(["--samples_per_ray", "32"], uniform_sampling_strategy="stratified_uniform"),
             False)]


def mesh_inputs(cfg, dev, n_rays: int = MESH_RAYS):
    """Parameters (the camera perturbed) and the global batch of the mesh
    steps, the same in every process from their seeds."""
    from nerf_experiments_tpu_torch.systems import barf as barf_sys

    params = perturbed_camera(barf_sys.init(torch.Generator().manual_seed(8), cfg).to(dev),
                              dev, 9)
    batch = train_batch(n_rays, cfg.n_training_images,
                        torch.Generator(device=dev).manual_seed(10), dev)
    return params, batch


def mesh_state(cfg, fused: bool, dev, mesh=None, n_rays: int = MESH_RAYS):
    """(state, step, batch): on one process, or data-parallel over `mesh`
    with this rank's shard of the `n_rays` global batch."""
    from nerf_experiments_tpu_torch.parallel import mesh as mesh_lib
    from nerf_experiments_tpu_torch.parallel import shard as shard_lib
    from nerf_experiments_tpu_torch.systems import barf as barf_sys

    params, batch = mesh_inputs(cfg, dev, n_rays)
    state = barf_sys.init_state(cfg, params)
    if mesh is not None:
        shard_lib.shard_state(state, mesh)
        batch = mesh_lib.shard_batch(batch, mesh)
    return state, barf_sys.make_train_step(cfg, fused=fused, mesh=mesh), batch


def mesh_steps(cfg, fused: bool, dev, mesh=None):
    """MESH_STEPS steps, each from its own generator seed: (losses,
    parameters before, parameters after, {leaf split over a model axis:
    (shard shape, full shape)}), on the host."""
    state, step, batch = mesh_state(cfg, fused, dev, mesh)
    split = {n: (tuple(s.shard.shape), tuple(p.shape))
             for n, p in state.params.named_parameters()
             for s in state.optimizer.model_shards if s.full is p}
    before = {k: v.cpu().clone() for k, v in state.params.state_dict().items()}
    losses = []
    for i in range(MESH_STEPS):
        state, metrics = step(state, batch, torch.Generator(device=dev).manual_seed(20 + i),
                              *MESH_SCALARS)
        require(bool(metrics["grads_finite"]), "mesh step: non-finite gradients")
        losses.append(float(metrics["loss"]))
    return (losses, before, {k: v.cpu().clone() for k, v in state.params.state_dict().items()},
            split)


def mesh_render(dev, mesh=None):
    """The dense flagship's serving forward through K2 (`forward(fused=True)`)
    of MESH_RENDER_RAYS rays, whole or through `sharded_render`."""
    from nerf_experiments_tpu_torch.parallel import shard as shard_lib
    from nerf_experiments_tpu_torch.systems import barf as barf_sys

    cfg = mesh_configs()[1][1]
    params = barf_sys.init(torch.Generator().manual_seed(31), cfg).to(dev)
    origs, dirs = random_rays(MESH_RENDER_RAYS, torch.Generator(device=dev).manual_seed(32), dev)
    pw = torch.full((MESH_RENDER_RAYS, 1), 1e-3, device=dev)

    def fwd(params, o, d, pw):
        return barf_sys.forward(params, cfg, None, o, d, pw, A_POS, A_DIR, stratified=False,
                                fused=True)[0]

    render = fwd if mesh is None else shard_lib.sharded_render(fwd, mesh)
    with torch.no_grad():
        return render(params, origs, dirs, pw).cpu()


def time_mesh_step(step, state, batch, dev, first_seed: int, barrier=None) -> float:
    """Seconds of MESH_TIMED_STEPS steps (host clock, synchronised; with
    `barrier`, every rank starts and is timed together), after two warm-up
    steps."""
    for i in range(2):
        state, _ = step(state, batch, torch.Generator(device=dev).manual_seed(first_seed + i),
                        *MESH_SCALARS)
    torch.cuda.synchronize()
    if barrier is not None:
        barrier()
    t0 = time.perf_counter()
    for i in range(MESH_TIMED_STEPS):
        state, _ = step(state, batch,
                        torch.Generator(device=dev).manual_seed(first_seed + 2 + i),
                        *MESH_SCALARS)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def mesh_rank(rank: int, world: int, workdir: str, device: str) -> None:
    """A rank of phase 36, one of two sharing `device` (cuda:0) over gloo
    (the caller names both). It loads the library its parent built, runs phase 36's
    steps and render on its shard (and the plain step on a 1 x 2 model axis)
    with every kernel count set to 0 just before and read just after, times
    the fused north-star step, and saves its results for the parent."""
    import torch.distributed as dist

    from nerf_experiments_tpu_torch.ops import cuda_build
    from nerf_experiments_tpu_torch.parallel import mesh as mesh_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    require(cuda_build.build().seconds == 0.0, f"rank {rank} started a second nvcc build")
    cuda_build.library()
    mesh = mesh_lib.make_mesh(device=dev)
    counters = launch_counters()
    out = {"steps": {}, "launches": {k: 0 for k in counters}}

    def counted(fn, *args):
        for c in counters.values():
            c.launches = 0
        result = fn(*args)
        torch.cuda.synchronize()
        add_launches(out["launches"], {k: c.launches for k, c in counters.items()})
        return result

    for name, cfg, fused in mesh_configs():
        out["steps"][name] = counted(mesh_steps, cfg, fused, dev, mesh)
        torch.cuda.empty_cache()
    # the plain step again on a 1 x 2 (data x model) mesh: each rank updates
    # half the columns of the leaves 256 wide
    out["steps"][name + MODEL_AXIS] = counted(mesh_steps, cfg, fused, dev,
                                              mesh_lib.make_mesh(1, 2, device=dev))
    out["render"] = counted(mesh_render, dev, mesh)
    state, step, batch = mesh_state(slice_config("north_star_S32 bf16"), True, dev, mesh)
    out["timed_s"] = time_mesh_step(step, state, batch, dev, 40, barrier=dist.barrier)
    dist.barrier()
    out["params"] = {k: v.cpu() for k, v in state.params.state_dict().items()}
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))


def phase_mesh_two_ranks(dev, workdir):
    """Two ranks on cuda:0 over gloo (`parallel/launch.py:run_ranks`): the
    data-parallel fused steps (K4 on each rank's 4096 rays) and the plain
    step, and the plain step on a 1 x 2 model axis, against the single
    process on the same global batch; the sharded render through K2 against
    the whole one; and the timed fused step."""
    from nerf_experiments_tpu_torch.parallel import launch

    ref = {name: mesh_steps(cfg, fused, dev) for name, cfg, fused in mesh_configs()}
    ref_render = mesh_render(dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    mdir = os.path.join(workdir, "mesh_two_ranks")
    os.makedirs(mdir)
    t = time.perf_counter()
    launch.run_ranks(mesh_rank, 2, (mdir, str(dev)), init_file=os.path.join(mdir, "store"),
                     backend="gloo", timeout_s=600.0, group_timeout_s=300.0)
    log(f"two gloo ranks on cuda:0 ran in {time.perf_counter() - t:.1f} s")
    outs = [torch.load(os.path.join(mdir, f"rank{r}.pt"), weights_only=False) for r in range(2)]
    configs = {name: cfg for name, cfg, _ in mesh_configs()}
    for name in outs[0]["steps"]:
        cfg = configs[name.replace(MODEL_AXIS, "")]
        bf16 = cfg.radiance.compute_dtype is not None
        ref_losses, before, ref_after, _ = ref[name.replace(MODEL_AXIS, "")]
        for rank, out in enumerate(outs):
            losses, rank_before, after, _ = out["steps"][name]
            require(all(torch.equal(before[k], rank_before[k]) for k in before),
                    f"{name}: rank {rank} started from other parameters")
            loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
            upd = {k: rel_norm(after[k] - before[k], ref_after[k] - before[k]) for k in before
                   if float((ref_after[k] - before[k]).norm()) > 0}
            worst = max(upd, key=upd.get)
            diff = max(max_err(after[k], ref_after[k]) for k in before)
            log(f"mesh {name}, rank {rank} of 2 (gloo, cuda:0) against one process, "
                f"{MESH_STEPS} steps at {MESH_RAYS} global rays: losses {losses} reference "
                f"{ref_losses}, rel err {loss_err:.3e} (tol {TOL_STEP_LOSS[bf16]}); update rel "
                f"norm err worst {worst} {upd[worst]:.3e} over {len(upd)} tensors (tol "
                f"{TOL_STEP_UPDATE[bf16]}); max abs parameter difference {diff:.3e}")
            require(loss_err <= TOL_STEP_LOSS[bf16], f"mesh {name}: loss err {loss_err}")
            for k, v in upd.items():
                require(v <= TOL_STEP_UPDATE[bf16], f"mesh {name}: update of {k} err {v}")
        require(all(torch.equal(outs[0]["steps"][name][2][k], outs[1]["steps"][name][2][k])
                    for k in ref_after), f"mesh {name}: the ranks' parameters differ")
    for rank, out in enumerate(outs):
        err = max_err(out["render"], ref_render)
        log(f"mesh sharded_render of {MESH_RENDER_RAYS} rays through K2, rank {rank}: shape "
            f"{tuple(out['render'].shape)}, max abs err {err:.3e} against the whole render "
            f"(tol {TOL_FP32}), bitwise {torch.equal(out['render'], ref_render)}")
        require(out["render"].shape == ref_render.shape and err <= TOL_FP32,
                f"mesh sharded_render rank {rank}: err {err}")
        split = next(v[3] for k, v in out["steps"].items() if k.endswith(MODEL_AXIS))
        log(f"mesh 1 x 2 model axis, rank {rank}: split leaves (shard, full) {split}")
        require(len(split) >= 4 and all(a[:-1] == b[:-1] and 2 * a[-1] == b[-1]
                                        for a, b in split.values()),
                "the model axis did not split the 256-wide leaves in half")
    require(all(torch.equal(outs[0]["params"][k], outs[1]["params"][k])
                for k in outs[0]["params"]), "mesh timing: the ranks' parameters differ")
    launches = add_launches(dict(outs[0]["launches"]), outs[1]["launches"])
    log(f"mesh phase 36 launches, both ranks: {launches}")
    require(outs[0]["launches"]["flagship_train"] == 2 * MESH_STEPS
            and outs[1]["launches"]["flagship_train"] == 2 * MESH_STEPS,
            "mesh: K4 not launched on every rank's shard at every fused step")
    require(min(o["launches"]["flagship_render"] for o in outs) >= 1,
            "mesh: K2 not launched in the sharded render")
    require(min(o["launches"]["render_bwd"] for o in outs) >= MESH_STEPS,
            "mesh: K3 not launched in the plain step")
    seconds = max(o["timed_s"] for o in outs)
    rate = MESH_RAYS * MESH_TIMED_STEPS / seconds
    log(f"time the fused north-star bf16 step, two ranks sharing one card over gloo, "
        f"{MESH_RAYS} global rays: {1e3 * seconds / MESH_TIMED_STEPS:.2f} ms a step, "
        f"{rate:.0f} rays/s (not a scaling figure)")
    return launches, {"mesh_two_ranks_gloo_one_card_rays_per_s": rate}


def phase_mesh_one_rank(dev, workdir):
    """One NCCL rank through the entry points: `run_barf.main --mesh auto
    --fused_kernel` against the same run without --mesh (rows and
    parameters bitwise, under torch's deterministic algorithms), the same
    run under `torchrun`, and the fused north-star step with and without a
    one-rank mesh, timed in turns, beside the collectives alone."""
    import torch.distributed as dist

    from nerf_experiments_tpu_torch.experiments import run_barf
    from nerf_experiments_tpu_torch.parallel import mesh as mesh_lib
    from nerf_experiments_tpu_torch.parallel import shard as shard_lib

    steps = 24
    base = ["--image_size", "32", "--batch_size", "1024", "--max_steps", str(steps),
            "--log_every_n_steps", "4", "--image_log_period_epochs", "0.5",
            "--fused_kernel", "--device", str(dev)] + NORTHSTAR

    def rows(out):
        return [{k: v for k, v in json.loads(line).items() if k not in TIMING_KEYS}
                for line in open(os.path.join(out, "metrics.jsonl"))]

    runs, launches = {}, {}
    with deterministic():
        for name, extra in (("no mesh", []), ("mesh auto", ["--mesh", "auto"])):
            out = os.path.join(workdir, f"mesh_entry_{name.replace(' ', '_')}")
            state, launches[name] = counted_run(run_barf.main, base + extra + ["--out_dir", out])
            runs[name] = (rows(out), {k: v.cpu() for k, v in state.params.state_dict().items()})
            require(not dist.is_initialized(), f"{name}: a process group outlived the run")
    (rows_a, params_a), (rows_b, params_b) = runs["no mesh"], runs["mesh auto"]
    losses = [r["loss"] for r in rows_b if "loss" in r]
    same = rows_a == rows_b and all(torch.equal(params_a[k], params_b[k]) for k in params_a)
    log(f"run_barf --mesh auto (one NCCL rank) against no mesh, {steps} steps at 32^2: "
        f"{len(rows_b)} rows, loss {losses[0]:.6f} -> {losses[-1]:.6f}, rows and parameters "
        f"bitwise equal {same}; launches {launches['mesh auto']}")
    require(same, "a one-rank mesh is not bitwise the run without one")
    require(launches["mesh auto"]["flagship_train"] == steps,
            "run_barf --mesh auto: K4 not on every step")
    require(launches["mesh auto"]["flagship_render"] >= 1, "run_barf --mesh auto: no K2 image")

    out = os.path.join(workdir, "mesh_torchrun")
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=1",
         "-m", "nerf_experiments_tpu_torch.experiments.run_barf", "--mesh", "auto"] + base
        + ["--out_dir", out], cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
        capture_output=True, text=True, timeout=600)
    require(proc.returncode == 0, f"torchrun run_barf failed:\n{proc.stderr[-4000:]}")
    rows_c = rows(out)
    losses_c = [r["loss"] for r in rows_c if "loss" in r]
    worst = max(abs(a - b) / abs(b) for a, b in zip(losses_c, losses))
    log(f"torchrun --standalone --nproc_per_node=1 run_barf --mesh auto: {len(rows_c)} rows in "
        f"{time.perf_counter() - t:.1f} s, loss {losses_c[0]:.6f} -> {losses_c[-1]:.6f}, "
        f"largest relative loss difference from the in-process run {worst:.3e} (torch's "
        f"default, non-deterministic algorithms)")
    require(len(losses_c) == len(losses) and all(math.isfinite(v) for v in losses_c),
            "torchrun run_barf: loss rows")
    require(os.path.exists(os.path.join(out, "ckpt", f"ckpt_{steps}.pt")),
            "torchrun run_barf: no final checkpoint")

    # the fused north-star step at 8192 rays, without a mesh (A) and on a
    # one-rank NCCL mesh (B), in turns A, B, B, A; then the collectives alone
    cfg = slice_config("north_star_S32 bf16")
    mesh = mesh_lib.make_mesh(device=dev)
    try:
        seconds = {"A": [], "B": []}
        for label in "ABBA":
            state, step, batch = mesh_state(cfg, True, dev, mesh if label == "B" else None)
            seconds[label].append(time_mesh_step(step, state, batch, dev, 60))
            del state, step, batch
        state, _, _ = mesh_state(cfg, True, dev, mesh)
        params = shard_lib.full_params(state.optimizer)
        for p in params:
            p.grad = torch.zeros_like(p)
        metrics = {"loss": torch.ones((), device=dev), "loss_fine": torch.ones((), device=dev),
                   "loss_coarse": torch.ones((), device=dev), "psnr": torch.ones((), device=dev)}
        sync_ms = cuda_time_ms(lambda: (shard_lib.sync_grads(params, mesh),
                                        shard_lib.sync_metrics(dict(metrics), mesh)),
                               iters=50, warmup=5)
        n_grad = sum(p.numel() for p in params)
    finally:
        mesh.close()
    rates = {k: MESH_RAYS * MESH_TIMED_STEPS / (sum(v) / len(v)) for k, v in seconds.items()}
    log(f"time the fused north-star bf16 step at {MESH_RAYS} rays, A, B, B, A "
        f"({MESH_TIMED_STEPS} steps each): no mesh {rates['A']:.0f} rays/s "
        f"({[round(1e3 * s / MESH_TIMED_STEPS, 3) for s in seconds['A']]} ms a step), "
        f"one-rank NCCL mesh {rates['B']:.0f} rays/s "
        f"({[round(1e3 * s / MESH_TIMED_STEPS, 3) for s in seconds['B']]}): ratio "
        f"{rates['B'] / rates['A']:.4f}; `sync_grads` + `sync_metrics` alone (one all-reduce "
        f"of {n_grad} "
        f"gradients, {4 * n_grad / 2**20:.2f} MiB, and one of the metrics) {sync_ms:.4f} ms")
    total = add_launches(dict(launches["mesh auto"]), {})
    return total, {"mesh_one_rank_nccl_rays_per_s": rates["B"],
                   "mesh_none_rays_per_s": rates["A"], "mesh_sync_ms": sync_ms}


HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
BF16_FLOP_PER_S = 989e12


def bound(n_bytes: float, flops: float, rate: float = FP32_FLOP_PER_S):
    """(least ms the card could take, "bytes" or "operations"): the inputs
    read once and the outputs written once at the memory rate, against the
    operations at `rate` (the CUDA cores' fp32 rate unless the kernel runs its
    products on the tensor cores)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def weight_count(module) -> int:
    """The multiply-adds of one sample through the linear layers: the number
    of weights of its Dense layers."""
    return sum(p.numel() for n, p in module.named_parameters() if n.endswith(".w"))


def hash_bounds(B: int) -> dict:
    """K7's and K8's bounds at B 3-D points of run_3d_ingp's grid (L16 F2 T
    2^16 fp32): bytes of x, g / the output and the table (gradient) once;
    operations: per (point, level) 6 d for the cell and per corner the weight's
    d - 1 products, and 2 F (K7: F multiply-adds; K8 without d_x: F products and
    F adds into the table); with d_x, K8's 2^d (4 F + d (d + 2)), and x read
    and d_x written. These count what the function needs. `hash_encode_bwd_acc`
    adds what K8's fixed-point design costs on top (scratch of the design, not
    of the function): its int64 accumulator's four words an element zeroed and
    read back once, and 3 F operations a corner for one later word (the
    remainder, its scaling and its add, which only terms below ~2^-17 max|g|
    take, so an upper count)."""
    L, T, F, D = 16, 2**16, 2, 3
    f32 = 4
    per_level = 6 * D + 2**D * (D - 1 + 2 * F)
    later_word = B * L * 2**D * 3 * F
    bwd_bytes = f32 * (B * D + B * L * F + 2 * L * T * F + B * D)
    bwd_ops = B * L * 2**D * (4 * F + D * (D + 2))
    return {"hash_encode_fwd": bound(f32 * (B * D + L * T * F + B * L * F), B * L * per_level),
            "hash_encode_bwd_no_dx": bound(f32 * (B * D + B * L * F + L * T * F),
                                           B * L * per_level),
            "hash_encode_bwd": bound(bwd_bytes, bwd_ops),
            "hash_encode_bwd_acc": bound(bwd_bytes + 2 * 4 * 8 * L * T * F,
                                         bwd_ops + later_word)}


def kernel_bounds():
    """The bound of every kernel at the shape its time was taken at (K1 / K3
    8192 x 64, K2 / K4 / K11 8192 x 128 and K6 8192 x 192 fp32, K5 4096 x
    192 fp32, K7 / K8 524,288 3-D points at L16 F2 T 2^16, K9 / K10
    run_mip_nerf's three chains at 262,144 rows fp32; K2 / K4 also bf16, and
    K4 bf16 at 8192 x 32: the `_bf16` keys). The operation counts are those
    of the layers' multiply-adds (2 per weight a sample: forward; 6: forward
    and both backward products) or, for the memory-bound kernels, a count
    per element from the source (K1 ~16 a sample, K3 ~30, K7 6 d per level
    and point plus 2^d (d - 1 + 2 F), K8 without d_x the same, with d_x
    2^d (4 F + d (d + 2))). K2, K11
    (K2's kernel), K5 and K6 run their products on the tensor cores: in fp32
    as three TF32 products each (3xTF32) at the TF32 rate, in bf16 at the
    bf16 rate (K5 / K6 also keep their fp32 bound at the CUDA cores' rate,
    the `_cuda_cores` keys). K9 / K10 keep their fp32 bound at the CUDA
    cores' rate and give their bf16 bound (`_bf16`) and the 3xTF32 one
    (`_tf32`) beside it.
    K4 in bf16 at the bf16 rate; K4 in fp32 needs products exact to fp32
    (3xTF32 flips ReLUs: `scripts/tf32_relu_flips.py`), so it is bounded by
    the cheapest such split on the tensor cores: three bf16 parts a factor,
    a = a0 + a1 + a2, and the six partial products a_i b_j with i + j <= 2
    (those dropped are 2^-24 of the product), six products at the bf16 rate,
    as fast as 3xTF32; whatever route the kernel takes (today its forward on
    the CUDA cores)."""
    from nerf_experiments_tpu_torch.models import garf, nerf_mlp

    f32 = 4
    n, s = N_RAYS, 64
    out = {"render_fwd": bound(f32 * (8 * n * s + 5 * n), 16 * n * s),
           "render_bwd": bound(f32 * (13 * n * s + 5 * n), 30 * n * s)}
    flag = nerf_mlp.init(torch.Generator().manual_seed(0), flagship_cfg(False))
    macs = weight_count(flag)
    rays_io = f32 * N_RAYS * (6 + 2 * 128 + 5)
    out["flagship_render"] = bound(rays_io, 3 * 2 * macs * N_RAYS * 128, TF32_FLOP_PER_S)
    out["flagship_train"] = bound(rays_io, 6 * 6 * macs * N_RAYS * 128, BF16_FLOP_PER_S)
    out["flagship_render_bf16"] = bound(rays_io, 2 * macs * N_RAYS * 128, BF16_FLOP_PER_S)
    out["flagship_train_bf16"] = bound(rays_io, 6 * macs * N_RAYS * 128, BF16_FLOP_PER_S)
    out["flagship_train_bf16_s32"] = bound(f32 * N_RAYS * (6 + 2 * 32 + 5),
                                           6 * macs * N_RAYS * 32, BF16_FLOP_PER_S)
    # K5 / K6 run their products on the tensor cores: fp32 as three TF32
    # products each (3xTF32) at the TF32 rate, bf16 at the bf16 rate; the
    # `_cuda_cores` keys keep the fp32 figure at the CUDA cores' rate
    rad = garf.radiance_init(torch.Generator().manual_seed(0), garf_cfg("gauss", False))
    gmacs = weight_count(rad)
    train_io, train_ops = f32 * GARF_RAYS * (9 + 2 * 192), 6 * gmacs * GARF_RAYS * 192
    render_io = f32 * 2 * GARF_RAYS * (6 + 2 * 192 + 5)
    render_ops = 2 * gmacs * 2 * GARF_RAYS * 192
    out["garf_train"] = bound(train_io, 3 * train_ops, TF32_FLOP_PER_S)
    out["garf_train_bf16"] = bound(train_io, train_ops, BF16_FLOP_PER_S)
    out["garf_train_cuda_cores"] = bound(train_io, train_ops)
    out["garf_render"] = bound(render_io, 3 * render_ops, TF32_FLOP_PER_S)
    out["garf_render_bf16"] = bound(render_io, render_ops, BF16_FLOP_PER_S)
    out["garf_render_cuda_cores"] = bound(render_io, render_ops)
    out.update(hash_bounds(INGP_POINTS))
    # K9 / K10: run_mip_nerf's three chains at MIP_ROWS rows each; K9 reads x
    # and the weights and writes y, K10 also reads g and writes dx and dW / db
    mip = nerf_mlp.init(torch.Generator().manual_seed(0), mip_config()[0].radiance)
    io = [(l[0].w.shape[0], l[-1].w.shape[1]) for _, l in chain_layers(mip)]
    weights = sum(p.numel() for p in mip.parameters())
    rows_io = sum(d0 + dl for d0, dl in io)
    out["fused_mlp_fwd"] = bound(f32 * (MIP_ROWS * rows_io + weights),
                                 2 * weight_count(mip) * MIP_ROWS)
    out["fused_mlp_bwd"] = bound(f32 * (MIP_ROWS * (rows_io + sum(d0 for d0, _ in io))
                                        + 2 * weights),
                                 6 * weight_count(mip) * MIP_ROWS)
    # ... and in bf16 at the bf16 tensor-core rate (the same bytes)
    out["fused_mlp_fwd_bf16"] = bound(f32 * (MIP_ROWS * rows_io + weights),
                                      2 * weight_count(mip) * MIP_ROWS, BF16_FLOP_PER_S)
    out["fused_mlp_bwd_bf16"] = bound(f32 * (MIP_ROWS * (rows_io + sum(d0 for d0, _ in io))
                                             + 2 * weights),
                                      6 * weight_count(mip) * MIP_ROWS, BF16_FLOP_PER_S)
    # ... and at the TF32 rate as three TF32 products each (3xTF32), the
    # bound of the fp32 products on the tensor cores (K9's fp32 forward and
    # K10's phase B run on the CUDA cores, so neither can reach it)
    out["fused_mlp_fwd_tf32"] = bound(f32 * (MIP_ROWS * rows_io + weights),
                                      3 * 2 * weight_count(mip) * MIP_ROWS, TF32_FLOP_PER_S)
    out["fused_mlp_bwd_tf32"] = bound(f32 * (MIP_ROWS * (rows_io + sum(d0 for d0, _ in io))
                                             + 2 * weights),
                                      3 * 6 * weight_count(mip) * MIP_ROWS, TF32_FLOP_PER_S)
    # K11: K2's work at 8192 x 128 (rays and offsets in, rgb out)
    out["render_megakernel"] = bound(f32 * N_RAYS * (6 + 1 + 3), 3 * 2 * macs * N_RAYS * 128,
                                     TF32_FLOP_PER_S)
    # the serving proposal kernel at the north-star chunk (8192 x 64 -> 32):
    # rays in, the fine bins and the coarse rgb out; the 64x1 proposal net's
    # multiply-adds (11,200 a point) at the bf16 rate
    prop = nerf_mlp.init(torch.Generator().manual_seed(0),
                         flagship_cfg(True, hidden_dim=64, n_hidden=1, n_segments=1))
    out["proposal_bins"] = bound(f32 * N_RAYS * (6 + 2 * 32 + 3),
                                 2 * weight_count(prop) * N_RAYS * 64, BF16_FLOP_PER_S)
    return out


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
        if line.startswith("== "):  # a source and the seconds its compiler took
            log("  nvcc " + line[3:])
        elif "registers" in line or "spill" in line or "Compiling entry" in line:
            log("  ptxas: " + line.strip())

    def run(num: int, fn, *a):
        """Phase `num`; prints its wall time."""
        t = time.perf_counter()
        out = fn(*a)
        log(f"phase {num} {fn.__name__}: {time.perf_counter() - t:.1f} s")
        return out

    k1_err = run(2, phase_compositing, dev)
    k2_err = run(3, phase_flagship, dev)
    with tempfile.TemporaryDirectory() as workdir:
        launches, exps = run(4, phase_slice, dev, workdir)
        times = run(5, phase_timing, dev, exps)
        exps = None
        k3_err = run(6, phase_render_bwd, dev)
        k4_err = run(7, phase_train_kernel, dev)
        run(8, phase_train_step, dev)
        train_launches = run(9, phase_training, dev, workdir)
        train_times = run(10, phase_train_timing, dev)
        k6_err = run(11, phase_garf_render, dev)
        k5_err = run(12, phase_garf_train_kernel, dev)
        run(13, phase_garf_train_step, dev)
        garf_launches = run(14, phase_garf_training, dev, workdir)
        garf_times = run(15, phase_garf_timing, dev)
        k7_err = run(16, phase_hash_forward, dev)
        k8_err = run(17, phase_hash_backward, dev)
        run(18, phase_ingp_train_step, dev)
        ingp_launches = run(19, phase_ingp_training, dev, workdir)
        ingp_times = run(20, phase_ingp_timing, dev)
        chain_err = run(21, phase_fused_mlp, dev)
        k11_err = run(22, phase_render_megakernel, dev)
        run(23, phase_fused_plug_step, dev)
        mip_launches = run(24, phase_mip_training, dev, workdir)
        mip_times = run(25, phase_mip_timing, dev)
        slice_launches = run(26, phase_occ, dev, workdir)
        add_launches(slice_launches, run(27, phase_block_coarse, dev, workdir))
        add_launches(slice_launches, run(28, phase_garf_block_coarse, dev, workdir))
        run(29, phase_slice_timing, dev)
        modules = run(30, phase_blur, dev)
        new_launches, rates = run(31, phase_gaborf_blur, dev, workdir)
        modules.update(rates)
        siren_launches, rates = run(32, phase_siren, dev, workdir)
        add_launches(new_launches, siren_launches)
        modules.update(rates)
        modules.update(run(33, phase_2d_reconstruction, dev, workdir))
        modules.update(run(34, phase_scene_generator, dev, workdir))
        modules.update(run(35, phase_tools, dev, workdir))
        mesh_launches, rates = run(36, phase_mesh_two_ranks, dev, workdir)
        modules.update(rates)
        entry_launches, rates = run(37, phase_mesh_one_rank, dev, workdir)
        add_launches(mesh_launches, entry_launches)
        modules.update(rates)
        log(json.dumps({"modules": modules}))
        proposal_err, proposal_times = run(38, phase_proposal_bins, dev)

    # ms / plain_ms: device time per call (torch.profiler) for K1 and K3
    # (inputs rotated past the L2), K7 and K8 (table in L2) and the proposal
    # kernel (8192 x 64 -> 32; its plain stage by CUDA events), CUDA events per
    # call for K2, K4, K5 (4096 x 192), K6 (8192 x 192), K11 (8192 x 128) and
    # K9 / K10 (the three chains' calls summed, 262,144 rows);
    # library_ms: the PyTorch call that does K7's / K8's table access alone,
    # and for K9 / K10 the cuBLAS chain below
    kernels = {"kernels": [
        {"name": "render_fwd", "route": "cuda",
         "source": "nerf_experiments_tpu_torch/csrc/render.cu",
         "replaces": "nerf_experiments_tpu/ops/render_pallas.py:55",
         "launches": launches["northstar"]["render_fwd"] + train_launches["render_fwd"]
         + garf_launches["render_fwd"] + ingp_launches["render_fwd"]
         + mip_launches["render_fwd"] + slice_launches["render_fwd"]
         + new_launches["render_fwd"] + mesh_launches["render_fwd"],
         "max_abs_err": k1_err,
         "ms": times["K1_S64"][0], "plain_ms": times["K1_S64"][1]},
        {"name": "flagship_render", "route": "cuda",
         "source": "nerf_experiments_tpu_torch/csrc/flagship_render.cu",
         "replaces": "nerf_experiments_tpu/ops/train_megakernel.py:415",
         "launches": launches["dense"]["flagship_render"]
         + launches["northstar"]["flagship_render"] + train_launches["flagship_render"]
         + slice_launches["flagship_render"] + mesh_launches["flagship_render"],
         "max_abs_err": k2_err,
         "ms": times["K2_S128_fp32"][0], "plain_ms": times["K2_S128_fp32"][1]},
        {"name": "render_bwd", "route": "cuda",
         "source": "nerf_experiments_tpu_torch/csrc/render.cu",
         "replaces": "nerf_experiments_tpu/ops/render_pallas.py:83",
         "launches": train_launches["render_bwd"] + ingp_launches["render_bwd"]
         + mip_launches["render_bwd"] + slice_launches["render_bwd"]
         + new_launches["render_bwd"] + mesh_launches["render_bwd"],
         "max_abs_err": k3_err,
         "ms": train_times["K3_S64"][0], "plain_ms": train_times["K3_S64"][1]},
        {"name": "flagship_train", "route": "cuda",
         "source": "nerf_experiments_tpu_torch/csrc/flagship_train.cu",
         "replaces": "nerf_experiments_tpu/ops/train_megakernel.py:152",
         "launches": train_launches["flagship_train"] + slice_launches["flagship_train"]
         + mesh_launches["flagship_train"],
         "max_abs_err": k4_err,
         "ms": train_times["K4_S128_fp32"][0], "plain_ms": train_times["K4_S128_fp32"][1],
         "ms_1024": train_times["K4_1024_S128_fp32"][0],
         "plain_ms_1024": train_times["K4_1024_S128_fp32"][1]},
        {"name": "garf_train", "route": "cuda",
         "source": "nerf_experiments_tpu_torch/csrc/garf_train.cuh",
         "replaces": "nerf_experiments_tpu/ops/garf_megakernel.py:82",
         "launches": garf_launches["garf_train"] + slice_launches["garf_train"]
         + new_launches["garf_train"],
         "max_abs_err": k5_err,
         "ms": garf_times["K5_gauss_fp32"][0], "plain_ms": garf_times["K5_gauss_fp32"][1]},
        {"name": "garf_render", "route": "cuda",
         "source": "nerf_experiments_tpu_torch/csrc/garf_render.cuh",
         "replaces": "nerf_experiments_tpu/ops/garf_megakernel.py:376",
         "launches": garf_launches["garf_render"] + slice_launches["garf_render"]
         + new_launches["garf_render"],
         "max_abs_err": k6_err,
         "ms": garf_times["K6_gauss_fp32"][0], "plain_ms": garf_times["K6_gauss_fp32"][1]},
        {"name": "hash_encode_fwd", "route": "cuda",
         "source": "nerf_experiments_tpu_torch/csrc/hashgrid.cu",
         "replaces": "nerf_experiments_tpu/ops/hashgrid_pallas.py:61",
         "launches": ingp_launches["hash_encode_fwd"], "max_abs_err": k7_err,
         "ms": ingp_times["K7"][0], "plain_ms": ingp_times["K7"][1]},
        {"name": "hash_encode_bwd", "route": "cuda",
         "source": "nerf_experiments_tpu_torch/csrc/hashgrid.cu",
         "replaces": "nerf_experiments_tpu/ops/hashgrid_pallas.py:87",
         "launches": ingp_launches["hash_encode_bwd"], "max_abs_err": k8_err,
         "ms": ingp_times["K8"][0], "plain_ms": ingp_times["K8"][1]},
        {"name": "fused_mlp_fwd", "route": "cuda",
         "source": "nerf_experiments_tpu_torch/csrc/fused_mlp.cu",
         "replaces": "nerf_experiments_tpu/ops/fused_mlp.py:62",
         "launches": mip_launches["fused_mlp_fwd"], "max_abs_err": chain_err["fused_mlp_fwd"],
         "ms": mip_times["K9_fp32"][0], "plain_ms": mip_times["K9_fp32"][1]},
        {"name": "fused_mlp_bwd", "route": "cuda",
         "source": "nerf_experiments_tpu_torch/csrc/fused_mlp.cu",
         "replaces": "nerf_experiments_tpu/ops/fused_mlp.py:78",
         "launches": mip_launches["fused_mlp_bwd"], "max_abs_err": chain_err["fused_mlp_bwd"],
         "ms": mip_times["K10_fp32"][0], "plain_ms": mip_times["K10_fp32"][1]},
        {"name": "render_megakernel", "route": "cuda",
         "source": "nerf_experiments_tpu_torch/csrc/flagship_render.cu",
         "replaces": "nerf_experiments_tpu/ops/render_megakernel.py:73",
         "launches": mip_launches["render_megakernel"], "max_abs_err": k11_err,
         "ms": mip_times["K11"][0], "plain_ms": mip_times["K11"][1]},
        {"name": "proposal_bins", "route": "cuda",
         "source": "nerf_experiments_tpu_torch/csrc/proposal_bins.cu",
         "replaces": "none: the XLA coarse stage of nerf_experiments_tpu/systems/barf.py "
                     "forward, fused with K1's forward",
         "launches": launches["northstar"]["proposal_bins"], "max_abs_err": proposal_err,
         "ms": proposal_times[0], "plain_ms": proposal_times[1]},
    ]}
    bounds = kernel_bounds()
    # K9 / K10: the three chains as cuBLAS `addmm` + ReLU calls (a chain of
    # calls, not one), fp32 with TF32 off; K10's: that forward and autograd's
    # backward
    library = {"hash_encode_fwd": ingp_times["K7"][2], "hash_encode_bwd": ingp_times["K8"][2],
               "fused_mlp_fwd": mip_times["K9_fp32"][2],
               "fused_mlp_bwd": mip_times["K10_fp32"][2]}
    for k in kernels["kernels"]:
        k["bound_ms"], k["bound_by"] = bounds[k["name"]]
        k["library_ms"] = library.get(k["name"])
    # K2 / K4 / K5 / K6 / K9 / K10 in bf16 beside their fp32 numbers (K5 / K6:
    # gabor in bf16, gauss in fp32), against the bf16 tensor-core bound; K5 /
    # K6 also beside their fp32 bound at the CUDA cores' rate
    bf16_times = {"flagship_render": {"": times["K2_S128_bf16"]},
                  "flagship_train": {"": train_times["K4_S128_bf16"],
                                     "_s32": train_times["K4_S32_bf16"]},
                  "garf_train": {"": garf_times["K5_gabor_bf16"]},
                  "garf_render": {"": garf_times["K6_gabor_bf16"]},
                  "fused_mlp_fwd": {"": mip_times["K9_bf16"][:2]},
                  "fused_mlp_bwd": {"": mip_times["K10_bf16"][:2]}}
    # K8 also without d_x (the table gradient alone: index_add_'s work)
    for k in kernels["kernels"]:
        if k["name"] == "hash_encode_bwd":
            k["ms_no_dx"] = ingp_times["K8_no_dx"][0]
            k["bound_ms_no_dx"] = bounds["hash_encode_bwd_no_dx"][0]
            k["bound_ms_with_accumulator"] = bounds["hash_encode_bwd_acc"][0]
    for k in kernels["kernels"]:
        for suffix, (ms, plain) in bf16_times.get(k["name"], {}).items():
            k[f"ms_bf16{suffix}"], k[f"plain_ms_bf16{suffix}"] = ms, plain
            k[f"bound_ms_bf16{suffix}"] = bounds[f"{k['name']}_bf16{suffix}"][0]
        if f"{k['name']}_cuda_cores" in bounds:
            k["bound_ms_fp32_cuda_cores"] = bounds[f"{k['name']}_cuda_cores"][0]
        if f"{k['name']}_tf32" in bounds:  # K9 / K10: fp32 as 3xTF32
            k["bound_ms_tf32"] = bounds[f"{k['name']}_tf32"][0]
    # K9 / K10: the bf16 cuBLAS chain beside the fp32 one
    library_bf16 = {"fused_mlp_fwd": mip_times["K9_bf16"][2],
                    "fused_mlp_bwd": mip_times["K10_bf16"][2]}
    for k in kernels["kernels"]:
        if k["name"] in library_bf16:
            k["library_ms_bf16"] = library_bf16[k["name"]]
    idle = [k["name"] for k in kernels["kernels"] if k["launches"] < 1]
    require(not idle, f"kernels never launched on their main paths: {idle}")
    for k in kernels["kernels"]:
        log(f"{k['name']}: {k['ms']:.4f} ms against a bound of {k['bound_ms']:.4f} ms "
            f"({k['bound_by']}): {k['bound_ms'] / k['ms']:.3f} of the roofline")
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
