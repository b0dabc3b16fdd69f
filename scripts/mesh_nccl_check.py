"""The port's mesh over NCCL across the cards of one machine: correctness
against one card, and the fused step's rays/s.

    python -c 'from nerf_experiments_tpu_torch.ops import cuda_build; cuda_build.build()'
    torchrun --standalone --nproc_per_node=N scripts/mesh_nccl_check.py [--out FILE]

Build the kernels first (as above), so that the N ranks load one library
instead of compiling it N times. Every rank (one a card, NCCL) then:
  1. runs `chip_smoke.py` phase 36's steps on the mesh (the fused north-star
     bf16 and dense fp32 steps through K4 on its shard, the dense flagship's
     plain step on stratified bins; with N = 4 that plain step also on a
     2 x 2 data x model mesh) and holds each against the same steps run
     whole on its own card, without a collective, at phase 8's tolerances;
     and `sharded_render` of 8191 rays through K2 against the whole render;
  2. runs `run_barf.main --mesh auto --fused_kernel` (north-star, 32^2, 24
     steps) through the entry point;
  3. times the fused north-star bf16 step (10 steps after 2, host clock,
     every rank synchronised) on one card without a mesh at 8192 rays, and
     on the mesh at 8192 global rays (8192 / N a card) and at 8192 a card.
Rank 0 prints the card's name and power limit, each check, and one JSON line
of the results last (also written to --out). It fails if a check fails.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from nerf_experiments_tpu_torch.experiments import run_barf  # noqa: E402
from nerf_experiments_tpu_torch.ops import cuda_build  # noqa: E402
from nerf_experiments_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402


def check_steps(name, cfg, fused, dev, mesh, ref, log) -> dict:
    """The mesh's steps against this card's whole steps `ref`."""
    bf16 = cfg.radiance.compute_dtype is not None
    losses, before, after, split = cs.mesh_steps(cfg, fused, dev, mesh)
    ref_losses, ref_before, ref_after, _ = ref
    cs.require(all(torch.equal(before[k], ref_before[k]) for k in before),
               f"{name}: other starting parameters")
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    upd = {k: cs.rel_norm(after[k] - before[k], ref_after[k] - before[k]) for k in before
           if float((ref_after[k] - before[k]).norm()) > 0}
    worst = max(upd, key=upd.get)
    log(f"{name}: loss rel err {loss_err:.3e} (tol {cs.TOL_STEP_LOSS[bf16]}), update rel norm "
        f"err worst {worst} {upd[worst]:.3e} (tol {cs.TOL_STEP_UPDATE[bf16]}), split leaves "
        f"{len(split)}")
    cs.require(loss_err <= cs.TOL_STEP_LOSS[bf16], f"{name}: loss err {loss_err}")
    cs.require(all(v <= cs.TOL_STEP_UPDATE[bf16] for v in upd.values()), f"{name}: update")
    # every rank holds the same parameters after the update
    flat = torch.cat([after[k].reshape(-1).float() for k in sorted(after)]).to(dev)
    parts = [torch.empty_like(flat) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, flat)
    cs.require(all(torch.equal(parts[0], p) for p in parts), f"{name}: ranks differ")
    return {"loss_rel_err": loss_err, "update_rel_err": upd[worst], "split_leaves": len(split)}


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda", help="cpu: a rehearsal over gloo")
    args = p.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = mesh_lib.make_mesh(device=args.device)  # on CUDA: NCCL, rank r on cuda:LOCAL_RANK
    dev, world, rank = mesh.device, dist.get_world_size(), dist.get_rank()

    def log(msg):
        if rank == 0:
            print(msg, flush=True)

    if dev.type == "cuda":
        if rank == 0:
            log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                "--format=csv,noheader"], capture_output=True, text=True,
                               check=True).stdout.strip())
        cs.require(cuda_build.build().seconds == 0.0, "build the kernels before torchrun")
        cuda_build.library()
    log(f"{world} ranks over {dist.get_backend()}, torch {torch.__version__}")
    out = {"world": world, "checks": {}}

    ref = {name: cs.mesh_steps(cfg, fused, dev) for name, cfg, fused in cs.mesh_configs()}
    for name, cfg, fused in cs.mesh_configs():
        out["checks"][name] = check_steps(name, cfg, fused, dev, mesh, ref[name], log)
    if world == 4:
        name, cfg, fused = cs.mesh_configs()[-1]
        model = mesh_lib.make_mesh(2, 2, device=dev)
        out["checks"][name + ", 2 x 2"] = check_steps(name + ", 2 x 2 (data x model)", cfg,
                                                     fused, dev, model, ref[name], log)
        cs.require(out["checks"][name + ", 2 x 2"]["split_leaves"] >= 4, "2 x 2: no split")
    whole = cs.mesh_render(dev)
    got = cs.mesh_render(dev, mesh)
    err = cs.max_err(got, whole)
    log(f"sharded_render of {cs.MESH_RENDER_RAYS} rays through K2: max abs err {err:.3e} "
        f"(tol {cs.TOL_FP32}), bitwise {torch.equal(got, whole)}")
    cs.require(err <= cs.TOL_FP32, f"sharded_render err {err}")
    out["checks"]["sharded_render_max_abs_err"] = err
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as workdir:
        outdir = [os.path.join(workdir, "run_barf")] if rank == 0 else [None]
        dist.broadcast_object_list(outdir, src=0)
        counters = cs.launch_counters()
        for c in counters.values():
            c.launches = 0
        steps = 24
        state = run_barf.main(
            ["--image_size", "32", "--batch_size", "1024", "--max_steps", str(steps),
             "--log_every_n_steps", "4", "--fused_kernel", "--device", args.device, "--mesh",
             "auto", "--out_dir", outdir[0]] + cs.NORTHSTAR)
        torch.cuda.synchronize()
        k4 = counters["flagship_train"].launches
        cs.require(state.step == steps and k4 == steps, f"run_barf: {state.step} steps, K4 {k4}")
        if rank == 0:
            rows = [json.loads(line) for line in open(os.path.join(outdir[0], "metrics.jsonl"))]
            losses = [r["loss"] for r in rows if "loss" in r]
            cs.require(all(math.isfinite(v) for v in losses), "run_barf: non-finite loss")
            log(f"run_barf --mesh auto on {world} ranks: {steps} steps, K4 {k4} launches a "
                f"rank, loss {losses[0]:.6f} -> {losses[-1]:.6f}")
            out["run_barf_losses"] = losses
        dist.barrier()

    cfg = cs.slice_config("north_star_S32 bf16")
    rates = {}
    for label, n_rays, on_mesh in (("one card, no mesh", cs.MESH_RAYS, False),
                                   (f"mesh, {cs.MESH_RAYS} global", cs.MESH_RAYS, True),
                                   (f"mesh, {cs.MESH_RAYS} a card", cs.MESH_RAYS * world, True)):
        state, step, batch = cs.mesh_state(cfg, True, dev, mesh if on_mesh else None, n_rays)
        seconds = cs.time_mesh_step(step, state, batch, dev, 70, barrier=dist.barrier)
        parts = [None] * world
        dist.all_gather_object(parts, seconds)
        rates[label] = n_rays * cs.MESH_TIMED_STEPS / max(parts)
        log(f"fused north-star bf16 step, {label}: {1e3 * max(parts) / cs.MESH_TIMED_STEPS:.3f} "
            f"ms a step, {rates[label]:.0f} rays/s")
        del state, step, batch
        torch.cuda.empty_cache()
    out["rays_per_s"] = rates
    mesh.close()
    if rank == 0:
        line = json.dumps(out)
        if args.out:
            with open(args.out, "w") as f:
                f.write(line + "\n")
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
