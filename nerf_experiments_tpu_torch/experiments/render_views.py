"""Render full views from a checkpoint + report split PSNR (the serving path).

Loads a checkpoint written by the port's `CheckpointManager`, re-renders
whole images (val/test through the Kabsch gauge, train through the learned
extrinsics), writes PNGs, and prints per-image + mean PSNR as one JSON line.
On a CUDA device the flagship configs render through the hand-written
kernels (`ops/train_megakernel.py:flagship_render`, and the compositing
kernel for a proposal stage); a run_mip_nerf or run_bip_barf checkpoint
(`--entry mip|bip`: integrated encodings) through plain torch and the
compositing kernel; a run_3d_ingp checkpoint (`--entry ingp`) through the
hash-grid kernel and the compositing kernel. `--serve_block N` shares each
coarse stage (proposal net or occupancy grid) across N raster-consecutive
rays (`systems/barf.py:render_block_coarse`).

    python -m nerf_experiments_tpu_torch.experiments.render_views \\
        --ckpt_dir runs/latest/ckpt --scene_path synthetic --split test
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from nerf_experiments_tpu_torch.cameras import calibration
from nerf_experiments_tpu_torch.experiments import common, run_barf
from nerf_experiments_tpu_torch.ops.metrics import psnr
from nerf_experiments_tpu_torch.systems import barf as barf_sys
from nerf_experiments_tpu_torch.training.checkpoints import CheckpointManager
from nerf_experiments_tpu_torch.utils.profiling import annotate

# run_barf config flags needed to rebuild the same model
_RUN_BARF_ARGS = (
    "--camera_origin_noise_sigma", "--camera_rotation_noise_sigma",
    "--start_blur_sigma", "--n_blur_sigmas", "--samples_per_ray",
    "--samples_per_ray_proposal", "--hidden_dim", "--n_hidden",
    "--n_segments", "--fourier_levels_pos", "--fourier_levels_dir",
    "--proposal_hidden_dim", "--proposal_n_hidden",
    "--occ_grid_resolution", "--occ_grid_coarse",
    "--occ_grid_update_every", "--occ_grid_aabb_half",
)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt_dir", type=str, required=True)
    p.add_argument("--ckpt_step", type=int, default=None)
    p.add_argument("--entry", choices=["barf", "mip", "bip", "ingp"], default="barf",
                   help="which experiment entry built the checkpoint: "
                        "run_barf-family configs, run_mip_nerf (IPE cone "
                        "casting, near/far from its own defaults), "
                        "run_bip_barf (Mip-BARF: IPE + sigma schedule), or "
                        "run_3d_ingp (hash-grid NeRF; fine / coarse samples "
                        "from --samples_per_ray / --samples_per_ray_proposal, "
                        "MLP from --hidden_dim / --n_hidden)")
    # run_3d_ingp grid flags (used when --entry ingp rebuilds the model)
    p.add_argument("--ingp_n_levels", type=int, default=16)
    p.add_argument("--ingp_n_features", type=int, default=2)
    p.add_argument("--ingp_table_size", type=int, default=2**16)
    p.add_argument("--ingp_resolution_max", type=int, default=512)
    p.add_argument("--ingp_encoder", choices=("fused", "matmul", "rolled"),
                   default="fused")
    p.add_argument("--ingp_weight_decay", type=float, default=0.0,
                   help="the training run's; kept for the JAX package's CLI "
                        "(a params-only restore does not need it)")
    p.add_argument("--split", choices=["train", "val", "test"], default="test")
    p.add_argument("--serve_block", type=int, default=1,
                   help="block-coarse serving (systems/barf.py:render_block_coarse): "
                        "each run of N raster-consecutive rays shares the fine bins of "
                        "its first ray's coarse stage; 1 = the standard path")
    p.add_argument("--n_images", type=int, default=None, help="limit rendered views")
    p.add_argument("--chunk", type=int, default=2048)
    defaults = run_barf.parse_args([])
    for flag in _RUN_BARF_ARGS:
        name = flag.lstrip("-")
        p.add_argument(flag, type=type(getattr(defaults, name)),
                       default=getattr(defaults, name))
    common.add_common_args(p)
    return p.parse_args(argv)


def _build_mip(args):
    """(BarfConfig, data module) of the run_mip_nerf experiment these flags name."""
    from nerf_experiments_tpu_torch.experiments import run_mip_nerf

    mip_args = run_mip_nerf.parse_args([
        "--scene_path", args.scene_path, "--image_size", str(args.image_size),
        "--batch_size", str(args.batch_size),
        "--samples_per_ray", str(args.samples_per_ray),
        "--samples_per_ray_proposal", str(args.samples_per_ray_proposal),
        "--hidden_dim", str(args.hidden_dim), "--n_hidden", str(args.n_hidden),
        "--n_segments", str(args.n_segments),
        "--checkpoint_every_n_epochs", "0",
        "--seed", str(args.seed), "--out_dir", args.out_dir,
    ] + (["--bf16"] if args.bf16 else []))
    return run_mip_nerf.build_config(mip_args)


def _build_bip(args):
    """(BarfConfig, data module) of the run_bip_barf experiment these flags name."""
    from nerf_experiments_tpu_torch.experiments import run_bip_barf

    bip_args = run_bip_barf.parse_args([
        "--scene_path", args.scene_path, "--image_size", str(args.image_size),
        "--batch_size", str(args.batch_size),
        "--camera_origin_noise_sigma", str(args.camera_origin_noise_sigma),
        "--camera_rotation_noise_sigma", str(args.camera_rotation_noise_sigma),
        "--samples_per_ray", str(args.samples_per_ray),
        "--samples_per_ray_proposal", str(args.samples_per_ray_proposal),
        "--hidden_dim", str(args.hidden_dim), "--n_hidden", str(args.n_hidden),
        "--start_blur_sigma", str(args.start_blur_sigma),
        "--max_blur_sigma", str(args.start_blur_sigma),
        "--checkpoint_every_n_epochs", "0",
        "--seed", str(args.seed), "--out_dir", args.out_dir,
    ] + (["--bf16"] if args.bf16 else []))
    return run_bip_barf.build_config(bip_args)


def _build_ingp(args):
    """(BarfConfig, data module) of the run_3d_ingp experiment these flags name."""
    from nerf_experiments_tpu_torch.experiments import run_3d_ingp

    ingp_args = run_3d_ingp.parse_args([
        "--scene_path", args.scene_path, "--image_size", str(args.image_size),
        "--batch_size", str(args.batch_size),
        "--samples_per_ray_fine", str(args.samples_per_ray),
        "--samples_per_ray_coarse", str(args.samples_per_ray_proposal),
        "--n_levels", str(args.ingp_n_levels),
        "--n_features", str(args.ingp_n_features),
        "--table_size", str(args.ingp_table_size),
        "--resolution_max", str(args.ingp_resolution_max),
        "--weight_decay", str(args.ingp_weight_decay),
        "--encoder", args.ingp_encoder,
        "--hidden_dim", str(args.hidden_dim), "--n_hidden", str(args.n_hidden),
        "--checkpoint_every_n_epochs", "0",
        "--seed", str(args.seed), "--out_dir", args.out_dir,
    ] + (["--bf16"] if args.bf16 else []))
    return run_3d_ingp.build_config(ingp_args)


def main(argv=None):
    args = parse_args(argv)
    common.refuse_mesh(args, "render_views")
    entry_configs = {"mip": _build_mip, "bip": _build_bip, "ingp": _build_ingp}
    if args.entry in entry_configs:
        cfg, dm = entry_configs[args.entry](args)
        params = barf_sys.init(torch.Generator().manual_seed(args.seed), cfg).to(args.device)
        return _render(args, cfg, dm, params)
    model_flags = [v for flag in _RUN_BARF_ARGS
                   for v in (flag, str(getattr(args, flag.lstrip("-"))))]
    barf_args = run_barf.parse_args([
        "--scene_path", args.scene_path, "--image_size", str(args.image_size),
        "--batch_size", str(args.batch_size), "--checkpoint_every_n_epochs", "0",
        "--seed", str(args.seed), "--out_dir", args.out_dir,
    ] + model_flags + (["--bf16"] if args.bf16 else []))
    cfg, dm = run_barf.build_config(barf_args)
    params = barf_sys.init(torch.Generator().manual_seed(args.seed), cfg).to(args.device)
    return _render(args, cfg, dm, params)


def render_image(params, cfg, origs: np.ndarray, dirs: np.ndarray, gauge,
                 pixel_width: float, chunk: int, device, alpha_pos, alpha_dir,
                 serve_block: int = 1) -> np.ndarray:
    """One view's rays (HW, 3) through the gauge and `forward` (or, with
    serve_block > 1, `render_block_coarse`) in chunks of `chunk` rays ->
    clipped rgb (HW, 3). A chunk is padded with its last rays to a multiple
    of serve_block, in raster order as block-coarse serving needs.

    The view's rays go to the device once, in the first chunk, and its rgb
    comes back once, after the last: between them the host only issues work,
    so it prepares chunk n+1 while the device runs chunk n. Each of the three
    copies blocks on a CUDA device (`render_image.host_transfers` counts them)."""
    fused = barf_sys.use_fused_render(cfg, device)
    n = origs.shape[0]
    out = torch.empty((n, 3), dtype=torch.float32, device=device)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        with annotate("render.rays"):
            if lo == 0:  # the view's rays, one copy each
                origs_d = torch.as_tensor(origs, device=device)
                dirs_d = torch.as_tensor(dirs, device=device)
                render_image.host_transfers += 2
            pad = (lo - hi) % serve_block
            o_c, d_c = origs_d[lo:hi], dirs_d[lo:hi]
            if pad:
                o_c = torch.cat([o_c, origs_d[hi - pad:hi]])
                d_c = torch.cat([d_c, dirs_d[hi - pad:hi]])
        o, d = calibration.validation_transform_rays(o_c, d_c, gauge)
        with torch.no_grad():
            if serve_block > 1:
                rgb = barf_sys.render_block_coarse(params, cfg, o, d, alpha_pos, alpha_dir,
                                                   block=serve_block, pixel_width=pixel_width)
            else:
                pw = torch.full((hi - lo, 1), pixel_width, device=device)
                rgb, _ = barf_sys.forward(params, cfg, None, o, d, pw, alpha_pos, alpha_dir,
                                          stratified=False, fused=fused)
        with annotate("render.to_host"):
            torch.clamp(rgb[:hi - lo], 0.0, 1.0, out=out[lo:hi])
            if hi == n:  # the view's rgb: waits for every chunk's kernels
                out = out.cpu()
                render_image.host_transfers += 1
    return out.numpy()


render_image.host_transfers = 0


def _render(args, cfg, dm, params):
    mgr = CheckpointManager(args.ckpt_dir)
    params = mgr.restore(params, step=args.ckpt_step)
    device = torch.device(args.device)

    dm.setup("test" if args.split == "test" else "fit")
    dataset = {"train": dm.dataset_train, "val": dm.dataset_val,
               "test": dm.dataset_test}[args.split]
    if dataset is None:
        raise ValueError(f"split {args.split} not available")

    raw = torch.as_tensor(dm.dataset_train.camera_origins, device=device)
    noisy = torch.as_tensor(dm.dataset_train.camera_origins_noisy, device=device)
    # the gauge depends only on the parameters: computed once per checkpoint
    with torch.no_grad():
        gauge = barf_sys.val_gauge(params, raw, noisy)

    # every position level on; the direction alpha fixed at 4.0, as the JAX
    # package's render_views serves (its validation unlocks every level)
    a_pos, a_dir = barf_sys.model_def(cfg.radiance).full_alphas()[0], 4.0

    h, w = dataset.image_height, dataset.image_width
    hw = h * w
    results = []
    os.makedirs(os.path.join(args.out_dir, "renders"), exist_ok=True)
    n_images = min(args.n_images or dataset.n_images, dataset.n_images)
    for i in range(n_images):
        out = render_image(params, cfg, dataset.ray_origins[i], dataset.ray_directions[i],
                           gauge, float(dataset.pixel_width), args.chunk, device,
                           a_pos, a_dir, args.serve_block)
        target = dataset.images[i, :, :, -1, :].reshape(hw, 3)
        m = float(np.mean((out - target) ** 2))
        name = dataset.image_index_to_name[i]
        results.append({"image": name, "psnr": float(psnr(torch.tensor(m)))})
        from PIL import Image

        Image.fromarray((out.reshape(h, w, 3) * 255).astype(np.uint8)).save(
            os.path.join(args.out_dir, "renders", f"{args.split}_{name}.png"))

    mean_psnr = float(np.mean([r["psnr"] for r in results]))
    summary = {"split": args.split, "mean_psnr": mean_psnr, "per_image": results,
               "ckpt_step": mgr.latest_step() if args.ckpt_step is None else args.ckpt_step,
               "serve_block": args.serve_block}
    print(json.dumps(summary))
    with open(os.path.join(args.out_dir, "render_summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return summary


if __name__ == "__main__":
    main()
