"""BARF: joint NeRF + camera-pose self-calibration (flagship entry point).

CLI parity with `barf/run_barf.py:23-198` and the JAX package's `run_barf`:
pose noise sigmas, blur-sigma ladder, seed; BARF positional encodings (10/4
levels, scale 1, identity prepended) annealed between steps 20k and 100k;
NerfModel 4x256, 2 segments, delayed direction; 128 samples/ray,
equidistant sampling with offset -1.

`build` assembles the experiment: config, data module, ray stores on the
device, parameters drawn from a generator seeded with --seed, the train step
(`--fused_kernel`: the flagship train kernel) and the trainer; `main`
trains, and with `--resume` continues from the latest checkpoint in
<out_dir>/ckpt. `--mesh auto` trains data-parallel over every rank of a
`torchrun` launch (one a card; the fused step runs K4 on every rank's shard),
or over a one-rank mesh without a launcher:

    python -m nerf_experiments_tpu_torch.experiments.run_barf --fused_kernel \
        [--bf16] [--samples_per_ray 32 --samples_per_ray_proposal 64 \
        --proposal_hidden_dim 64 --proposal_n_hidden 1 | --occ_grid_resolution 64] \
        [--train_coarse_block 4]
    torchrun --standalone --nproc_per_node=N \
        -m nerf_experiments_tpu_torch.experiments.run_barf --mesh auto --fused_kernel ...
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from nerf_experiments_tpu_torch.data import blender
from nerf_experiments_tpu_torch.encodings.fourier import Barf
from nerf_experiments_tpu_torch.experiments import common
from nerf_experiments_tpu_torch.models import nerf_mlp
from nerf_experiments_tpu_torch.ops import occgrid
from nerf_experiments_tpu_torch.systems import barf as barf_sys
from nerf_experiments_tpu_torch.training.trainer import TrainerConfig


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--camera_origin_noise_sigma", type=float, default=0.15)
    p.add_argument("--camera_rotation_noise_sigma", type=float, default=0.15)
    p.add_argument("--start_blur_sigma", type=float, default=0.0)
    p.add_argument("--n_blur_sigmas", type=int, default=10)
    p.add_argument("--optimize_camera", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--samples_per_ray", type=int, default=128)
    p.add_argument("--samples_per_ray_proposal", type=int, default=0)
    # size of the dedicated proposal (coarse) net. 0 = same architecture as
    # the radiance net (the reference's coarse/fine arrangement,
    # `model_interpolation.py:93-104`). A small density-oriented net (e.g.
    # 64x1) is the fast hierarchical recipe (`garf/model_proposal.py:10-77`
    # uses a smaller coarse net too) — the north-star throughput config.
    p.add_argument("--proposal_hidden_dim", type=int, default=0)
    p.add_argument("--proposal_n_hidden", type=int, default=1)
    # occupancy-grid guided sampling (the nerfacc OccGridEstimator analog,
    # ops/occgrid.py): replaces the proposal-net coarse stage
    p.add_argument("--occ_grid_resolution", type=int, default=0,
                   help="cells per axis; 0 = off")
    p.add_argument("--occ_grid_coarse", type=int, default=64,
                   help="coarse grid-lookup bins per ray")
    p.add_argument("--occ_grid_update_every", type=int, default=16)
    p.add_argument("--occ_grid_aabb_half", type=float, default=2.0)
    p.add_argument("--lr_decay_end_step", type=int, default=200_000)
    # net LR start (reference default 5e-4, `barf/run_barf.py:48`); exposed
    # for large-batch LR-scaling studies (stop stays start/50)
    p.add_argument("--learning_rate", type=float, default=5e-4)
    # camera-group optimizer knobs (defaults = the reference's recipe,
    # `barf/run_barf.py:44-59`). --camera_adam_eps is the recipe that fixed
    # GARF joint calibration (RESULTS.md): a large eps makes small camera
    # updates gradient-proportional instead of Adam-sign random steps.
    p.add_argument("--camera_lr", type=float, default=1e-3)
    p.add_argument("--camera_lr_stop", type=float, default=1e-5)
    p.add_argument("--camera_adam_eps", type=float, default=None)
    p.add_argument("--hidden_dim", type=int, default=256)
    p.add_argument("--n_hidden", type=int, default=4)
    p.add_argument("--n_segments", type=int, default=2)
    p.add_argument("--delayed_direction", action="store_true", default=True)
    p.add_argument("--no-delayed_direction", dest="delayed_direction", action="store_false")
    p.add_argument("--delayed_density", action="store_true", default=False)
    p.add_argument("--fourier_levels_pos", type=int, default=10)
    p.add_argument("--fourier_levels_dir", type=int, default=4)
    p.add_argument("--checkpoint_every_n_epochs", type=float, default=1.0,
                   help="0 disables checkpointing")
    p.add_argument("--log_every_n_steps", type=int, default=50)
    p.add_argument("--resume", action="store_true", default=False,
                   help="resume from the latest checkpoint in out_dir/ckpt")
    p.add_argument("--alpha_decay_start_step", type=int, default=20_000)
    p.add_argument("--alpha_decay_end_step", type=int, default=100_000)
    p.add_argument("--fused_kernel", action="store_true", default=False,
                   help="run the step through the flagship train kernel "
                        "(ops/train_megakernel.py:flagship_train_grads; "
                        "flagship configs, gradient-exact). On the H100 it "
                        "is faster than the plain autograd step with --bf16 "
                        "(tensor cores) and slower in fp32, and takes ~16 KB "
                        "(bf16) / ~22 KB (fp32) of device memory per sample "
                        "row for its workspace; see PERF.md")
    p.add_argument("--train_coarse_block", type=int, default=1,
                   help="block-coarse training: share the coarse stage "
                        "per block of N raster-consecutive rays (--fused_kernel and a "
                        "coarse stage: proposal or occupancy grid)")
    p.add_argument("--image_log_period_epochs", type=float, default=None,
                   help="fixed image-reconstruction log period in epochs "
                        "(default: the reference's 0.002->1/24 taper)")
    common.add_common_args(p)
    return p.parse_args(argv)


def build_config(args):
    """(BarfConfig, data module, not yet set up) for these flags."""
    if args.train_coarse_block > 1:
        if not args.fused_kernel:
            raise ValueError("--train_coarse_block requires --fused_kernel")
        if args.samples_per_ray_proposal <= 0 and args.occ_grid_resolution <= 0:
            raise ValueError("--train_coarse_block needs a coarse stage (proposal or occ grid)")
    scene = common.resolve_scene(args.scene_path, args.image_size)
    sigmas = common.blur_sigmas_from_start(args.start_blur_sigma, args.n_blur_sigmas)

    dm = blender.DataModule(
        scene_path=scene,
        image_width=args.image_size,
        image_height=args.image_size,
        space_transform_scale=1.0,
        space_transform_translate=np.zeros(3),
        rotation_noise_sigma=args.camera_rotation_noise_sigma,
        translation_noise_sigma=args.camera_origin_noise_sigma,
        camera_noise_seed=args.seed,
        gaussian_blur_sigmas=sigmas,
        validation_fraction=0.06,
        validation_fraction_shuffle=1234,
    )

    def iter_to_epoch(it):
        return it * args.batch_size / (dm.n_training_images * args.image_size**2)

    enc_kwargs = dict(
        alpha_start=0.0,
        alpha_increase_start_epoch=iter_to_epoch(args.alpha_decay_start_step),
        alpha_increase_end_epoch=iter_to_epoch(args.alpha_decay_end_step),
        include_identity=True,
        scale=1.0,
    )
    compute_dtype = torch.bfloat16 if args.bf16 else None

    def mlp(n_hidden, hidden_dim, n_segments):
        return nerf_mlp.NerfMLPConfig(
            position_encoder=Barf(levels=args.fourier_levels_pos, **enc_kwargs),
            direction_encoder=Barf(levels=args.fourier_levels_dir, **enc_kwargs),
            n_hidden=n_hidden, hidden_dim=hidden_dim,
            delayed_direction=args.delayed_direction,
            delayed_density=args.delayed_density, n_segments=n_segments,
            learning_rate_start=args.learning_rate,
            learning_rate_stop=args.learning_rate / 50,
            learning_rate_decay_end=args.lr_decay_end_step,
            compute_dtype=compute_dtype,
        )

    proposal = None
    if args.samples_per_ray_proposal > 0 and args.proposal_hidden_dim > 0:
        proposal = mlp(args.proposal_n_hidden, args.proposal_hidden_dim, 1)

    occ = None
    if args.occ_grid_resolution > 0:
        occ = occgrid.OccGridConfig(
            resolution=args.occ_grid_resolution,
            aabb_half=args.occ_grid_aabb_half,
            n_coarse=args.occ_grid_coarse,
            update_every=args.occ_grid_update_every,
        )

    cfg = barf_sys.BarfConfig(
        radiance=mlp(args.n_hidden, args.hidden_dim, args.n_segments),
        proposal=proposal,
        occ=occ,
        n_training_images=dm.n_training_images,
        near=2.0, far=8.0,
        samples_per_ray_radiance=args.samples_per_ray,
        samples_per_ray_proposal=args.samples_per_ray_proposal,
        uniform_sampling_strategy="equidistant",
        uniform_sampling_offset_size=-1.0,
        optimize_camera=args.optimize_camera,
        camera_learning_rate_start=args.camera_lr,
        camera_learning_rate_stop=args.camera_lr_stop,
        camera_learning_rate_decay_end=args.lr_decay_end_step,
        camera_adam_eps=args.camera_adam_eps,
        max_gaussian_sigma=args.start_blur_sigma,
        gaussian_blur_sigmas=sigmas,
        train_coarse_block=args.train_coarse_block,
    )
    return cfg, dm


def build(args, device=None, mesh=None) -> common.BarfExperiment:
    """The experiment with its trainer, on `device` (default --device), or
    data-parallel over `mesh` on its rank's device."""
    cfg, dm = build_config(args)
    trainer_cfg = TrainerConfig(
        max_epochs=args.max_epochs,
        max_steps=args.max_steps,
        batch_size=args.batch_size,
        seed=args.seed,
        checkpoint_every_n_epochs=args.checkpoint_every_n_epochs or None,
        log_every_n_steps=args.log_every_n_steps,
    )
    name = (
        f"BARF translation={args.camera_origin_noise_sigma} "
        f"rotation={args.camera_rotation_noise_sigma}"
        + (f" blur={args.start_blur_sigma}" if args.start_blur_sigma > 0.25 else "")
    )
    return common.build_barf_experiment(
        cfg, dm, trainer_cfg, args.out_dir, device=device or args.device,
        use_wandb=args.wandb, wandb_name=name, image_log_names=(["r_1"], ["r_2"]),
        fused=args.fused_kernel, mesh=mesh,
        image_log_taper=(
            # constant period: (logging_start, delay_start, delay_end, taper)
            (args.image_log_period_epochs,) * 3 + (1.0,)
            if args.image_log_period_epochs else None),
    )


def main(argv=None) -> barf_sys.TrainState:
    """Train; with --resume, from the latest checkpoint in out_dir/ckpt (the
    reference's `trainer.fit(..., ckpt_path=...)`, barf/run_barf.py:198)."""
    args = parse_args(argv)
    mesh = common.mesh_from_flag(args.mesh, args.device)
    try:
        exp = build(args, mesh=mesh)
        if args.resume:
            common.resume_latest(exp, args.out_dir)
        return exp.fit()
    finally:
        if mesh is not None:
            mesh.close()


if __name__ == "__main__":
    main()
