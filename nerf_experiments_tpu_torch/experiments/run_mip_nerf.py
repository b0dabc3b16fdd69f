"""Mip-NeRF: cone casting with the integrated positional encoding.

CLI parity with `mip_NeRF/main.py:17-114` and the JAX package's
`run_mip_nerf`: near/far 1/10 - 1/3 with the automatic space transform
(mean-centred cameras, 3x their largest distance), a 64-sample proposal
stage sharing the radiance net (separate with --use_seperate_coarse_fine)
and 192 fine samples, IPE with 10 position levels and Fourier(4) directions,
LR 5e-4 decaying to 5e-5 over the run, coarse loss x0.1, density scale 21,
batch 2048. Trains through the plain step (torch autograd; the compositing
through its kernels on the card).

    python -m nerf_experiments_tpu_torch.experiments.run_mip_nerf \\
        [--image_size 64] [--batch_size 1024] [--bf16] [--resume]
"""
from __future__ import annotations

import argparse

import torch

from nerf_experiments_tpu_torch.data import blender
from nerf_experiments_tpu_torch.encodings.fourier import Barf, Fourier, Integrated
from nerf_experiments_tpu_torch.experiments import common
from nerf_experiments_tpu_torch.models import nerf_mlp
from nerf_experiments_tpu_torch.systems import barf as barf_sys
from nerf_experiments_tpu_torch.training.trainer import TrainerConfig


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--experiment_name", type=str, default="mip-nerf")
    p.add_argument("--n_hidden", type=int, default=4)
    p.add_argument("--hidden_dim", type=int, default=256)
    p.add_argument("--n_segments", type=int, default=2)
    p.add_argument("--use_fourier", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--use_proposal", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--resume", action="store_true", default=False,
                   help="resume from the latest checkpoint in out_dir/ckpt")
    p.add_argument("--use_seperate_coarse_fine", action=argparse.BooleanOptionalAction,
                   default=False)
    p.add_argument("--mip_distribute_variance", action=argparse.BooleanOptionalAction,
                   default=False)
    p.add_argument("--samples_per_ray", type=int, default=192)
    p.add_argument("--samples_per_ray_proposal", type=int, default=64)
    p.add_argument("--near", type=float, default=1 / 10)
    p.add_argument("--far", type=float, default=1 / 3)
    p.add_argument("--checkpoint_every_n_epochs", type=float, default=2.0)
    common.add_common_args(p)
    p.set_defaults(batch_size=2048, image_size=800)
    return p.parse_args(argv)


# mip_NeRF's own magic: MAGIC_NUMBER = 7 -> density scale 3 * 7 = 21
# (`mip_NeRF/model_interpolation.py:8,216`), needed at near/far 1/10 - 1/3
MIP_DENSITY_SCALE = 21.0


def build_config(args):
    """(BarfConfig, data module, not yet set up) for these flags."""
    common.refuse_mesh(args, "run_mip_nerf")
    scene = common.resolve_scene(args.scene_path, args.image_size)
    # the automatic space transform puts the scene at near/far 1/10 - 1/3
    dm = blender.DataModule(
        scene_path=scene,
        image_width=args.image_size,
        image_height=args.image_size,
        gaussian_blur_sigmas=(0.0,),
        validation_fraction=0.05,
        validation_fraction_shuffle=1234,
    )
    if args.use_fourier:
        position_encoder = Integrated(levels=10, include_identity=True, scale=1.0,
                                      distribute_variance=args.mip_distribute_variance)
        direction_encoder = Fourier(levels=4, scale=1.0)
    else:
        position_encoder = Barf(levels=0, alpha_start=1.0, include_identity=True)
        direction_encoder = Barf(levels=0, alpha_start=1.0, include_identity=True)

    # LR decay over the whole run (the reference decays per epoch)
    steps_per_epoch = max(1, dm.n_training_images * args.image_size**2 // args.batch_size)
    radiance = nerf_mlp.NerfMLPConfig(
        position_encoder=position_encoder,
        direction_encoder=direction_encoder,
        n_hidden=args.n_hidden, hidden_dim=args.hidden_dim,
        delayed_direction=True, delayed_density=False, n_segments=args.n_segments,
        learning_rate_start=5e-4, learning_rate_stop=5e-5,
        learning_rate_decay_end=args.max_epochs * steps_per_epoch,
        compute_dtype=torch.bfloat16 if args.bf16 else None,
    )
    cfg = barf_sys.BarfConfig(
        radiance=radiance,
        n_training_images=dm.n_training_images,
        near=args.near, far=args.far,
        samples_per_ray_radiance=args.samples_per_ray,
        samples_per_ray_proposal=args.samples_per_ray_proposal if args.use_proposal else 0,
        share_proposal_net=not args.use_seperate_coarse_fine,
        coarse_loss_weight=0.1,
        density_scale=MIP_DENSITY_SCALE,
        uniform_sampling_strategy="stratified_uniform",
        optimize_camera=False,
        gaussian_blur_sigmas=(0.0,),
    )
    return cfg, dm


def build(args, device=None) -> common.BarfExperiment:
    """The experiment with its trainer, on `device` (default --device)."""
    cfg, dm = build_config(args)
    trainer_cfg = TrainerConfig(
        max_epochs=args.max_epochs, max_steps=args.max_steps,
        batch_size=args.batch_size, seed=args.seed,
        checkpoint_every_n_epochs=args.checkpoint_every_n_epochs or None,
    )
    return common.build_barf_experiment(
        cfg, dm, trainer_cfg, args.out_dir, device=device or args.device,
        use_wandb=args.wandb, wandb_name=args.experiment_name,
        image_log_names=((), ["r_2"]),
    )


def main(argv=None) -> barf_sys.TrainState:
    """Train; with --resume, from the latest checkpoint in out_dir/ckpt."""
    args = parse_args(argv)
    exp = build(args)
    if args.resume:
        common.resume_latest(exp, args.out_dir)
    return exp.fit()


if __name__ == "__main__":
    main()
