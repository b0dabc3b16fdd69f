"""Mip-BARF ("bip barf"): integrated encodings with the coupled blur and IPE
sigma schedule, and camera-pose calibration.

CLI parity with `barf/run_bip_barf.py:22-188` and the JAX package's
`run_bip_barf`: IntegratedFourierFeatures (10 levels, identity, scale 1,
per-axis variance), an identity-only direction encoding, NerfModel 4x256 x 2
segments, 126 samples a ray, equidistant sampling with offset -1, LR 5e-4 ->
1e-5 over 200k steps, camera 1e-3 -> 1e-5; the image-blur sigma and the
IPE's pixel_width_sigma decay together from their start values at step 2000
to 1/4 at step 100k, and are 0 after (`barf/model_mip.py:170-225`). Trains
through the plain step (torch autograd; the compositing through its kernels
on the card).

    python -m nerf_experiments_tpu_torch.experiments.run_bip_barf \\
        [--image_size 64] [--bf16] [--resume]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from nerf_experiments_tpu_torch.data import blender
from nerf_experiments_tpu_torch.encodings.fourier import Barf, Integrated
from nerf_experiments_tpu_torch.experiments import common
from nerf_experiments_tpu_torch.models import nerf_mlp
from nerf_experiments_tpu_torch.systems import barf as barf_sys
from nerf_experiments_tpu_torch.training import schedules
from nerf_experiments_tpu_torch.training.trainer import TrainerConfig


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--camera_origin_noise_sigma", type=float, default=0.15)
    p.add_argument("--camera_rotation_noise_sigma", type=float, default=0.15)
    p.add_argument("--start_blur_sigma", type=float, default=200.0)
    p.add_argument("--start_pixel_width_sigma", type=float, default=200.0)
    p.add_argument("--max_blur_sigma", type=float, default=200.0)
    p.add_argument("--n_blur_sigmas", type=int, default=10)
    p.add_argument("--optimize_camera", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--camera_lr", type=float, default=1e-3)
    p.add_argument("--camera_lr_stop", type=float, default=1e-5)
    p.add_argument("--camera_adam_eps", type=float, default=None)
    p.add_argument("--resume", action="store_true", default=False,
                   help="resume from the latest checkpoint in out_dir/ckpt")
    p.add_argument("--image_log_period_epochs", type=float, default=None)
    p.add_argument("--samples_per_ray", type=int, default=126)
    p.add_argument("--samples_per_ray_proposal", type=int, default=0)
    p.add_argument("--sigma_decay_start_step", type=int, default=2000)
    p.add_argument("--sigma_decay_end_step", type=int, default=100_000)
    p.add_argument("--lr_decay_end_step", type=int, default=200_000)
    p.add_argument("--hidden_dim", type=int, default=256)
    p.add_argument("--n_hidden", type=int, default=4)
    p.add_argument("--checkpoint_every_n_epochs", type=float, default=1.0)
    common.add_common_args(p)
    return p.parse_args(argv)


def build_config(args):
    """(BarfConfig, data module, not yet set up) for these flags."""
    common.refuse_mesh(args, "run_bip_barf")
    scene = common.resolve_scene(args.scene_path, args.image_size)
    sigmas = common.blur_sigmas_from_start(args.max_blur_sigma, args.n_blur_sigmas)
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
    radiance = nerf_mlp.NerfMLPConfig(
        position_encoder=Integrated(levels=10, include_identity=True, scale=1.0,
                                    distribute_variance=False),
        # identity-only direction encoding: BarfPositionalEncoding(0, 1, 0, 1, True)
        direction_encoder=Barf(levels=0, alpha_start=1.0, include_identity=True, scale=1.0),
        n_hidden=args.n_hidden, hidden_dim=args.hidden_dim,
        delayed_direction=True, delayed_density=False, n_segments=2,
        learning_rate_start=5e-4, learning_rate_stop=1e-5,
        learning_rate_decay_end=args.lr_decay_end_step,
        compute_dtype=torch.bfloat16 if args.bf16 else None,
    )
    cfg = barf_sys.BarfConfig(
        radiance=radiance,
        n_training_images=dm.n_training_images,
        near=2.0, far=8.0,
        samples_per_ray_radiance=args.samples_per_ray,
        samples_per_ray_proposal=args.samples_per_ray_proposal,
        share_proposal_net=args.samples_per_ray_proposal > 0,  # MipNeRF style
        coarse_loss_weight=0.1,
        uniform_sampling_strategy="equidistant",
        uniform_sampling_offset_size=-1.0,
        optimize_camera=args.optimize_camera,
        camera_learning_rate_start=args.camera_lr if args.optimize_camera else 0.0,
        camera_learning_rate_stop=args.camera_lr_stop if args.optimize_camera else 0.0,
        camera_learning_rate_decay_end=args.lr_decay_end_step,
        camera_adam_eps=args.camera_adam_eps,
        max_gaussian_sigma=args.max_blur_sigma,
        gaussian_blur_sigmas=sigmas,
    )
    return cfg, dm


def mip_scalars(args):
    """(step, epoch_frac) -> (alpha_pos, alpha_dir, blur_sigma,
    pixel_width_sigma): the Mip sigma schedule, in place of the BARF alpha
    schedule (the integrated encoding has no alpha mask)."""
    def scalars(step: int, epoch_frac: float):
        sched = schedules.mip_sigma_schedule(
            step, args.sigma_decay_start_step, args.sigma_decay_end_step,
            args.start_blur_sigma, args.start_pixel_width_sigma)
        return (10.0, 0.0, schedules.sigma_floor(sched * args.start_blur_sigma),
                schedules.sigma_floor(sched * args.start_pixel_width_sigma))
    return scalars


def build(args, device=None) -> common.BarfExperiment:
    """The experiment with its trainer, on `device` (default --device)."""
    cfg, dm = build_config(args)
    trainer_cfg = TrainerConfig(
        max_epochs=args.max_epochs, max_steps=args.max_steps,
        batch_size=args.batch_size, seed=args.seed,
        checkpoint_every_n_epochs=args.checkpoint_every_n_epochs or None,
    )
    name = (f"bipBARF noise={args.camera_origin_noise_sigma} "
            f"blur={args.start_blur_sigma} pixel_width={args.start_pixel_width_sigma}")
    exp = common.build_barf_experiment(
        cfg, dm, trainer_cfg, args.out_dir, device=device or args.device,
        use_wandb=args.wandb, wandb_name=name, image_log_names=(["r_1"], ["r_2"]),
        image_log_taper=((args.image_log_period_epochs,) * 3 + (1.0,)
                         if args.image_log_period_epochs else None),
    )
    exp.trainer.scalar_fn = mip_scalars(args)
    return exp


def main(argv=None) -> barf_sys.TrainState:
    """Train; with --resume, from the latest checkpoint in out_dir/ckpt."""
    args = parse_args(argv)
    exp = build(args)
    if args.resume:
        common.resume_latest(exp, args.out_dir)
    return exp.fit()


if __name__ == "__main__":
    main()
