"""naive-to-vanilla: vanilla NeRF with the naive <-> vanilla architecture
interpolation and coarse + fine hierarchical sampling.

Parity with `naive-to-vanilla/main.py` and the JAX package's
`run_naive_to_vanilla`: separate coarse and fine NerfModels, Fourier
encodings (10 / 4 levels), stratified uniform sampling, PDF-weighted fine
sampling, no camera calibration. Trains through the plain step.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from nerf_experiments_tpu_torch.data import blender
from nerf_experiments_tpu_torch.encodings.fourier import Fourier
from nerf_experiments_tpu_torch.experiments import common
from nerf_experiments_tpu_torch.models import nerf_mlp
from nerf_experiments_tpu_torch.systems import barf as barf_sys
from nerf_experiments_tpu_torch.training.trainer import TrainerConfig


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--n_hidden", type=int, default=4)
    p.add_argument("--hidden_dim", type=int, default=256)
    p.add_argument("--n_segments", type=int, default=2)
    p.add_argument("--delayed_direction", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--delayed_density", action=argparse.BooleanOptionalAction, default=False)
    p.add_argument("--samples_per_ray_coarse", type=int, default=64)
    p.add_argument("--samples_per_ray_fine", type=int, default=192)
    p.add_argument("--near", type=float, default=2.0)
    p.add_argument("--far", type=float, default=8.0)
    p.add_argument("--learning_rate", type=float, default=5e-4)
    p.add_argument("--checkpoint_every_n_epochs", type=float, default=0.0)
    common.add_common_args(p)
    return p.parse_args(argv)


def build(args, device=None) -> common.BarfExperiment:
    """The experiment with its trainer, on `device` (default --device)."""
    common.refuse_mesh(args, "run_naive_to_vanilla")
    scene = common.resolve_scene(args.scene_path, args.image_size)
    dm = blender.DataModule(
        scene_path=scene,
        image_width=args.image_size,
        image_height=args.image_size,
        space_transform_scale=1.0,
        space_transform_translate=np.zeros(3),
        gaussian_blur_sigmas=(0.0,),
        validation_fraction=0.06,
        validation_fraction_shuffle=1234,
    )

    def mlp():
        return nerf_mlp.NerfMLPConfig(
            position_encoder=Fourier(levels=10, scale=1.0),
            direction_encoder=Fourier(levels=4, scale=1.0),
            n_hidden=args.n_hidden, hidden_dim=args.hidden_dim,
            delayed_direction=args.delayed_direction,
            delayed_density=args.delayed_density,
            n_segments=args.n_segments,
            learning_rate_start=args.learning_rate,
            learning_rate_stop=args.learning_rate / 10,
            learning_rate_decay_end=200_000,
            compute_dtype=torch.bfloat16 if args.bf16 else None,
        )

    cfg = barf_sys.BarfConfig(
        radiance=mlp(),
        proposal=mlp(),  # a separate coarse net
        n_training_images=dm.n_training_images,
        near=args.near, far=args.far,
        samples_per_ray_radiance=args.samples_per_ray_fine,
        samples_per_ray_proposal=args.samples_per_ray_coarse,
        uniform_sampling_strategy="stratified_uniform",
        optimize_camera=False,
        gaussian_blur_sigmas=(0.0,),
    )
    trainer_cfg = TrainerConfig(
        max_epochs=args.max_epochs, max_steps=args.max_steps,
        batch_size=args.batch_size, seed=args.seed,
        checkpoint_every_n_epochs=args.checkpoint_every_n_epochs or None,
    )
    return common.build_barf_experiment(
        cfg, dm, trainer_cfg, args.out_dir, device=device or args.device,
        use_wandb=args.wandb, wandb_name=f"naive-to-vanilla seg={args.n_segments}",
    )


def main(argv=None) -> barf_sys.TrainState:
    return build(parse_args(argv)).fit()


if __name__ == "__main__":
    main()
