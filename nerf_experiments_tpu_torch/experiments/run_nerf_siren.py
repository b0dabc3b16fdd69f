"""SIREN NeRF: a sine-activation radiance field with a residual colour head.

Port of the JAX package's `experiments/run_nerf_siren.py`, with the same
flags and defaults: parity with `nerf-siren/main.py` +
`nerf-siren/{model,nerf_model,linear_sine}.py`: omega-scaled sine layers
(SIREN init, omega 30), coarse + fine hierarchical sampling (64 + 128
samples, two SIREN nets), Adam 5e-5 -> 5e-6, no camera optimisation. The
SIREN plugs into the BARF system through its model-definition interface
(`SirenModelDef`) and trains through the plain step (torch autograd); on a
CUDA device the compositing of both stages runs the compositing kernels
(`ops/render.py:render_rays_auto`, forward and backward).

    python -m nerf_experiments_tpu_torch.experiments.run_nerf_siren [--bf16]
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from nerf_experiments_tpu_torch.data import blender
from nerf_experiments_tpu_torch.experiments import common
from nerf_experiments_tpu_torch.models import siren
from nerf_experiments_tpu_torch.models.common import ParamGroup
from nerf_experiments_tpu_torch.systems import barf as barf_sys
from nerf_experiments_tpu_torch.training.trainer import TrainerConfig


@dataclasses.dataclass(frozen=True)
class SirenModelDef:
    """Model definition of the SIREN NeRF (`nerf-siren/nerf_model.py`)."""

    cfg: siren.SirenConfig
    learning_rate_start: float = 5e-5
    learning_rate_stop: float = 5e-6
    learning_rate_decay_end: int = 100_000

    def init(self, generator: torch.Generator, device=None) -> siren.Siren:
        return siren.init(generator, self.cfg, device=device)

    def apply(self, params, pos, dir, pixel_width=None, t_start=None, t_end=None,
              alpha_pos=None, alpha_dir=None, pixel_width_sigma=0.0):
        return siren.apply(params, self.cfg, pos, dir)

    @property
    def param_group(self) -> ParamGroup:
        return ParamGroup(self.learning_rate_start, self.learning_rate_stop,
                          self.learning_rate_decay_end)

    def from_numpy(self, tree, device=None) -> siren.Siren:
        return siren.from_numpy(tree, self.cfg, device=device)

    def alphas_at(self, epoch_frac: float):
        return 0.0, 0.0  # no coarse-to-fine encoders

    def full_alphas(self):
        return 0.0, 0.0


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--input_scale", type=float, default=30.0,
                   help="omega_0 for the first SIREN layer")
    p.add_argument("--samples_per_ray_fine", type=int, default=128)
    p.add_argument("--samples_per_ray_coarse", type=int, default=64)
    p.add_argument("--learning_rate", type=float, default=5e-5)
    p.add_argument("--near", type=float, default=2.0)
    p.add_argument("--far", type=float, default=8.0)
    p.add_argument("--checkpoint_every_n_epochs", type=float, default=0.0)
    common.add_common_args(p)
    return p.parse_args(argv)


def build_config(args):
    """(BarfConfig, data module, not yet set up) for these flags."""
    common.refuse_mesh(args, "run_nerf_siren")
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
    model_def = SirenModelDef(
        cfg=siren.SirenConfig(input_scale=args.input_scale,
                              compute_dtype=torch.bfloat16 if args.bf16 else None),
        learning_rate_start=args.learning_rate,
        learning_rate_stop=args.learning_rate / 10,
    )
    cfg = barf_sys.BarfConfig(
        radiance=model_def,
        proposal=model_def,  # a separate coarse SIREN
        n_training_images=dm.n_training_images,
        near=args.near, far=args.far,
        samples_per_ray_radiance=args.samples_per_ray_fine,
        samples_per_ray_proposal=args.samples_per_ray_coarse,
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
        use_wandb=args.wandb, wandb_name=f"nerf-siren omega={args.input_scale}",
    )


def main(argv=None) -> barf_sys.TrainState:
    return build(parse_args(argv)).fit()


if __name__ == "__main__":
    main()
