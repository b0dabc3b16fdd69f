"""3-D Instant-NGP NeRF: multiresolution hash-grid encoding + small MLP.

Port of the JAX package's `experiments/run_3d_ingp.py`, with the same flags
and defaults: parity with `3d-ingp/main.py` + `3d-ingp/model.py:151-521`
(NaiveINGP): coarse + fine hash-grid NeRFs (hierarchical sampling),
positions normalised x/8 + 0.5 into the unit cube, Fourier direction
encoding (4 levels, unscaled), Adam betas (0.9, 0.99) eps 1e-15, no camera
optimisation. The hash-grid model plugs into the BARF system through its
model-definition interface (`IngpModelDef`) and trains through the plain
step (torch autograd): on a CUDA device the table access runs the hash-grid
kernels (`csrc/hashgrid.cu`) and the compositing the compositing kernels.

    python -m nerf_experiments_tpu_torch.experiments.run_3d_ingp \\
        [--bf16] [--encoder rolled] [--checkpoint_every_n_epochs 1]
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from nerf_experiments_tpu_torch.data import blender
from nerf_experiments_tpu_torch.encodings.fourier import Fourier
from nerf_experiments_tpu_torch.experiments import common
from nerf_experiments_tpu_torch.models import ingp
from nerf_experiments_tpu_torch.models.common import ParamGroup
from nerf_experiments_tpu_torch.ops import hashgrid
from nerf_experiments_tpu_torch.systems import barf as barf_sys
from nerf_experiments_tpu_torch.training.trainer import TrainerConfig


@dataclasses.dataclass(frozen=True)
class IngpModelDef:
    """Model definition of the hash-grid NeRF (`NerfModelINGP`)."""

    cfg: ingp.NerfINGPConfig
    learning_rate_start: float = 1e-3
    learning_rate_stop: float = 1e-4
    learning_rate_decay_end: int = 100_000
    # hash tables have no smoothness prior; L2 decay is the INGP paper's
    # overfit mitigation (AdamW's decoupled decay on the whole group)
    weight_decay: float = 0.0

    def init(self, generator: torch.Generator, device=None) -> ingp.NerfINGP:
        return ingp.nerf_ingp_init(generator, self.cfg, device=device)

    def apply(self, params, pos, dir, pixel_width=None, t_start=None, t_end=None,
              alpha_pos=None, alpha_dir=None, pixel_width_sigma=0.0):
        return ingp.nerf_ingp_apply(params, self.cfg, pos, dir)

    @property
    def param_group(self) -> ParamGroup:
        return ParamGroup(self.learning_rate_start, self.learning_rate_stop,
                          self.learning_rate_decay_end, weight_decay=self.weight_decay)

    def from_numpy(self, tree, device=None) -> ingp.NerfINGP:
        return ingp.nerf_ingp_from_numpy(tree, device=device)

    def alphas_at(self, epoch_frac: float):
        return 0.0, 0.0  # no coarse-to-fine encoders

    def full_alphas(self):
        return 0.0, 0.0


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--samples_per_ray_fine", type=int, default=128)
    p.add_argument("--samples_per_ray_coarse", type=int, default=64)
    p.add_argument("--n_levels", type=int, default=16)
    p.add_argument("--n_features", type=int, default=2)
    p.add_argument("--table_size", type=int, default=2**16)
    p.add_argument("--resolution_min", type=int, default=16)
    p.add_argument("--resolution_max", type=int, default=512)
    p.add_argument("--hidden_dim", type=int, default=64)
    p.add_argument("--n_hidden", type=int, default=2)
    p.add_argument("--learning_rate", type=float, default=1e-3)
    p.add_argument("--weight_decay", type=float, default=0.0,
                   help="L2 decay on the hash-NeRF group (INGP paper uses "
                        "1e-6) — overfit mitigation for small view counts")
    p.add_argument("--encoder", choices=ingp.ENCODERS, default="fused",
                   help="table access: xor hash ('fused', 'matmul') or the "
                        "additive hash ('rolled')")
    p.add_argument("--near", type=float, default=2.0)
    p.add_argument("--far", type=float, default=8.0)
    p.add_argument("--checkpoint_every_n_epochs", type=float, default=0.0)
    common.add_common_args(p)
    return p.parse_args(argv)


def build_config(args):
    """(BarfConfig, data module, not yet set up) for these flags."""
    common.refuse_mesh(args, "run_3d_ingp")
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
    grid = hashgrid.HashGridConfig(
        dim=3,
        resolution_min=args.resolution_min,
        resolution_max=args.resolution_max,
        table_size=args.table_size,
        n_features=args.n_features,
        n_levels=args.n_levels,
    )
    model_cfg = ingp.NerfINGPConfig(
        grid=grid,
        direction_encoder=Fourier(levels=4, scale=1.0, space_dimensions=3),
        n_hidden=args.n_hidden, hidden_dim=args.hidden_dim,
        compute_dtype=torch.bfloat16 if args.bf16 else None,
        encoder=args.encoder,
    )
    model_def = IngpModelDef(cfg=model_cfg, learning_rate_start=args.learning_rate,
                             learning_rate_stop=args.learning_rate / 10,
                             weight_decay=args.weight_decay)
    cfg = barf_sys.BarfConfig(
        radiance=model_def,
        proposal=model_def,  # a separate coarse hash NeRF (NaiveINGP style)
        n_training_images=dm.n_training_images,
        near=args.near, far=args.far,
        samples_per_ray_radiance=args.samples_per_ray_fine,
        samples_per_ray_proposal=args.samples_per_ray_coarse,
        uniform_sampling_strategy="stratified_uniform",
        optimize_camera=False,
        adam_eps=1e-15, adam_b2=0.99,
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
        use_wandb=args.wandb, wandb_name=f"3d-ingp L={args.n_levels} T={args.table_size}",
    )


def main(argv=None) -> barf_sys.TrainState:
    return build(parse_args(argv)).fit()


if __name__ == "__main__":
    main()
