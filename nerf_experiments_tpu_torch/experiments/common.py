"""Shared experiment wiring: scene resolution, the blur-sigma ladder, the
common CLI flags, the mesh of `--mesh`, and `build_barf_experiment`, which
assembles a BARF system with its ray stores, train step, loggers and
trainer."""
from __future__ import annotations

import argparse
import dataclasses
import math
import os
import shutil
import tempfile
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from nerf_experiments_tpu_torch.cameras import calibration
from nerf_experiments_tpu_torch.data import blender, sampler, synthetic
from nerf_experiments_tpu_torch.parallel import mesh as mesh_lib
from nerf_experiments_tpu_torch.parallel import shard as shard_lib
from nerf_experiments_tpu_torch.systems import barf as barf_sys
from nerf_experiments_tpu_torch.training import loggers, schedules
from nerf_experiments_tpu_torch.training.checkpoints import CheckpointManager
from nerf_experiments_tpu_torch.training.trainer import Trainer, TrainerConfig


def resolve_scene(scene_path: str, image_size: int) -> str:
    """Resolve a scene path; "synthetic" generates a procedural Blender-format
    scene into a cache dir under the temporary directory."""
    if scene_path != "synthetic":
        return scene_path
    cache = os.path.join(tempfile.gettempdir(), f"netpu_synth_{image_size}")
    if not os.path.exists(os.path.join(cache, "transforms_train.json")):
        # generated aside and renamed into place: the ranks of a mesh may
        # all get here, and the first rename wins
        tmp = tempfile.mkdtemp(prefix=f"netpu_synth_{image_size}_", dir=tempfile.gettempdir())
        synthetic.generate_dataset(tmp, image_size=image_size)
        try:
            os.rename(tmp, cache)
        except OSError:
            if not os.path.exists(os.path.join(cache, "transforms_train.json")):
                raise
            shutil.rmtree(tmp, ignore_errors=True)
    return cache


def blur_sigmas_from_start(start_blur_sigma: float, n_blur_sigmas: int) -> Tuple[float, ...]:
    """The reference's geometric blur-sigma ladder (`barf/run_barf.py:48-53`):
    2^linspace(-1, log2(start), n-1) reversed, then 0.0 appended."""
    if start_blur_sigma <= 0.25:
        return (0.0, 0.0)
    if n_blur_sigmas <= 2:
        return (start_blur_sigma, 0.0)
    exps = np.linspace(-1, math.log2(start_blur_sigma), n_blur_sigmas - 1)
    ladder = [round(float(2.0**e), 2) for e in exps[::-1]]
    return tuple(ladder + [0.0])


def add_common_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--scene_path", type=str, default="synthetic",
                   help="Blender dataset dir, or 'synthetic' for the generated scene")
    p.add_argument("--mesh", type=str, default="",
                   help="device mesh for SPMD training: '' (single device), "
                        "'auto' (all devices data-parallel), or 'DxM' "
                        "(D-way data x M-way model parallel), e.g. '4x2'")
    p.add_argument("--image_size", type=int, default=64)
    p.add_argument("--batch_size", type=int, default=1024)
    p.add_argument("--max_epochs", type=int, default=100)
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--out_dir", type=str, default="runs/latest")
    p.add_argument("--seed", type=int, default=134534)
    p.add_argument("--wandb", action="store_true", default=False)
    p.add_argument("--bf16", action="store_true", default=False)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; a run without a card needs --device cpu")


def mesh_from_flag(mesh_flag: str, device=None) -> Optional[mesh_lib.Mesh]:
    """'' -> None; 'auto' -> every rank on the data axis; 'DxM' -> a (data x
    model) mesh. The ranks are the processes of `torchrun` (one a card), or
    this process alone; `device` is the entry point's --device. The caller
    closes the mesh when the run ends (`Mesh.close`)."""
    if not mesh_flag:
        return None
    if mesh_flag == "auto":
        return mesh_lib.make_mesh(device=device)
    n_data, n_model = (int(v) for v in mesh_flag.lower().split("x"))
    return mesh_lib.make_mesh(n_data, n_model, device=device)


def refuse_mesh(args, entry: str) -> None:
    """The entry points whose JAX counterparts parse --mesh and then ignore
    it: the port will not train or serve on one device under a flag that
    asks for more."""
    if args.mesh:
        raise ValueError(
            f"{entry} does not run on a mesh: its JAX counterpart parses --mesh and ignores "
            f"it, and this port will not train or serve on one device under --mesh "
            f"{args.mesh!r}")


def resume_latest(exp: "BarfExperiment", out_dir: str) -> "BarfExperiment":
    """Restore the latest checkpoint in out_dir/ckpt into `exp`'s state, if
    there is one (the reference's `trainer.fit(..., ckpt_path=...)`)."""
    mgr = CheckpointManager(os.path.join(out_dir, "ckpt"))
    if mgr.latest_step() is not None:
        exp.state = mgr.restore(exp.state)
        shard_lib.reshard(exp.state)
        print(f"resumed from step {mgr.latest_step()}")
    return exp


@dataclasses.dataclass
class BarfExperiment:
    cfg: barf_sys.BarfConfig
    state: barf_sys.TrainState
    trainer: Trainer
    dm: blender.DataModule
    train_store: sampler.RayStore

    def fit(self) -> barf_sys.TrainState:
        return self.trainer.fit(self.state)


def build_barf_experiment(
    cfg: barf_sys.BarfConfig,
    dm: blender.DataModule,
    trainer_cfg: TrainerConfig,
    out_dir: str,
    device=None,
    use_wandb: bool = False,
    wandb_name: Optional[str] = None,
    alpha_schedules=None,  # (pos_alpha_fn(epoch), dir_alpha_fn(epoch)) or None
    image_log_names: Tuple[Sequence[str], Sequence[str]] = ((), ()),
    checkpoint_keep: Optional[int] = None,
    image_log_taper: Optional[Tuple[float, float, float, float]] = None,
    fused: bool = False,  # the flagship train kernel's step
    mesh: Optional[mesh_lib.Mesh] = None,  # data-parallel step + sharded image renders
) -> BarfExperiment:
    """Ray stores on `device`, initial parameters drawn from a generator
    seeded with `trainer_cfg.seed`, the train step, validation, pose error,
    image/point loggers, checkpoints and the trainer. The trainer's
    `batch_block` is the system's `train_coarse_block`, so the batches come
    in the runs that the step shares its coarse stage across.

    With a mesh (the JAX `common.py:122-141`): the store and the parameters
    (broadcast from rank 0, split leaves sharded over a model axis) on the
    rank's device, the data-parallel fused step (K4 on every rank's shard)
    when `fused` and the config fuses and the model axis is 1, else the plain
    step under `pjit_train_step`; image logs render through
    `sharded_render`, and rank 0 alone writes."""
    device = mesh.device if mesh is not None else torch.device(device or "cuda")
    trainer_cfg = dataclasses.replace(trainer_cfg, batch_block=max(1, cfg.train_coarse_block))
    dm.setup("fit")
    train_store = sampler.make_ray_store(dm.dataset_train, device)
    val_store = sampler.make_ray_store(dm.dataset_val, device) if dm.dataset_val else None

    params = barf_sys.init(torch.Generator().manual_seed(trainer_cfg.seed), cfg).to(device)
    state = barf_sys.init_state(cfg, params)
    if mesh is None:
        step_fn = barf_sys.make_train_step(cfg, fused=fused)
    else:
        shard_lib.shard_state(state, mesh)
        fuse = fused and barf_sys.can_fuse_train_step(cfg) and mesh.model_size == 1
        step_fn = barf_sys.make_train_step(cfg, fused=fuse, mesh=mesh)
    model = barf_sys.model_def(cfg.radiance)
    levels = model.full_alphas()  # validation: every level unlocked

    def scalar_fn(step: int, epoch_frac: float):
        if alpha_schedules is not None:
            a_pos, a_dir = alpha_schedules[0](epoch_frac), alpha_schedules[1](epoch_frac)
        else:
            a_pos, a_dir = model.alphas_at(epoch_frac)
        return a_pos, a_dir, schedules.barf_sigma_alpha(a_pos, cfg.max_gaussian_sigma)

    raw = train_store.camera_origins_raw
    noisy = train_store.camera_origins_noisy

    def pose_fn(params):
        return barf_sys.pose_error_metric(params, raw, noisy)

    def val_step(params, batch):
        gauge = barf_sys.val_gauge(params, raw, noisy)
        _, metrics = barf_sys.loss_fn(params, cfg, batch, None, *levels, 0.0, train=False,
                                      val_gauge=gauge)
        return metrics

    metric_logger = loggers.MetricLogger(
        out_dir, use_wandb=use_wandb,
        wandb_kwargs={"project": "nerf-experiments", "name": wandb_name},
        active=mesh_lib.is_lead(mesh))

    callbacks = []
    train_names, val_names = image_log_names
    if train_names or val_names:
        fused_render = barf_sys.use_fused_render(cfg, device)

        def forward_fn(params, o, d, pw):
            return barf_sys.forward(params, cfg, None, o, d, pw, *levels, stratified=False,
                                    fused=fused_render)[0]

        render = forward_fn if mesh is None else shard_lib.sharded_render(forward_fn, mesh)

        @torch.no_grad()
        def render_fn(params, origs, dirs, pw, train_space, img_idx):
            o = torch.as_tensor(origs, device=device)
            d = torch.as_tensor(dirs, device=device)
            if train_space:
                idx = torch.full((o.shape[0],), img_idx, dtype=torch.int64, device=device)
                o, d = calibration.training_transform_rays(params.camera, idx, o, d)
            else:
                o, d = calibration.validation_transform_rays(
                    o, d, barf_sys.val_gauge(params, raw, noisy))
            rgb = render(params, o, d, torch.as_tensor(pw, device=device))
            return torch.clamp(rgb, 0.0, 1.0).cpu().numpy()

        img_logger = loggers.ImageReconstructionLogger(
            render_fn=render_fn, metric_logger=metric_logger,
            train_image_names=train_names, validation_image_names=val_names,
            schedule=loggers.TaperSchedule(*(image_log_taper or (0.002, 1 / 24, 1.0, 5.0))))
        callbacks.append(
            lambda trainer, state, step, ef: img_logger.maybe_log(ef, step, state.params, dm))

        @torch.no_grad()
        def predict_origins(params):
            return calibration.predicted_train_origins(params.camera, noisy).cpu().numpy()

        point_logger = loggers.CameraPointLogger(
            predict_origins_fn=predict_origins, metric_logger=metric_logger,
            schedule=loggers.TaperSchedule(0.0, 1 / 200, 1 / 16, 4.0))
        callbacks.append(lambda trainer, state, step, ef: point_logger.maybe_log(
            ef, step, state.params, raw.cpu().numpy()))

    ckpt_mgr = None
    if trainer_cfg.checkpoint_every_n_epochs:
        ckpt_mgr = CheckpointManager(os.path.join(out_dir, "ckpt"), keep=checkpoint_keep)

    trainer = Trainer(
        cfg=trainer_cfg, train_store=train_store, step_fn=step_fn, scalar_fn=scalar_fn,
        metric_logger=metric_logger, val_store=val_store, val_fn=val_step,
        pose_error_fn=pose_fn, checkpoint_manager=ckpt_mgr, callbacks=callbacks,
        lr_fn=barf_sys.lr_fn(cfg, params), mesh=mesh)
    return BarfExperiment(cfg=cfg, state=state, trainer=trainer, dm=dm,
                          train_store=train_store)
