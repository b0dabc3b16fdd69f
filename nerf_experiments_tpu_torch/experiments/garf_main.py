"""GARF / GaborF / SARF: calibrated NeRF with learnable-bandwidth activations.

Port of the JAX package's `experiments/garf_main.py`: one entry point for the
three families (`garf/main.py`, `gaborf/main.py`, `sarf/main.py`), chosen with
--activation, with the same flags and `ACTIVATION_DEFAULTS`. Defaults follow
`garf/main.py`: pose noise 0.15/0.15, camera LR 4e-3 -> 8e-4 over 2 epochs,
activation LR factor 16, init U(0.5, 2.0), proposal LR 5e-4 -> 5e-5 over 4
epochs (weight decay 1e-8), radiance LR 2e-4 -> 2e-5 over 6 epochs (weight
decay 1e-9), 64 proposal + 192 radiance samples, lindisp stratified
sampling, 40 epochs, seed 1337, camera-noise seed 13571113.

`build` assembles the experiment (data module, device ray stores, parameters
drawn from a generator seeded with --seed, the train step, validation through
the Kabsch gauge, the ray-density and image loggers, checkpoints, the
trainer); `main` trains, and with --resume continues from the latest
checkpoint in <out_dir>/ckpt. With --fused_kernel each step's radiance
gradients come from the GARF train kernel, and on a CUDA device the image
logger renders through the GARF render kernel. With --conv_blur the training
targets are the raw train images blurred with a sigma that decays at every
scheduler period (`ops/image_blur.py:ConvBlurTargets`). With --mesh the
step is the plain one, data-parallel over the mesh's ranks (the JAX package
does not run the GARF kernel under a mesh).

    python -m nerf_experiments_tpu_torch.experiments.garf_main --fused_kernel \\
        --activation {gauss,gabor,sarf} [--bf16] [--resume] [--conv_blur]
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from nerf_experiments_tpu_torch.cameras import calibration
from nerf_experiments_tpu_torch.data import blender, sampler
from nerf_experiments_tpu_torch.experiments import common
from nerf_experiments_tpu_torch.models import garf
from nerf_experiments_tpu_torch.ops import image_blur
from nerf_experiments_tpu_torch.parallel import mesh as mesh_lib
from nerf_experiments_tpu_torch.parallel import shard as shard_lib
from nerf_experiments_tpu_torch.systems import garf_system
from nerf_experiments_tpu_torch.training import loggers
from nerf_experiments_tpu_torch.training.checkpoints import CheckpointManager
from nerf_experiments_tpu_torch.training.trainer import Trainer, TrainerConfig

ACTIVATION_DEFAULTS = {
    "gauss": dict(act_lr_factor=16.0, init_min=0.5, init_max=2.0,
                  camera_lr=(4e-3, 8e-4), max_epochs=40),
    "gabor": dict(act_lr_factor=128.0, init_min=0.0, init_max=2.0,
                  camera_lr=(4e-3, 8e-4), max_epochs=20),
    "sarf": dict(act_lr_factor=128.0, init_min=0.5, init_max=2.0,
                 camera_lr=(4e-9, 8e-9), max_epochs=40),
}


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--activation", choices=["gauss", "gabor", "sarf"], default="gauss")
    p.add_argument("--name", type=str, default=None)
    p.add_argument("--camera_origin_noise_sigma", type=float, default=0.15)
    p.add_argument("--camera_rotation_noise_sigma", type=float, default=0.15)
    p.add_argument("--camera_learning_rate_start", type=float, default=None)
    p.add_argument("--camera_learning_rate_stop", type=float, default=None)
    p.add_argument("--camera_learning_rate_decay_end", type=float, default=2.0,
                   help="in epochs (converted to steps like the reference)")
    p.add_argument("--activation_learning_rate_factor", type=float, default=None)
    p.add_argument("--init_min", type=float, default=None)
    p.add_argument("--init_max", type=float, default=None)
    p.add_argument("--proposal_learning_rate_start", type=float, default=5e-4)
    p.add_argument("--proposal_learning_rate_stop", type=float, default=5e-5)
    p.add_argument("--proposal_learning_rate_decay_end", type=float, default=4.0)
    p.add_argument("--proposal_weight_decay", type=float, default=1e-8)
    p.add_argument("--radiance_learning_rate_start", type=float, default=2e-4)
    p.add_argument("--radiance_learning_rate_stop", type=float, default=2e-5)
    p.add_argument("--radiance_learning_rate_decay_end", type=float, default=6.0)
    p.add_argument("--radiance_weight_decay", type=float, default=1e-9)
    p.add_argument("--proposal_samples_per_ray", type=int, default=64)
    p.add_argument("--radiance_samples_per_ray", type=int, default=192)
    p.add_argument("--scheduler_period_epoch_fraction", type=float, default=None,
                   help="gaborf-style rate-limited LR stepping (default 0.02 for gabor)")
    p.add_argument("--near", type=float, default=2.0)
    p.add_argument("--far", type=float, default=7.0)
    p.add_argument("--conv_blur", action="store_true", default=False,
                   help="decaying blur of the training targets (gaborf): the raw train "
                        "images re-blurred at every scheduler period (ops/image_blur.py)")
    p.add_argument("--blur_kernel_size", type=int, default=81)
    p.add_argument("--blur_relative_sigma_start", type=float, default=0.015)
    p.add_argument("--blur_relative_sigma_decay", type=float, default=0.99)
    p.add_argument("--checkpoint_every_n_epochs", type=float, default=None)
    p.add_argument("--resume", action="store_true", default=False,
                   help="resume from the latest checkpoint in out_dir/ckpt")
    p.add_argument("--camera_adam_eps", type=float, default=None,
                   help="Adam eps for the camera group; large values make small "
                        "camera updates gradient-proportional")
    p.add_argument("--no_interlevel_camera_grads", action="store_true", default=False,
                   help="detach the rays in the interlevel-loss branch")
    p.add_argument("--act_anneal_start_epoch", type=float, default=0.0,
                   help="activation annealing (gabor/sarf): the oscillation term is "
                        "scaled by gamma ramping 0 -> 1 between these epochs; 0/0 "
                        "disables (gamma = 1, reference semantics)")
    p.add_argument("--act_anneal_end_epoch", type=float, default=0.0)
    p.add_argument("--camera_freeze_start_epoch", type=float, default=0.0,
                   help="hold the camera extrinsics (LR = 0) between these epochs; "
                        "0/0 disables")
    p.add_argument("--camera_freeze_end_epoch", type=float, default=0.0)
    p.add_argument("--camera_freeze_during_anneal", action="store_true", default=False,
                   help="shortcut: freeze the cameras over exactly the "
                        "activation-anneal window")
    p.add_argument("--log_every_n_steps", type=int, default=50)
    p.add_argument("--fused_kernel", action="store_true", default=False,
                   help="run the radiance half of the step through the GARF train "
                        "kernel (ops/garf_megakernel.py:garf_radiance_train_grads; "
                        "gradient-exact); see PERF.md for its time and workspace")
    p.add_argument("--train_coarse_block", type=int, default=1,
                   help="share each proposal stage across this many raster-consecutive "
                        "rays (--fused_kernel only; GarfSystemConfig.train_coarse_block "
                        "+ TrainerConfig.batch_block)")
    common.add_common_args(p)
    p.set_defaults(seed=1337, max_epochs=None)
    return p.parse_args(argv)


def scheduler_period(args):
    """The LR scheduler's period in epochs, None for every step."""
    if args.scheduler_period_epoch_fraction is None and args.activation == "gabor":
        return 0.02  # gaborf/main.py scheduler period
    return args.scheduler_period_epoch_fraction


def build_config(args, dm: blender.DataModule, steps_per_epoch: int):
    """GarfSystemConfig for these flags (the data module set up)."""
    if args.camera_freeze_during_anneal:
        if args.camera_freeze_start_epoch or args.camera_freeze_end_epoch:
            raise SystemExit(
                "--camera_freeze_during_anneal conflicts with explicit "
                "--camera_freeze_start_epoch/--camera_freeze_end_epoch; pass one or the other")
        if not args.act_anneal_end_epoch > args.act_anneal_start_epoch:
            raise SystemExit(
                "--camera_freeze_during_anneal is a no-op because the activation-anneal "
                f"window is disabled (act_anneal {args.act_anneal_start_epoch}.."
                f"{args.act_anneal_end_epoch})")
    d = ACTIVATION_DEFAULTS[args.activation]
    act_factor = (d["act_lr_factor"] if args.activation_learning_rate_factor is None
                  else args.activation_learning_rate_factor)
    init_min = d["init_min"] if args.init_min is None else args.init_min
    init_max = d["init_max"] if args.init_max is None else args.init_max
    # an explicit 0.0 must freeze the camera, so no `or`-defaulting
    cam_lr_start = (d["camera_lr"][0] if args.camera_learning_rate_start is None
                    else args.camera_learning_rate_start)
    cam_lr_stop = (d["camera_lr"][1] if args.camera_learning_rate_stop is None
                   else args.camera_learning_rate_stop)

    def epochs_to_steps(e):
        return int(e * steps_per_epoch)

    compute_dtype = torch.bfloat16 if args.bf16 else None

    def net(lr_start, lr_stop, decay_end, weight_decay):
        return garf.GarfConfig(
            activation=args.activation, init_min=init_min, init_max=init_max,
            learning_rate_start=lr_start, learning_rate_stop=lr_stop,
            learning_rate_decay_end=epochs_to_steps(decay_end),
            activation_learning_rate_factor=act_factor, weight_decay=weight_decay,
            compute_dtype=compute_dtype)

    period = scheduler_period(args)
    freeze = ((args.act_anneal_start_epoch, args.act_anneal_end_epoch)
              if args.camera_freeze_during_anneal
              else (args.camera_freeze_start_epoch, args.camera_freeze_end_epoch))
    return garf_system.GarfSystemConfig(
        n_train_images=dm.n_training_images, near=args.near, far=args.far,
        proposal_samples_per_ray=args.proposal_samples_per_ray,
        radiance_samples_per_ray=args.radiance_samples_per_ray,
        net=net(args.radiance_learning_rate_start, args.radiance_learning_rate_stop,
                args.radiance_learning_rate_decay_end, args.radiance_weight_decay),
        proposal_net=net(args.proposal_learning_rate_start, args.proposal_learning_rate_stop,
                         args.proposal_learning_rate_decay_end, args.proposal_weight_decay),
        camera_learning_rate_start=cam_lr_start, camera_learning_rate_stop=cam_lr_stop,
        camera_learning_rate_decay_end=epochs_to_steps(args.camera_learning_rate_decay_end),
        scheduler_steps_per_period=max(1, epochs_to_steps(period)) if period else 1,
        interlevel_camera_grads=not args.no_interlevel_camera_grads,
        camera_adam_eps=args.camera_adam_eps,
        act_anneal_start_step=epochs_to_steps(args.act_anneal_start_epoch),
        act_anneal_end_step=epochs_to_steps(args.act_anneal_end_epoch),
        camera_freeze_start_step=epochs_to_steps(freeze[0]),
        camera_freeze_end_step=epochs_to_steps(freeze[1]),
        train_coarse_block=args.train_coarse_block,
    )


def build(args, device=None, mesh=None):
    """(cfg, state, trainer) on `device` (default --device), or data-parallel
    over `mesh` on its rank's device: the plain step under
    `pjit_train_step`, even with --fused_kernel, as the JAX
    `garf_main.py:219-230` runs it; image renders through `sharded_render`
    and rank 0 alone writes."""
    if args.train_coarse_block > 1 and not args.fused_kernel:
        raise ValueError("--train_coarse_block requires --fused_kernel")
    device = mesh.device if mesh is not None else torch.device(device or args.device)
    scene = common.resolve_scene(args.scene_path, args.image_size)
    dm = blender.DataModule(
        scene_path=scene, image_width=args.image_size, image_height=args.image_size,
        space_transform_scale=1.0, space_transform_translate=None,
        rotation_noise_sigma=args.camera_rotation_noise_sigma,
        translation_noise_sigma=args.camera_origin_noise_sigma,
        camera_noise_seed=13571113, gaussian_blur_sigmas=(0.0,),
        validation_fraction=0.06, validation_fraction_shuffle=1234)
    dm.setup("fit")
    train_store = sampler.make_ray_store(dm.dataset_train, device)
    val_store = sampler.make_ray_store(dm.dataset_val, device) if dm.dataset_val else None
    steps_per_epoch = max(1, train_store.n_rays // args.batch_size)
    cfg = build_config(args, dm, steps_per_epoch)
    max_epochs = args.max_epochs or ACTIVATION_DEFAULTS[args.activation]["max_epochs"]

    params = garf_system.init(torch.Generator().manual_seed(args.seed), cfg).to(device)
    state = garf_system.init_state(cfg, params)
    if mesh is not None:
        shard_lib.shard_state(state, mesh)
        step_fn = garf_system.make_train_step(cfg, mesh=mesh)
    else:
        step_fn = (garf_system.make_train_step_fused(cfg) if args.fused_kernel
                   else garf_system.make_train_step(cfg))

    raw = train_store.camera_origins_raw
    noisy = train_store.camera_origins_noisy

    def pose_fn(params):
        return garf_system.pose_error_metric(params, raw, noisy)

    def val_step(params, batch, act_anneal=1.0):
        # evaluated at the live anneal gamma, as the trainer passes it
        gauge = garf_system.val_gauge(params, raw, noisy)
        _, metrics = garf_system.loss_fn(params, cfg, batch, None, train=False,
                                         val_gauge=gauge, act_anneal=act_anneal)
        return metrics

    name = args.name or (f"{args.activation}:r{args.camera_rotation_noise_sigma:.2f}"
                         f"+t{args.camera_origin_noise_sigma:.2f}")
    metric_logger = loggers.MetricLogger(
        args.out_dir, use_wandb=args.wandb,
        wandb_kwargs={"project": "nerf-experiments", "name": name},
        active=mesh_lib.is_lead(mesh))
    trainer_cfg = TrainerConfig(
        max_epochs=max_epochs, max_steps=args.max_steps, batch_size=args.batch_size,
        seed=args.seed, checkpoint_every_n_epochs=args.checkpoint_every_n_epochs,
        log_every_n_steps=args.log_every_n_steps,
        batch_block=cfg.train_coarse_block)  # the system's block sets the batches'

    @torch.no_grad()
    def density_profiles(params, pos, dirs):
        """Density along the centre ray of a named train image, from both
        networks (`garf/ray_logger.py` parity)."""
        pos = torch.as_tensor(np.ascontiguousarray(pos), device=device)
        dirs = torch.as_tensor(np.ascontiguousarray(dirs), device=device)
        rgb, density = garf.radiance_apply(params.radiance, cfg.net, pos, dirs)
        prop = garf.proposal_apply(params.proposal, cfg.prop_cfg, pos)
        return {"radiance_density": density.cpu().numpy(),
                "proposal_density": prop.cpu().numpy(), "rgb": rgb.cpu().numpy()}

    # full-image reconstructions (`garf/image_logger.py` parity): train images
    # through the learned extrinsics, val through the gauge
    fused_render = garf_system.use_fused_render(cfg, device)

    def forward_fn(params, o, d, pw):
        return garf_system.forward(params, cfg, None, o, d, stratified=False,
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
                o, d, garf_system.val_gauge(params, raw, noisy))
        rgb = render(params, o, d, torch.as_tensor(pw, device=device))
        return torch.clamp(rgb, 0.0, 1.0).cpu().numpy()

    schedule = (0.002, 1 / 24, 1.0, 5.0)
    img_logger = loggers.ImageReconstructionLogger(
        render_fn=render_fn, metric_logger=metric_logger, train_image_names=["r_1"],
        validation_image_names=["r_2"], schedule=loggers.TaperSchedule(*schedule))
    ray_logger = loggers.RayDensityLogger(
        density_fn=density_profiles, metric_logger=metric_logger, image_names=["r_1"],
        near=args.near, far=args.far, schedule=loggers.TaperSchedule(*schedule))
    callbacks = [
        lambda trainer, state, step, ef: ray_logger.maybe_log(ef, step, state.params,
                                                              dm.dataset_train),
        lambda trainer, state, step, ef: img_logger.maybe_log(ef, step, state.params, dm),
    ]
    conv_blur = None
    if args.conv_blur:
        raw_images = dm.dataset_train.images[:, :, :, -1]  # the sigma-0 slot
        conv_blur = image_blur.ConvBlurTargets(
            torch.as_tensor(np.ascontiguousarray(raw_images), device=device),
            kernel_size=args.blur_kernel_size,
            relative_sigma_start=args.blur_relative_sigma_start,
            relative_sigma_decay=args.blur_relative_sigma_decay,
            epoch_fraction_period=scheduler_period(args) or 0.02,
            n_sigma_slots=dm.dataset_train.images.shape[3])
        callbacks.append(conv_blur)
    ckpt_mgr = None
    if args.checkpoint_every_n_epochs or args.resume:
        ckpt_mgr = CheckpointManager(os.path.join(args.out_dir, "ckpt"))
    trainer = Trainer(
        cfg=trainer_cfg, train_store=train_store, step_fn=step_fn,
        scalar_fn=lambda step, ef: (cfg.act_anneal_at(step),),
        metric_logger=metric_logger, val_store=val_store, val_fn=val_step,
        pose_error_fn=pose_fn, callbacks=callbacks, lr_fn=garf_system.lr_fn(cfg, params),
        checkpoint_manager=ckpt_mgr, mesh=mesh)
    if args.resume and ckpt_mgr.latest_step() is not None:
        state = ckpt_mgr.restore(state)
        shard_lib.reshard(state)
        print(f"resumed from step {ckpt_mgr.latest_step()}")
    if conv_blur is not None:
        # the trainer fires callbacks with the epoch fraction of the step just
        # taken, so after `state.step` steps an uninterrupted run's ladder is at
        # ef(step - 1); the targets start blurred there
        conv_blur.sync_to(trainer.epoch_fraction(max(0, int(state.step) - 1)))
        trainer.swap_train_colors(conv_blur.flat_colors())
    return cfg, state, trainer


def main(argv=None) -> garf_system.TrainState:
    args = parse_args(argv)
    mesh = common.mesh_from_flag(args.mesh, args.device)
    try:
        _, state, trainer = build(args, mesh=mesh)
        return trainer.fit(state)
    finally:
        if mesh is not None:
            mesh.close()


if __name__ == "__main__":
    main()
