"""GARF / GaborF / SARF training system (proposal-estimator renderer).

Port of `nerf_experiments_tpu/systems/garf_system.py`:
  * `barf/model_garf.py:20-402` GarfModel: nerfacc PropNetEstimator sampling
    (lindisp, stratified while training, `ops/proposal.py`) + rendering, the
    interlevel proposal loss on detached weights;
  * `garf/model_camera_calibration.py:384-479`: one Adam per sub-network with
    its own exponential LR, here one multi-group optimizer with five groups
    (proposal / radiance x linear / activation, camera).

`forward(..., fused=True)` renders the radiance pass through the GARF render
kernel (`ops/garf_megakernel.py:garf_radiance_render`, no gradient: eval).
`train_step_fused` runs the radiance half of the step through the GARF train
kernel (`garf_radiance_train_grads`), which returns the radiance net's
gradients, the compositing weights and the geometry gradients. The proposal
stage (about 3 % of the FLOPs) stays plain torch under autograd.

The train steps update the state in place (parameters, optimizer state,
step) and return it, with metrics as device scalars. The plain step takes a
mesh (`parallel/mesh.py`): with one, the batch is this rank's shard and the
gradients and losses are averaged over the data group before the guard and
the update; the JAX package runs GARF under a mesh through this plain step
only, as the port does (`experiments/garf_main.py`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from nerf_experiments_tpu_torch.cameras import calibration, extrinsics
from nerf_experiments_tpu_torch.models import garf
from nerf_experiments_tpu_torch.models.common import ParamGroup
from nerf_experiments_tpu_torch.ops import proposal, render, sampling
from nerf_experiments_tpu_torch.ops.garf_megakernel import (
    garf_radiance_render,
    garf_radiance_train_grads,
)
from nerf_experiments_tpu_torch.ops.metrics import psnr
from nerf_experiments_tpu_torch.parallel import shard
from nerf_experiments_tpu_torch.training import optim


@dataclasses.dataclass(frozen=True)
class GarfSystemConfig:
    n_train_images: int = 100
    near: float = 2.0
    far: float = 7.0
    proposal_samples_per_ray: int = 64
    radiance_samples_per_ray: int = 192

    net: garf.GarfConfig = garf.GarfConfig()
    proposal_net: Optional[garf.GarfConfig] = None  # defaults to `net`

    camera_learning_rate_start: float = 1e-4
    camera_learning_rate_stop: float = 1e-5
    camera_learning_rate_decay_end: int = 10_000
    # Adam eps of the camera group only (None: the optimizer default); a large
    # eps makes small camera updates gradient-proportional
    camera_adam_eps: Optional[float] = None
    # the camera group's LR is 0 for steps in [start, end); (0, 0) disables
    camera_freeze_start_step: int = 0
    camera_freeze_end_step: int = 0
    # gaborf steps its schedulers at epoch-fraction milestones; 1 = per step
    scheduler_steps_per_period: int = 1
    # activation annealing (gabor / sarf): the oscillation term is scaled by
    # gamma(step), 0 -> 1 linearly over [start, end); (0, 0): gamma = 1
    act_anneal_start_step: int = 0
    act_anneal_end_step: int = 0
    # True: the interlevel loss reaches the camera extrinsics (reference
    # semantics); False detaches the rays in the proposal branch only
    interlevel_camera_grads: bool = True
    # block-coarse training (train_step_fused only): the proposal stage runs
    # on the first ray of each aligned run of this many raster-consecutive
    # rays (TrainerConfig.batch_block) and its t bins serve the run. 1 = off.
    train_coarse_block: int = 1

    def act_anneal_at(self, step: int) -> float:
        """gamma(step): linear 0 -> 1 over [start, end); 1.0 when disabled. A
        Python float, so the per-step scalar costs no host sync."""
        if self.act_anneal_end_step <= self.act_anneal_start_step:
            return 1.0
        span = self.act_anneal_end_step - self.act_anneal_start_step
        # float32 arithmetic, as the JAX package's schedule computes it
        frac = np.float32(np.float32(step) - self.act_anneal_start_step) / np.float32(span)
        return float(np.clip(frac, 0.0, 1.0))

    @property
    def prop_cfg(self) -> garf.GarfConfig:
        return self.proposal_net if self.proposal_net is not None else self.net

    @property
    def camera_group(self) -> ParamGroup:
        return ParamGroup(
            self.camera_learning_rate_start,
            self.camera_learning_rate_stop,
            self.camera_learning_rate_decay_end,
            adam_eps=self.camera_adam_eps,
            freeze_start_step=self.camera_freeze_start_step,
            freeze_end_step=self.camera_freeze_end_step,
        )


class GarfParams(nn.Module):
    """The system's parameters under the JAX package's names: `proposal`,
    `radiance` and `camera` (rotation, translation)."""

    def __init__(self, proposal_net: garf.Proposal, radiance: garf.Radiance,
                 camera: extrinsics.Extrinsics):
        super().__init__()
        self.proposal = proposal_net
        self.radiance = radiance
        self.camera = camera


@dataclasses.dataclass
class TrainState:
    """Parameters, their optimizer and the number of steps taken."""

    params: GarfParams
    optimizer: optim.MultiGroupAdam
    step: int = 0


def init(generator: torch.Generator, cfg: GarfSystemConfig, device=None) -> GarfParams:
    """Fresh parameters drawn from `generator` (proposal, then radiance)."""
    prop = garf.proposal_init(generator, cfg.prop_cfg, device=device)
    rad = garf.radiance_init(generator, cfg.net, device=device)
    return GarfParams(prop, rad, extrinsics.init(cfg.n_train_images, device=device))


def params_from_numpy(tree: Dict, cfg: GarfSystemConfig, device=None) -> GarfParams:
    """The JAX package's pytree {"proposal", "radiance", "camera"} -> GarfParams."""
    cam = {k: torch.tensor(np.asarray(tree["camera"][k], np.float32), device=device)
           for k in ("rotation", "translation")}
    return GarfParams(garf.from_numpy(tree["proposal"], cfg.prop_cfg, device),
                      garf.from_numpy(tree["radiance"], cfg.net, device),
                      extrinsics.Extrinsics(cam["rotation"], cam["translation"]))


def init_state(cfg: GarfSystemConfig, params: GarfParams) -> TrainState:
    """A training state at step 0 around `params`."""
    return TrainState(params=params, optimizer=make_optimizer(cfg, params), step=0)


def make_groups(cfg: GarfSystemConfig, params: GarfParams):
    """(groups, params_by_label, schedule_kind) shared by the optimizer and the
    LR rows: garf's five groups."""
    groups = {
        "proposal_lin": cfg.prop_cfg.linear_group,
        "proposal_act": cfg.prop_cfg.activation_group,
        "radiance_lin": cfg.net.linear_group,
        "radiance_act": cfg.net.activation_group,
        "camera": cfg.camera_group,
    }
    by_label = {label: [] for label in groups}
    for sub in ("proposal", "radiance"):
        module = getattr(params, sub)
        labels = garf.param_labels(module, f"{sub}_lin", f"{sub}_act")
        for name, p in module.named_parameters():
            by_label[labels[name]].append(p)
    by_label["camera"] = list(params.camera.parameters())
    kind = ("quantized_exponential" if cfg.scheduler_steps_per_period > 1
            else "garf_exponential")
    return groups, by_label, kind


def make_optimizer(cfg: GarfSystemConfig, params: GarfParams) -> optim.MultiGroupAdam:
    groups, by_label, kind = make_groups(cfg, params)
    return optim.multi_group_adam(groups, by_label, schedule_kind=kind,
                                  scheduler_steps_per_period=cfg.scheduler_steps_per_period)


def lr_fn(cfg: GarfSystemConfig, params: GarfParams):
    """(step) -> {"lr_<group>": float} rows (per-subnet ExponentialLR monitor
    parity, `garf/model_garf.py:365-428`)."""
    groups, _, kind = make_groups(cfg, params)
    return optim.lr_row_fn(groups, kind, cfg.scheduler_steps_per_period)


def _sample_bins(params: GarfParams, cfg: GarfSystemConfig, generator, origs, dirs,
                 stratified: bool, act_anneal):
    """The proposal stage: (t_starts, t_ends) detached, and the histograms
    (ProposalAux) under autograd through the proposal net and the rays."""

    def prop_sigma_fn(ts, te):
        tm = (ts + te)[..., None] / 2.0
        pos = (origs[:, None] + dirs[:, None] * tm).reshape(-1, 3)
        return garf.proposal_apply(params.proposal, cfg.prop_cfg, pos,
                                   act_anneal).reshape(ts.shape)

    return proposal.sampling(
        prop_sigma_fns=[prop_sigma_fn], prop_samples=[cfg.proposal_samples_per_ray],
        num_samples=cfg.radiance_samples_per_ray, n_rays=origs.shape[0],
        near_plane=cfg.near, far_plane=cfg.far, sampling_type="lindisp",
        stratified=stratified, generator=generator, device=origs.device)


def _interlevel_rays(cfg: GarfSystemConfig, origs, dirs):
    if cfg.interlevel_camera_grads:
        return origs, dirs
    return origs.detach(), dirs.detach()


def forward(
    params: GarfParams,
    cfg: GarfSystemConfig,
    generator: Optional[torch.Generator],
    ray_origs: torch.Tensor,
    ray_dirs: torch.Tensor,
    stratified: bool,
    act_anneal=1.0,
    fused: bool = False,
):
    """GarfModel.forward parity (`model_garf.py:206-249`): (rgb, opacity,
    depth, extras) with extras["proposal_aux"] (the proposal histograms) and,
    unfused, the final weights for the interlevel loss. Differentiable
    unfused; fused=True (eval only, no gradient) renders the radiance pass
    through `garf_radiance_render`."""
    t_starts, t_ends, aux = _sample_bins(params, cfg, generator,
                                         *_interlevel_rays(cfg, ray_origs, ray_dirs),
                                         stratified, act_anneal)
    if fused:
        rgb, opacity, depth = garf_radiance_render(
            params.radiance, cfg.net, ray_origs.contiguous(), ray_dirs.contiguous(),
            t_starts, t_ends, act_anneal)
        return rgb, opacity, depth, {"proposal_aux": aux}

    n, s = t_starts.shape
    tm = (t_starts + t_ends)[..., None] / 2.0
    pos = (ray_origs[:, None] + ray_dirs[:, None] * tm).reshape(-1, 3)
    dirs_rep = ray_dirs[:, None, :].expand(n, s, 3).reshape(-1, 3)
    rgb_s, density_s = garf.radiance_apply(params.radiance, cfg.net, pos, dirs_rep, act_anneal)
    rgb, opacity, depth, extras = render.render_full_auto(
        density_s.reshape(n, s), rgb_s.reshape(n, s, 3), t_starts, t_ends)
    extras["proposal_aux"] = aux
    return rgb, opacity, depth, extras


def use_fused_render(cfg: GarfSystemConfig, device) -> bool:
    """Eval rendering goes through the GARF render kernel when the tensors
    live on a CUDA device (the kernel covers every family and dtype)."""
    return torch.device(device).type == "cuda"


def loss_fn(
    params: GarfParams,
    cfg: GarfSystemConfig,
    batch: Dict,
    generator: Optional[torch.Generator],
    train: bool = True,
    val_gauge=None,
    act_anneal=1.0,
):
    """`_forward_loss` (`model_garf.py:254-295`): the interlevel proposal loss
    on detached weights + MSE on the sharp target: (loss, metrics)."""
    if train:
        origs, dirs = calibration.training_transform_rays(
            params.camera, batch["img_idx"], batch["origs_noisy"], batch["dirs_noisy"])
    else:
        origs, dirs = calibration.validation_transform_rays(
            batch["origs_raw"], batch["dirs_raw"], val_gauge)
    rgb, _, _, extras = forward(params, cfg, generator, origs, dirs, stratified=train,
                                act_anneal=act_anneal)
    proposal_loss = proposal.compute_loss(extras["proposal_aux"], extras["weights"])
    radiance_loss = torch.mean((rgb - batch["colors"][:, -1]) ** 2)
    loss = radiance_loss + proposal_loss
    metrics = {"proposal_loss": proposal_loss.detach(),
               "radiance_loss": radiance_loss.detach(),
               "psnr": psnr(radiance_loss.detach())}
    return loss, metrics


def _apply_update(state: TrainState, metrics: Dict, mesh=None) -> Tuple[TrainState, Dict]:
    """Non-finite guard + multi-group Adam, in place; with a mesh, through
    `parallel/shard.py:update`, which first averages the gradients and
    metrics over its data group."""
    if mesh is not None:
        metrics = shard.update(state, metrics, mesh)
    else:
        metrics["grads_finite"] = optim.guard_nonfinite(state.optimizer.params())
        state.optimizer.step()
    state.step += 1
    return state, metrics


def train_step(state: TrainState, cfg: GarfSystemConfig, batch: Dict,
               generator: Optional[torch.Generator], act_anneal=1.0, mesh=None
               ) -> Tuple[TrainState, Dict]:
    """One optimization step: torch autograd of `loss_fn`, the non-finite
    guard and the multi-group Adam update. With a mesh,
    `parallel/shard.py:pjit_train_step` hands it the rank's batch shard and a
    `sampling.RowShard` of the step generator."""
    state.optimizer.zero_grad()
    loss, metrics = loss_fn(state.params, cfg, batch, generator, True, None, act_anneal)
    loss.backward()
    metrics["loss"] = loss.detach()
    return _apply_update(state, metrics, mesh)


def train_step_fused(state: TrainState, cfg: GarfSystemConfig, batch: Dict,
                     generator: Optional[torch.Generator], act_anneal=1.0
                     ) -> Tuple[TrainState, Dict]:
    """One optimization step with the radiance half through the GARF train
    kernel (forward, compositing, MSE gradient and backward in one call).

    Equal to `train_step` up to rounding because GARF's loss factors: the
    radiance net gets only the photometric gradient (the interlevel loss
    detaches the final weights, the t bins are constants), the proposal net
    only the interlevel one, and the camera the sum of both paths. The
    proposal stage runs once under autograd (the JAX package's `sample_vjp`):
    its t edges feed the kernel detached, its histograms carry the interlevel
    gradient, and one `torch.autograd.backward` over [interlevel loss, origs,
    dirs] with [1, d_origs, d_dirs] sums the camera gradient.

    With `train_coarse_block` = b > 1 the proposal stage sees every b-th ray
    (the batch comes as aligned runs of b rays), its bins serve each run, and
    the interlevel loss matches its histograms to the run's mean fine
    weights (with b duplicate rays this is the unblocked loss); autograd
    through the slice scatters the stage's ray gradients back."""
    params = state.params
    state.optimizer.zero_grad()
    origs, dirs = calibration.training_transform_rays(
        params.camera, batch["img_idx"], batch["origs_noisy"], batch["dirs_noisy"])
    blk = max(1, cfg.train_coarse_block)
    n_rays = origs.shape[0]
    if n_rays % blk:
        raise ValueError(f"train_coarse_block {blk} must divide the batch ({n_rays} rays)")
    o_il, d_il = _interlevel_rays(cfg, origs, dirs)
    t_starts, t_ends, aux = _sample_bins(params, cfg, generator, o_il[::blk], d_il[::blk], True,
                                         act_anneal)
    t_starts = sampling.broadcast_bins(t_starts, blk)
    t_ends = sampling.broadcast_bins(t_ends, blk)
    targets = batch["colors"][:, -1].contiguous()
    rgb, weights, grads_rad, d_origs, d_dirs = garf_radiance_train_grads(
        params.radiance, cfg.net, origs.detach().contiguous(), dirs.detach().contiguous(),
        t_starts, t_ends, targets, act_anneal)
    for name, p in params.radiance.named_parameters():
        p.grad = grads_rad[name]
    if blk > 1:
        weights = weights.reshape(n_rays // blk, blk, -1).mean(dim=1)
    proposal_loss = proposal.compute_loss(aux, weights)
    torch.autograd.backward([proposal_loss, origs, dirs],
                            [torch.ones_like(proposal_loss), d_origs, d_dirs])
    radiance_loss = torch.mean((rgb - targets) ** 2)
    proposal_loss = proposal_loss.detach()
    metrics = {"proposal_loss": proposal_loss, "radiance_loss": radiance_loss,
               "psnr": psnr(radiance_loss), "loss": radiance_loss + proposal_loss}
    return _apply_update(state, metrics)


def make_train_step(cfg: GarfSystemConfig, mesh=None):
    """(state, batch, generator[, act_anneal]) -> (state, metrics); with a
    mesh, the data-parallel step on this rank's batch shard."""
    if mesh is not None:
        return shard.pjit_train_step(
            lambda state, batch, gen, act_anneal=1.0, *, mesh: train_step(
                state, cfg, batch, gen, act_anneal, mesh), mesh)
    return lambda state, batch, gen, act_anneal=1.0: train_step(state, cfg, batch, gen,
                                                                act_anneal)


def make_train_step_fused(cfg: GarfSystemConfig):
    return lambda state, batch, gen, act_anneal=1.0: train_step_fused(state, cfg, batch, gen,
                                                                      act_anneal)


def pose_error_metric(params: GarfParams, camera_origins_raw, camera_origins_noisy):
    return calibration.compute_pose_error(params.camera, camera_origins_raw,
                                          camera_origins_noisy)


def val_gauge(params: GarfParams, camera_origins_raw, camera_origins_noisy):
    """Kabsch raw->pred similarity used by validation_transform."""
    return calibration.post_transform_params(params.camera, camera_origins_raw,
                                             camera_origins_noisy)
