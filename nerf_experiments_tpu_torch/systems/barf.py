"""BARF / vanilla-NeRF system: config, parameters, the render forward pass,
the objective, the train steps (plain autograd and fused), the optimizer,
the validation gauge and the pose-error metric.

Port of `nerf_experiments_tpu/systems/barf.py` for the flagship BARF
configs (dense and proposal-hierarchical), the Mip-NeRF / Mip-BARF configs
(integrated encodings, shared proposal net, density scale 21) and any other
radiance field behind the model-definition interface (`model_def`; the
fused-MLP-chain plug `FusedNerfMLPDef`, the hash-grid NeRF of
`run_3d_ingp`), which train through the plain step. The coarse stage is a
proposal net or the occupancy grid (`ops/occgrid.py`: the grid is a buffer
of the parameters, refreshed after the update every `update_every` steps);
with `train_coarse_block` > 1 the fused step runs the coarse stage on one
ray of each block of raster-consecutive rays and shares its fine bins with
the block, and `render_block_coarse` serves that way.

`forward(..., fused=True)` runs the radiance pass through the flagship render
kernel (`ops/train_megakernel.py:flagship_render`, no gradient: eval and
serving). `train_step_fused` runs it through the flagship train kernel
(`flagship_train_grads`), which returns the radiance net's gradients and the
geometry gradients that torch autograd chains into the camera parameters.
Either way the proposal stage of a hierarchical config runs its small MLP as
plain torch (under autograd when training) and composites through the
compositing kernels (`ops/render.py:render_rays_auto`).

The train steps update the state in place (parameters, Adam state, step) and
return it, with metrics as device scalars. Given a mesh (`parallel/mesh.py`,
the counterpart of the JAX steps' `axis_name`) they take this rank's shard
of the batch and average the gradients and losses over the mesh's data group
before the guard and Adam (`parallel/shard.py:sync`); without one they run
no collective.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from nerf_experiments_tpu_torch.cameras import calibration, extrinsics
from nerf_experiments_tpu_torch.data.sampler import blurred_pixel_colors
from nerf_experiments_tpu_torch.encodings.fourier import encode_position
from nerf_experiments_tpu_torch.models import nerf_mlp
from nerf_experiments_tpu_torch.models.common import ParamGroup, softplus8
from nerf_experiments_tpu_torch.ops import occgrid, render, sampling
from nerf_experiments_tpu_torch.ops.fused_mlp import fused_chain
from nerf_experiments_tpu_torch.ops.metrics import psnr
from nerf_experiments_tpu_torch.ops.train_megakernel import (
    flagship_render,
    flagship_train_grads,
    is_flagship,
    kernels_fit,
)
from nerf_experiments_tpu_torch.parallel import shard
from nerf_experiments_tpu_torch.training import optim
from nerf_experiments_tpu_torch.utils.profiling import annotate
from nerf_experiments_tpu_torch.utils.seeds import mix_seed


@dataclasses.dataclass(frozen=True)
class NerfMLPDef:
    """The NerfMLP behind the model-definition interface every radiance field
    of the system exposes: `init(generator, device)`, `apply(params, pos, dir,
    pixel_width, t_start, t_end, alpha_pos, alpha_dir, pixel_width_sigma)`,
    `param_group`, `from_numpy(tree, device)`, and the encoders' alphas
    `alphas_at(epoch_frac)` (training) and `full_alphas()` (every level on:
    validation and rendering)."""

    cfg: nerf_mlp.NerfMLPConfig

    def init(self, generator: torch.Generator, device=None) -> nerf_mlp.NerfMLP:
        return nerf_mlp.init(generator, self.cfg, device=device)

    def apply(self, params, pos, dir, pixel_width, t_start, t_end, alpha_pos, alpha_dir,
              pixel_width_sigma=0.0):
        return nerf_mlp.apply(params, self.cfg, pos, dir, pixel_width=pixel_width,
                              t_start=t_start, t_end=t_end, alpha_pos=alpha_pos,
                              alpha_dir=alpha_dir, pixel_width_sigma=pixel_width_sigma)

    @property
    def param_group(self) -> ParamGroup:
        return self.cfg.param_group

    def from_numpy(self, tree: Dict, device=None) -> nerf_mlp.NerfMLP:
        return nerf_mlp.from_numpy(tree, self.cfg, device=device)

    def alphas_at(self, epoch_frac: float) -> Tuple[float, float]:
        """Each encoder's annealed alpha; 0 for one that has none (Fourier,
        Integrated), as the JAX package's scalar schedule gives it."""
        return tuple(enc.alpha_at(epoch_frac) if hasattr(enc, "alpha_at") else 0.0
                     for enc in (self.cfg.position_encoder, self.cfg.direction_encoder))

    def full_alphas(self) -> Tuple[float, float]:
        """Every level on: each encoder's level count, 0 for one that has none
        (Identity), as `getattr(enc, "levels", 0)` in the JAX package."""
        return tuple(float(getattr(enc, "levels", 0))
                     for enc in (self.cfg.position_encoder, self.cfg.direction_encoder))


@dataclasses.dataclass(frozen=True)
class FusedNerfMLPDef(NerfMLPDef):
    """The NerfMLP with each segment and the colour head run as one fused
    chain (`ops/fused_mlp.py:fused_chain`: K9 forward, K10 backward on a
    CUDA tensor), the JAX package's radiance-field plug of the same name.
    Same parameters, init and optimizer group as NerfMLPDef; the encodings,
    concats and heads stay plain torch. With bf16 the chains keep their
    outputs in fp32 where NerfMLPDef rounds every layer's output."""

    def apply(self, params, pos, dir, pixel_width, t_start, t_end, alpha_pos, alpha_dir,
              pixel_width_sigma=0.0):
        cfg = self.cfg
        pos_enc = encode_position(cfg.position_encoder, pos, dir, pixel_width, t_start, t_end,
                                  alpha_pos, pixel_width_sigma)
        dir_enc = cfg.direction_encoder(dir, alpha=alpha_dir)

        z = pos_enc[:, :0]
        for i, segment in enumerate(params.segments):
            if not cfg.delayed_direction:
                z = torch.cat([z, dir_enc], dim=-1)
            z = fused_chain(torch.cat([z, pos_enc], dim=-1), segment.layers, cfg.compute_dtype)
            if i < cfg.n_segments - 1:
                z = torch.relu(z)

        length = z.shape[-1] - (0 if cfg.delayed_density else 1)
        if cfg.delayed_direction:
            final_input = torch.cat([z[:, :length], dir_enc], dim=-1)
        else:
            final_input = z[:, :length]
        final_output = fused_chain(final_input, params.color, cfg.compute_dtype)

        density_raw = final_output[:, -1] if cfg.delayed_density else z[:, -1]
        density = softplus8(density_raw.float())
        rgb = torch.sigmoid(final_output[:, :3].float())
        return density, rgb


def model_def(model):
    """A NerfMLPConfig wrapped as a NerfMLPDef; any other model definition
    (the hash-grid NeRF of `run_3d_ingp`) as it is (the JAX package's
    `_model_def`)."""
    if isinstance(model, nerf_mlp.NerfMLPConfig):
        return NerfMLPDef(model)
    return model


@dataclasses.dataclass(frozen=True)
class BarfConfig:
    radiance: Any  # a NerfMLPConfig or a model definition (see `model_def`)
    n_training_images: int
    near: float = 2.0
    far: float = 8.0
    samples_per_ray_radiance: int = 128
    samples_per_ray_proposal: int = 0  # 0 => no hierarchical sampling
    proposal: Optional[Any] = None  # None => radiance's architecture
    share_proposal_net: bool = False  # MipNeRF style (model_mip.py:36)
    # occupancy-grid guided sampling (ops/occgrid.py): the alternative to the
    # proposal net, exclusive with samples_per_ray_proposal > 0
    occ: Optional[occgrid.OccGridConfig] = None
    uniform_sampling_strategy: str = "stratified_uniform"
    uniform_sampling_offset_size: float = 0.0
    integration_strategy: str = "middle"
    coarse_loss_weight: float = 1.0
    density_scale: float = render.DENSITY_SCALE
    # block-coarse training (train_step_fused only): with batches of aligned
    # runs of this many raster-consecutive rays (TrainerConfig.batch_block),
    # the coarse stage runs on the first ray of each run and its fine bins
    # serve the run; the coarse loss is over those rays. 1 = off.
    train_coarse_block: int = 1

    optimize_camera: bool = True
    camera_learning_rate_start: float = 1e-3
    camera_learning_rate_stop: float = 1e-5
    camera_learning_rate_decay_end: int = 200_000
    camera_adam_eps: Optional[float] = None

    max_gaussian_sigma: float = 0.0
    gaussian_blur_sigmas: Tuple[float, ...] = (0.0, 0.0)

    adam_eps: float = 1e-5
    adam_b2: float = 0.999

    @property
    def use_proposal(self) -> bool:
        return self.samples_per_ray_proposal > 0

    @property
    def use_occ(self) -> bool:
        return self.occ is not None

    @property
    def camera_group(self) -> ParamGroup:
        return ParamGroup(
            self.camera_learning_rate_start,
            self.camera_learning_rate_stop,
            self.camera_learning_rate_decay_end,
            adam_eps=self.camera_adam_eps,
        )


class BarfParams(nn.Module):
    """The system's parameters under the JAX package's names: `radiance`,
    optional `proposal`, and `camera` (rotation, translation); and the
    occupancy grid `occ` as a buffer (state, not a learned parameter: no
    optimizer moves it, and `state_dict`, hence checkpoints and the
    trainer's rollback snapshots, carry it)."""

    def __init__(self, radiance: nn.Module, camera: extrinsics.Extrinsics,
                 proposal: Optional[nn.Module] = None, occ: Optional[torch.Tensor] = None):
        super().__init__()
        self.radiance = radiance
        self.proposal = proposal
        self.camera = camera
        self.register_buffer("occ", occ)


def _proposal_def(cfg: BarfConfig):
    return model_def(cfg.proposal if cfg.proposal is not None else cfg.radiance)


def init(generator: torch.Generator, cfg: BarfConfig, device=None) -> BarfParams:
    """Fresh parameters drawn from `generator` (radiance, then proposal), and
    the occupancy grid at its initial fill."""
    if cfg.use_occ and cfg.use_proposal:
        raise ValueError("the occupancy grid and the proposal net are mutually exclusive")
    radiance = model_def(cfg.radiance).init(generator, device=device)
    proposal = None
    if cfg.use_proposal and not cfg.share_proposal_net:
        proposal = _proposal_def(cfg).init(generator, device=device)
    camera = extrinsics.init(cfg.n_training_images, device=device)
    occ = occgrid.init_grid(cfg.occ, device=device) if cfg.use_occ else None
    return BarfParams(radiance, camera, proposal, occ)


def params_from_numpy(tree: Dict, cfg: BarfConfig, device=None) -> BarfParams:
    """The JAX package's whole-model pytree {"radiance", ["proposal"],
    ["occ"], "camera": {"rotation", "translation"}} -> BarfParams."""
    radiance = model_def(cfg.radiance).from_numpy(tree["radiance"], device=device)
    proposal = None
    if "proposal" in tree:
        proposal = _proposal_def(cfg).from_numpy(tree["proposal"], device=device)
    occ = None
    if "occ" in tree:
        occ = torch.tensor(np.asarray(tree["occ"], np.float32), device=device)
    cam = {k: torch.tensor(np.asarray(tree["camera"][k], np.float32), device=device)
           for k in ("rotation", "translation")}
    return BarfParams(radiance, extrinsics.Extrinsics(cam["rotation"], cam["translation"]),
                      proposal, occ)


def _eval_model(mdef, model: nn.Module, origs, dirs, t_start, t_end, pixel_width,
                alpha_pos, alpha_dir, integration_strategy, pixel_width_sigma=0.0):
    """Positions from t bins -> flattened eval of the model definition `mdef`
    with parameters `model` -> (density (N,S), rgb (N,S,3)). Mirrors
    `_compute_positions:288-312` + `_compute_color:356-414`."""
    n_rays, n_samples = t_start.shape
    t_q = sampling.t_query(t_start, t_end, integration_strategy)
    pos = origs[:, None, :] + t_q[..., None] * dirs[:, None, :]
    dirs_rep = dirs[:, None, :].expand(pos.shape)

    def flat(x, d):
        return x.reshape(n_rays * n_samples, d)

    density, rgb = mdef.apply(
        model, flat(pos, 3), flat(dirs_rep, 3),
        pixel_width.expand(n_rays, n_samples).reshape(-1, 1),
        flat(t_start[..., None], 1), flat(t_end[..., None], 1),
        alpha_pos, alpha_dir, pixel_width_sigma,
    )
    return density.reshape(n_rays, n_samples), rgb.reshape(n_rays, n_samples, 3)


def _proposal_model(params: BarfParams, cfg: BarfConfig):
    """(model definition, parameters) of the coarse stage."""
    if cfg.share_proposal_net or params.proposal is None:
        return model_def(cfg.radiance), params.radiance
    return _proposal_def(cfg), params.proposal


def forward(
    params: BarfParams,
    cfg: BarfConfig,
    generator: Optional[torch.Generator],
    ray_origs: torch.Tensor,
    ray_dirs: torch.Tensor,
    pixel_width: torch.Tensor,
    alpha_pos=None,
    alpha_dir=None,
    pixel_width_sigma: float = 0.0,
    stratified: bool = True,
    fused: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(rgb_fine, rgb_coarse | None) — `NerfInterpolation.forward:417-486`.
    Differentiable (the plain train step's objective runs through it); the
    fine bins of a hierarchical or occupancy-grid config are constants, as in
    the JAX package. The occupancy grid's bins are jittered whenever
    `stratified` (they need the generator then, whatever the strategy).

    fused=True (eval and serving only: no gradient) runs the radiance pass
    through `flagship_render` and needs `can_fuse_render(cfg)`."""
    n_rays = ray_origs.shape[0]
    device = ray_origs.device
    ray_origs, ray_dirs = ray_origs.contiguous(), ray_dirs.contiguous()
    strategy = cfg.uniform_sampling_strategy if stratified else "equidistant"
    offset = cfg.uniform_sampling_offset_size if stratified else 0.0
    needs_gen = (strategy == "stratified_uniform" or offset != 0.0
                 or (cfg.use_occ and stratified))
    gen = generator if needs_gen else None
    if needs_gen and gen is None:
        raise ValueError("stratified bins of this config need a generator")
    if fused and not can_fuse_render(cfg):
        raise ValueError("fused=True needs a config that can_fuse_render accepts")

    def stratified_bins(n_samples):
        return sampling.sample_stratified(
            gen, n_rays, n_samples, cfg.near, cfg.far, strategy, offset, device=device)

    rgb_coarse = None
    with annotate("render.bins"):
        if cfg.use_proposal:
            tc_start, tc_end = stratified_bins(cfg.samples_per_ray_proposal)
            dens_c, rgb_c_samples = _eval_model(
                *_proposal_model(params, cfg), ray_origs, ray_dirs, tc_start, tc_end,
                pixel_width, alpha_pos, alpha_dir, cfg.integration_strategy, pixel_width_sigma,
            )
            rgb_coarse, weights = render.render_rays_auto(
                dens_c, rgb_c_samples, tc_end - tc_start, density_scale=cfg.density_scale)
            tf_start, tf_end = sampling.sample_pdf_weighted_intervals(
                tc_start, tc_end, weights.detach(), cfg.samples_per_ray_radiance, cfg.far)
        elif cfg.use_occ:
            tf_start, tf_end = occgrid.sample_intervals(
                params.occ, cfg.occ, ray_origs, ray_dirs, cfg.near, cfg.far,
                cfg.samples_per_ray_radiance, generator=gen, strategy=strategy)
        else:
            tf_start, tf_end = stratified_bins(cfg.samples_per_ray_radiance)

    return rgb_fine_pass(params, cfg, ray_origs, ray_dirs, tf_start, tf_end, pixel_width,
                         alpha_pos, alpha_dir, pixel_width_sigma, fused), rgb_coarse


def rgb_fine_pass(params: BarfParams, cfg: BarfConfig, ray_origs, ray_dirs, t_start, t_end,
                  pixel_width, alpha_pos, alpha_dir, pixel_width_sigma: float = 0.0,
                  fused: bool = False) -> torch.Tensor:
    """The radiance pass over fine bins: rgb (N, 3), through `flagship_render`
    when `fused`, else the model definition and `render_rays_auto`."""
    with annotate("render.fine"):
        if fused:
            return flagship_render(params.radiance, cfg.radiance, ray_origs, ray_dirs, t_start,
                                   t_end, alpha_pos, alpha_dir,
                                   density_scale=cfg.density_scale)[0]
        dens_f, rgb_f_samples = _eval_model(
            model_def(cfg.radiance), params.radiance, ray_origs, ray_dirs, t_start, t_end,
            pixel_width, alpha_pos, alpha_dir, cfg.integration_strategy, pixel_width_sigma)
        return render.render_rays_auto(dens_f, rgb_f_samples, t_end - t_start,
                                       density_scale=cfg.density_scale)[0]


@dataclasses.dataclass
class TrainState:
    """Parameters, their optimizer and the number of steps taken."""

    params: BarfParams
    optimizer: optim.MultiGroupAdam
    step: int = 0


def make_groups(cfg: BarfConfig, params: BarfParams):
    """(groups, params_by_label) shared by the optimizer and the LR rows."""
    groups = {"radiance": model_def(cfg.radiance).param_group, "camera": cfg.camera_group}
    by_label = {"radiance": list(params.radiance.parameters()),
                "camera": list(params.camera.parameters())}
    if params.proposal is not None:
        groups["proposal"] = _proposal_def(cfg).param_group
        by_label["proposal"] = list(params.proposal.parameters())
    if params.occ is not None:
        # the occupancy grid is a buffer, refreshed by the train step: a
        # frozen group with no parameters keeps the JAX package's lr row
        groups["occ"] = ParamGroup(0.0, 0.0, 0)
        by_label["occ"] = []
    if not cfg.optimize_camera:
        groups["camera"] = ParamGroup(0.0, 0.0, 0)
    return groups, by_label


def make_optimizer(cfg: BarfConfig, params: BarfParams) -> optim.MultiGroupAdam:
    groups, by_label = make_groups(cfg, params)
    return optim.multi_group_adam(groups, by_label, eps=cfg.adam_eps, adam_b2=cfg.adam_b2)


def init_state(cfg: BarfConfig, params: BarfParams) -> TrainState:
    """A training state at step 0 around `params`."""
    return TrainState(params=params, optimizer=make_optimizer(cfg, params), step=0)


def lr_fn(cfg: BarfConfig, params: BarfParams):
    """(step) -> {"lr_radiance": ..., "lr_camera": ...} rows
    (LearningRateMonitor parity, `barf/run_barf.py:139-141`)."""
    groups, _ = make_groups(cfg, params)
    return optim.lr_row_fn(groups)


def loss_fn(
    params: BarfParams,
    cfg: BarfConfig,
    batch: Dict,
    generator: Optional[torch.Generator],
    alpha_pos,
    alpha_dir,
    blur_sigma: float,
    pixel_width_sigma: float = 0.0,
    train: bool = True,
    val_gauge=None,
):
    """Full training/val objective (`BarfModel._step_helper:29-92`):
    (loss, metrics)."""
    with annotate("trainer.step.camera") if train else contextlib.nullcontext():
        if train:
            origs, dirs = calibration.training_transform_rays(
                params.camera, batch["img_idx"], batch["origs_noisy"], batch["dirs_noisy"])
        else:
            origs, dirs = calibration.validation_transform_rays(
                batch["origs_raw"], batch["dirs_raw"], val_gauge)
        target = blurred_pixel_colors(batch["colors"], cfg.gaussian_blur_sigmas,
                                      blur_sigma)[:, 0]
    rgb_fine, rgb_coarse = forward(
        params, cfg, generator, origs, dirs, batch["pixel_width"], alpha_pos, alpha_dir,
        pixel_width_sigma, stratified=train)
    loss_fine = torch.mean((rgb_fine - target) ** 2)
    loss = loss_fine
    metrics = {"loss_fine": loss_fine.detach(), "psnr": psnr(loss_fine.detach())}
    if rgb_coarse is not None:
        loss_coarse = torch.mean((rgb_coarse - target) ** 2)
        loss = loss + cfg.coarse_loss_weight * loss_coarse
        metrics["loss_coarse"] = loss_coarse.detach()
    return loss, metrics


def _occ_density_fn(cfg: BarfConfig, radiance: nn.Module, alpha_pos, alpha_dir):
    """Positions (M, 3) -> densities (M,) of the radiance net at the current
    annealing alphas, for `occgrid.update_grid`: the direction zero (the
    density head takes none) and, for the integrated encoders, a cell-sized
    frustum (pixel width 0, t from 0 to the cell's size)."""
    mdef = model_def(cfg.radiance)
    cell = cfg.occ.cell

    def fn(pos):
        zeros = pos.new_zeros((pos.shape[0], 1))
        return mdef.apply(radiance, pos, torch.zeros_like(pos), zeros, zeros, zeros + cell,
                          alpha_pos, alpha_dir)[0]

    return fn


@torch.no_grad()
def _maybe_refresh_occ(cfg: BarfConfig, params: BarfParams, step: int, generator,
                       alpha_pos, alpha_dir) -> None:
    """The post-update occupancy refresh (every `cfg.occ.update_every` steps,
    step 0 included), in place into the buffer. Its jitter comes from a
    generator seeded from the step generator's seed and 0x0CC (the JAX
    package's `fold_in(key, 0x0CC)`), so it does not depend on how much of
    the step's stream was drawn."""
    if not cfg.use_occ or step % cfg.occ.update_every:
        return
    jitter = torch.Generator(device=params.occ.device).manual_seed(
        mix_seed(generator.initial_seed(), 0x0CC))
    params.occ.copy_(occgrid.update_grid(
        params.occ, cfg.occ, _occ_density_fn(cfg, params.radiance, alpha_pos, alpha_dir),
        jitter))


def _apply_update(state: TrainState, cfg: BarfConfig, metrics: Dict, generator,
                  alpha_pos, alpha_dir, mesh=None) -> Tuple[TrainState, Dict]:
    """Non-finite guard + multi-group Adam, then the occupancy refresh at the
    step before its increment, in place. With a mesh, `parallel/shard.py:
    update` averages the gradients and metrics over its data group first."""
    with annotate("trainer.step.update"):
        if mesh is not None:
            metrics = shard.update(state, metrics, mesh)
        else:
            metrics["grads_finite"] = optim.guard_nonfinite(state.optimizer.params())
            state.optimizer.step()
        _maybe_refresh_occ(cfg, state.params, state.step, generator, alpha_pos, alpha_dir)
    state.step += 1
    return state, metrics


def train_step(
    state: TrainState,
    cfg: BarfConfig,
    batch: Dict,
    generator: Optional[torch.Generator],
    alpha_pos,
    alpha_dir,
    blur_sigma: float,
    pixel_width_sigma: float = 0.0,
    mesh=None,
) -> Tuple[TrainState, Dict]:
    """One optimization step: torch autograd of `loss_fn`, the non-finite
    guard and the multi-group Adam update (and the occupancy refresh). With
    a mesh, `parallel/shard.py:pjit_train_step` hands it the rank's batch
    shard and a `sampling.RowShard` of the step generator."""
    state.optimizer.zero_grad()
    loss, metrics = loss_fn(state.params, cfg, batch, generator, alpha_pos, alpha_dir,
                            blur_sigma, pixel_width_sigma)
    with annotate("trainer.step.backward"):
        loss.backward()
    metrics["loss"] = loss.detach()
    return _apply_update(state, cfg, metrics, generator, alpha_pos, alpha_dir, mesh)


def train_step_fused(
    state: TrainState,
    cfg: BarfConfig,
    batch: Dict,
    generator: Optional[torch.Generator],
    alpha_pos,
    alpha_dir,
    blur_sigma: float,
    mesh=None,
) -> Tuple[TrainState, Dict]:
    """One optimization step with the radiance pass through the flagship
    train kernel (`flagship_train_grads`: forward, compositing, MSE gradient
    and backward in one call), bypassing autograd for the radiance net.
    The camera gradients chain through torch autograd of the ray transform
    from the kernel's d_origs / d_dirs. Equal to `train_step` up to rounding
    (the fine bins are constants in both): radiance <- fine MSE, proposal <-
    coarse MSE, camera <- both; with `share_proposal_net` the coarse
    gradients add into the radiance net's.

    With `train_coarse_block` = b > 1 the coarse stage (proposal net or
    occupancy grid) sees every b-th ray (the batch comes as aligned runs of
    b rays, `TrainerConfig.batch_block`), its loss is over those rays, and
    its fine bins serve each run. Autograd through the slice scatters the
    coarse stage's ray gradients back into full-size ones, as the JAX
    package's VJP does.

    With a mesh (`parallel/shard.py:shard_map_train_step_fused`) the batch is
    this rank's shard and the kernel runs on it; the bins are drawn from the
    step seed folded with the data rank (`mix_seed(seed, data_rank)`, JAX's
    `fold_in(key, axis_index)`; with one data rank the step generator itself,
    so that a one-rank mesh is the step without one), the occupancy refresh
    from the unfolded seed, and the gradients and losses are averaged over
    the data group before the guard and Adam."""
    if not can_fuse_train_step(cfg):
        raise ValueError("train_step_fused needs a config that can_fuse_train_step accepts")
    params = state.params
    state.optimizer.zero_grad()
    with annotate("trainer.step.camera"):
        origs, dirs = calibration.training_transform_rays(
            params.camera, batch["img_idx"], batch["origs_noisy"], batch["dirs_noisy"])
        target = blurred_pixel_colors(
            batch["colors"], cfg.gaussian_blur_sigmas, blur_sigma)[:, 0].contiguous()
    n_rays = origs.shape[0]
    strategy = cfg.uniform_sampling_strategy
    offset = cfg.uniform_sampling_offset_size
    needs_gen = strategy == "stratified_uniform" or offset != 0.0 or cfg.use_occ
    gen = generator if needs_gen else None
    if needs_gen and gen is None:
        raise ValueError("stratified bins of this config need a generator")
    if gen is not None and mesh is not None and mesh.data_size > 1:
        gen = torch.Generator(device=origs.device).manual_seed(
            mix_seed(generator.initial_seed(), mesh.data_rank))
    blk = max(1, cfg.train_coarse_block)
    if n_rays % blk:
        raise ValueError(f"train_coarse_block {blk} must divide the batch ({n_rays} rays)")
    n_rep = n_rays // blk

    def rep(x):  # the first ray of each run
        return x[::blk]

    roots, root_grads, metrics = [], [], {}
    loss_coarse = None
    with annotate("trainer.step.bins"):
        if cfg.use_proposal:
            tc_start, tc_end = sampling.sample_stratified(
                gen, n_rep, cfg.samples_per_ray_proposal, cfg.near, cfg.far, strategy, offset,
                device=origs.device)
            dens_c, rgb_c_samples = _eval_model(
                *_proposal_model(params, cfg), rep(origs), rep(dirs), tc_start, tc_end,
                rep(batch["pixel_width"]), alpha_pos, alpha_dir, cfg.integration_strategy)
            rgb_coarse, weights = render.render_rays_auto(
                dens_c, rgb_c_samples, tc_end - tc_start, density_scale=cfg.density_scale)
            loss_coarse = torch.mean((rgb_coarse - rep(target)) ** 2)
            roots.append(cfg.coarse_loss_weight * loss_coarse)
            root_grads.append(torch.ones_like(loss_coarse))
            t_start, t_end = sampling.sample_pdf_weighted_intervals(
                tc_start, tc_end, weights.detach(), cfg.samples_per_ray_radiance, cfg.far)
        elif cfg.use_occ:
            t_start, t_end = occgrid.sample_intervals(
                params.occ, cfg.occ, rep(origs), rep(dirs), cfg.near, cfg.far,
                cfg.samples_per_ray_radiance, generator=gen, strategy=strategy)
        else:
            t_start, t_end = sampling.sample_stratified(
                gen, n_rays, cfg.samples_per_ray_radiance, cfg.near, cfg.far, strategy, offset,
                device=origs.device)
        t_start = sampling.broadcast_bins(t_start, blk).contiguous()
        t_end = sampling.broadcast_bins(t_end, blk).contiguous()

    with annotate("trainer.step.k4"):
        rgb_fine, grads_rad, d_origs, d_dirs = flagship_train_grads(
            params.radiance, cfg.radiance, origs.detach().contiguous(),
            dirs.detach().contiguous(), t_start, t_end, target,
            alpha_pos, alpha_dir, density_scale=cfg.density_scale)
        for name, p in params.radiance.named_parameters():
            p.grad = grads_rad[name]
    # camera <- fine (the kernel's geometry gradients) + coarse; proposal (or
    # the shared radiance net, adding into its kernel gradients) <- coarse
    with annotate("trainer.step.backward"):
        torch.autograd.backward(roots + [origs, dirs], root_grads + [d_origs, d_dirs])

    loss_fine = torch.mean((rgb_fine - target) ** 2)
    loss = loss_fine
    if loss_coarse is not None:
        loss = loss + cfg.coarse_loss_weight * loss_coarse.detach()
        metrics["loss_coarse"] = loss_coarse.detach()
    metrics.update(loss_fine=loss_fine, psnr=psnr(loss_fine), loss=loss)
    return _apply_update(state, cfg, metrics, generator, alpha_pos, alpha_dir, mesh)


def make_train_step(cfg: BarfConfig, fused: bool = False, mesh=None):
    """(state, batch, generator, alpha_pos, alpha_dir, blur_sigma
    [, pixel_width_sigma]) -> (state, metrics): the plain step, or with
    fused=True the flagship train kernel's. With a mesh, the data-parallel
    step on this rank's batch shard: `shard_map_train_step_fused`, or the
    plain step under `pjit_train_step`."""
    if fused:
        if not can_fuse_train_step(cfg):
            raise ValueError("fused=True needs a config that can_fuse_train_step accepts")
        if mesh is not None:
            return shard.shard_map_train_step_fused(cfg, mesh)
        return lambda state, batch, gen, a_pos, a_dir, sigma: train_step_fused(
            state, cfg, batch, gen, a_pos, a_dir, sigma)
    if mesh is not None:
        return shard.pjit_train_step(
            lambda state, batch, gen, a_pos, a_dir, sigma, pw_sigma=0.0, *, mesh: train_step(
                state, cfg, batch, gen, a_pos, a_dir, sigma, pw_sigma, mesh=mesh), mesh)
    return lambda state, batch, gen, a_pos, a_dir, sigma, pw_sigma=0.0: train_step(
        state, cfg, batch, gen, a_pos, a_dir, sigma, pw_sigma)


def _flagship_mlp(model) -> Optional[nerf_mlp.NerfMLPConfig]:
    """The NerfMLPConfig when `model` is the flagship architecture the render
    kernel covers, else None."""
    if isinstance(model, nerf_mlp.NerfMLPConfig) and is_flagship(model):
        return model
    return None


def can_fuse_render(cfg: BarfConfig) -> bool:
    """True when the flagship render kernel covers this config's radiance
    pass: the flagship architecture, middle-point integration, the kernel's
    density scale, and layers narrow enough for its row tile
    (`train_megakernel.kernels_fit`)."""
    mlp = _flagship_mlp(cfg.radiance)
    return (mlp is not None
            and cfg.integration_strategy == "middle"
            and cfg.density_scale == render.DENSITY_SCALE
            and kernels_fit(mlp))


def can_fuse_train_step(cfg: BarfConfig) -> bool:
    """True when the flagship kernels cover this config's radiance pass, the
    train kernel's block included."""
    return can_fuse_render(cfg) and kernels_fit(cfg.radiance, train=True)


def use_fused_render(cfg: BarfConfig, device) -> bool:
    """Eval rendering goes through the render kernel when the config allows
    it and the tensors live on a CUDA device."""
    return can_fuse_render(cfg) and torch.device(device).type == "cuda"


@torch.no_grad()
def render_block_coarse(
    params: BarfParams,
    cfg: BarfConfig,
    ray_origs: torch.Tensor,
    ray_dirs: torch.Tensor,
    alpha_pos=None,
    alpha_dir=None,
    block: int = 4,
    pixel_width: float = 1e-3,
) -> torch.Tensor:
    """Serving render (no gradient) with the coarse stage on every
    `block`-th ray: rays in raster order, each run of `block` rays shares
    the fine bins of its first ray's coarse stage (proposal net or occupancy
    grid, deterministic), and the radiance pass still evaluates every ray
    (through the render kernel when `use_fused_render`). block=1 gives the
    bits of `forward(..., stratified=False)` with the same pixel width."""
    n_rays = ray_origs.shape[0]
    if n_rays % block:
        raise ValueError(f"block {block} must divide the rays ({n_rays})")
    ray_origs, ray_dirs = ray_origs.contiguous(), ray_dirs.contiguous()
    rep_origs, rep_dirs = ray_origs[::block], ray_dirs[::block]
    n_rep = rep_origs.shape[0]
    pw = torch.full((n_rep, 1), pixel_width, device=ray_origs.device)
    with annotate("render.bins"):
        if cfg.use_occ:
            t_start, t_end = occgrid.sample_intervals(
                params.occ, cfg.occ, rep_origs, rep_dirs, cfg.near, cfg.far,
                cfg.samples_per_ray_radiance)
        elif cfg.use_proposal:
            tc_start, tc_end = sampling.sample_stratified(
                None, n_rep, cfg.samples_per_ray_proposal, cfg.near, cfg.far, "equidistant",
                device=ray_origs.device)
            dens_c, rgb_c = _eval_model(*_proposal_model(params, cfg), rep_origs, rep_dirs,
                                        tc_start, tc_end, pw, alpha_pos, alpha_dir,
                                        cfg.integration_strategy)
            _, weights = render.render_rays_auto(dens_c, rgb_c, tc_end - tc_start,
                                                 density_scale=cfg.density_scale)
            t_start, t_end = sampling.sample_pdf_weighted_intervals(
                tc_start, tc_end, weights, cfg.samples_per_ray_radiance, cfg.far)
        else:
            raise ValueError("render_block_coarse needs a coarse stage (proposal or occupancy)")
        t_start = sampling.broadcast_bins(t_start, block)
        t_end = sampling.broadcast_bins(t_end, block)
    return rgb_fine_pass(params, cfg, ray_origs, ray_dirs, t_start, t_end,
                         torch.full((n_rays, 1), pixel_width, device=ray_origs.device),
                         alpha_pos, alpha_dir, fused=use_fused_render(cfg, ray_origs.device))


def pose_error_metric(params: BarfParams, camera_origins_raw, camera_origins_noisy):
    return calibration.compute_pose_error(
        params.camera, camera_origins_raw, camera_origins_noisy)


def val_gauge(params: BarfParams, camera_origins_raw, camera_origins_noisy):
    """Kabsch raw->pred similarity used by validation_transform."""
    return calibration.post_transform_params(
        params.camera, camera_origins_raw, camera_origins_noisy, from_raw_to_pred=True)
