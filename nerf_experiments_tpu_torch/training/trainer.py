"""Training harness: the Lightning-loop replacement.

Port of the JAX package's `training/trainer.py`. Drives train steps over a
device-resident ray store with explicit hooks for everything the reference's
callbacks did: epoch-fraction logging, tapered image/point logging, LR rows
from the closed-form schedules, periodic validation through the Kabsch
gauge, checkpoints every N epochs, a rate-limited pose error
(`barf/model_garf.py:347-349` logs it every 100 train batches), the
non-finite post-mortem and the divergence rollback.

Epoch semantics match the reference: one "epoch" = one pass worth of rays
(n_images * H * W / batch_size steps), but batches are sampled i.i.d. from
the full ray set rather than a shuffled partition.

Randomness: the JAX keys `fold_in(base, step)` become a `torch.Generator`
on the store's device seeded from (seed, step) before every step. It draws
the batch indices, then the step's own randomness (stratified bins). The
stream of a step is a pure function of the seed and the step index, so a run
resumed from a checkpoint reproduces the uninterrupted one bit for bit.

The state is any object with `.step` (int) and `.params` that a step
function takes and returns; steps may update it in place. Rollback
snapshots are deep copies.

On a mesh (`parallel/mesh.py`) every rank runs this loop in step: each draws
the global batch's indices from the same step generator and gathers its
shard of them (`shard_batch`); the step (a data-parallel one) reduces the
gradients and losses, so every rank takes the same rollback and post-mortem
decisions without a collective of its own. Validation and the pose error
run on every rank (the parameters are replicated); metric rows, image and
point logs (through the metric logger, active on rank 0 only), the
post-mortem dump and checkpoint writes (full parameters and Adam moments,
with a model axis gathered first) happen on global rank 0 only.
"""
from __future__ import annotations

import copy
import dataclasses
import inspect
import os
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from nerf_experiments_tpu_torch.data import sampler as sampler_lib
from nerf_experiments_tpu_torch.parallel import shard as shard_lib
from nerf_experiments_tpu_torch.parallel.mesh import is_lead, shard_batch
from nerf_experiments_tpu_torch.training.loggers import MetricLogger
from nerf_experiments_tpu_torch.utils.profiling import annotate
from nerf_experiments_tpu_torch.utils.seeds import mix_seed

_VAL_STREAM = 1  # validation's seed stream, apart from the train steps'


@dataclasses.dataclass
class TrainerConfig:
    max_epochs: int = 100
    batch_size: int = 1024
    log_every_n_steps: int = 50
    val_every_n_epochs: float = 1.0
    val_batches: int = 8
    pose_error_every_n_steps: int = 100
    checkpoint_every_n_epochs: Optional[float] = None
    seed: int = 0
    max_steps: Optional[int] = None  # overrides epochs when set
    # Divergence rollback (self-healing, SURVEY §5.3): NeRF training can fall
    # off a finite loss cliff into a gradient-dead basin (density blow-up ->
    # transmittance underflow -> grads ~1e-11 while Adam momentum coasts; no
    # NaN, so guard_nonfinite never trips). The guard keeps an in-memory
    # snapshot and, when the loss stays above rollback_spike_factor x its
    # pre-spike EMA for rollback_patience consecutive steps, restores the
    # snapshot and perturbs the batch seed stream so the replay takes a
    # different trajectory (the reference's self-repairing PDF sampler,
    # `barf/model_interpolation.py:233-276`, at the training level).
    rollback_enabled: bool = True
    rollback_spike_factor: float = 20.0
    rollback_patience: int = 10
    rollback_snapshot_every_n_steps: int = 1000
    rollback_max: int = 8
    rollback_warmup_steps: int = 500  # no trigger before the EMA settles
    # Block-coarse training batches: aligned runs of `batch_block`
    # raster-consecutive rays instead of independent rays, so that the
    # system's step can share its coarse stage across each run (the training
    # analog of systems.barf.render_block_coarse). 1 = independent rays.
    batch_block: int = 1


class Trainer:
    """Generic loop: the system supplies the step, validation and pose-error
    functions."""

    def __init__(
        self,
        cfg: TrainerConfig,
        train_store: sampler_lib.RayStore,
        step_fn: Callable,  # (state, batch, generator, *scalars) -> (state, metrics)
        scalar_fn: Callable,  # (step, epoch_frac) -> tuple of scalar args
        metric_logger: MetricLogger,
        val_store: Optional[sampler_lib.RayStore] = None,
        val_fn: Optional[Callable] = None,  # (params, batch[, *scalars]) -> metrics
        pose_error_fn: Optional[Callable] = None,  # (params) -> scalar
        checkpoint_manager=None,
        callbacks: Optional[List[Callable]] = None,  # f(trainer, state, step, epoch_frac)
        lr_fn: Optional[Callable] = None,  # (step) -> {"lr_<group>": float}
        mesh=None,  # parallel.mesh.Mesh: step_fn is data-parallel over it
    ):
        self.cfg = cfg
        self.train_store = train_store
        self.val_store = val_store
        self.step_fn = step_fn
        self.scalar_fn = scalar_fn
        self.val_fn = val_fn
        self.pose_error_fn = pose_error_fn
        self.metric_logger = metric_logger
        self.checkpoint_manager = checkpoint_manager
        self.callbacks = callbacks or []
        self.lr_fn = lr_fn
        # non-finite post-mortem (the reference dumps offending tensors on
        # sampler failure, `barf/model_interpolation.py:233-276`): on the
        # FIRST step whose gradients were non-finite, the exact batch is
        # regenerated from its seed and dumped with the schedule scalars.
        self._postmortem_done = False
        self._pending_finite: List = []  # (step, scalars, grads_finite)
        # divergence rollback state: losses are buffered as device scalars
        # and fetched once per log interval (a per-step float() would add a
        # host sync per step)
        self._pending_losses: List = []
        self._ref_loss: Optional[float] = None  # EMA of non-spiking losses
        self._spike_run = 0  # consecutive spiking steps at the buffer tail
        self._rollbacks = 0
        self._snapshot = None  # (step, state copy)
        self._last_pose_step = -(10 ** 12)  # first log step always records
        self.steps_per_epoch = max(1, train_store.n_rays // cfg.batch_size)
        block = max(1, cfg.batch_block)
        # an aligned run never crosses an image (each image is a contiguous
        # run of hw rays in the store), so its rays share one camera
        if block > 1 and (cfg.batch_size % block or train_store.n_rays % block
                          or train_store.hw % block):
            raise ValueError(
                f"batch_block {block} must divide the batch ({cfg.batch_size}), the rays "
                f"({train_store.n_rays}) and the rays of an image ({train_store.hw})")
        self._block = block
        self.mesh = mesh
        self._lead = is_lead(mesh)
        if mesh is not None and cfg.batch_size % (mesh.data_size * block):
            raise ValueError(
                f"batch {cfg.batch_size} does not split into {mesh.data_size} shards of whole "
                f"{block}-ray blocks")
        self._base_seed = self._base_seed0 = mix_seed(cfg.seed)
        self._generator = torch.Generator(device=train_store.device)
        # the per-ray tensors every batch is gathered from (train steps, the
        # post-mortem's replay); `swap_train_colors` replaces the targets
        self._train_arrays = train_store.arrays()

    def epoch_fraction(self, step: int) -> float:
        return step / self.steps_per_epoch

    def step_generator(self, base_seed: int, step: int) -> torch.Generator:
        """The generator of one step: seeded from (base seed, step)."""
        return self._generator.manual_seed(mix_seed(base_seed, step))

    def _batch(self, generator: torch.Generator, shard: bool = True) -> dict:
        """The step's batch: independent rays, or aligned runs of
        `batch_block` rays from run starts drawn by `generator`; on a mesh,
        this rank's shard of it unless `shard` is False."""
        store, block = self.train_store, self._block
        idx = torch.randint(0, store.n_rays // block, (self.cfg.batch_size // block,),
                            generator=generator, device=store.device)
        if block > 1:
            idx = (block * idx[:, None]
                   + torch.arange(block, device=store.device)).reshape(-1)
        if self.mesh is not None and shard:
            idx = shard_batch(idx, self.mesh, block)
        return sampler_lib.gather_batch_arrays(self._train_arrays, store.pixel_width, idx)

    def swap_train_colors(self, colors: torch.Tensor) -> None:
        """Replace the training targets (R, n_sigmas, 3) of every later batch
        (`gaborf/dataset.py:383-390`: the conv-blur-with-decay targets); same
        shape, dtype and device as the store's."""
        old = self._train_arrays["colors"]
        if (colors.shape != old.shape or colors.dtype != old.dtype
                or colors.device != old.device):
            raise ValueError(
                f"swap_train_colors: {tuple(colors.shape)} {colors.dtype} on {colors.device} "
                f"does not match the store's {tuple(old.shape)} {old.dtype} on {old.device}")
        self._train_arrays = dict(self._train_arrays, colors=colors)

    def regen_batch(self, step: int) -> dict:
        """The batch step `step` trained on (under the current seed stream);
        on a mesh, the global batch of all ranks."""
        return self._batch(self.step_generator(self._base_seed, step), shard=False)

    def fit(self, state) -> Any:
        cfg = self.cfg
        if cfg.rollback_enabled and self._snapshot is None:
            self._snapshot = (int(state.step), copy.deepcopy(state))
        total_steps = (cfg.max_steps if cfg.max_steps is not None
                       else cfg.max_epochs * self.steps_per_epoch)
        next_val = cfg.val_every_n_epochs
        next_ckpt = cfg.checkpoint_every_n_epochs or float("inf")
        t_start = time.perf_counter()
        # the rate of a log row counts the rays and seconds since the row
        # before it (the first: since fit() started)
        t_row, rays_since_row = t_start, 0

        step = int(state.step)
        while step < total_steps:
            epoch_frac = self.epoch_fraction(step)
            scalars = tuple(self.scalar_fn(step, epoch_frac))
            gen = self.step_generator(self._base_seed, step)
            batch = self._batch(gen)
            state, metrics = self.step_fn(state, batch, gen, *scalars)
            step += 1
            rays_since_row += cfg.batch_size
            if not self._postmortem_done and "grads_finite" in metrics:
                self._pending_finite.append((step - 1, scalars, metrics["grads_finite"]))
            if cfg.rollback_enabled and "loss" in metrics:
                self._pending_losses.append(metrics["loss"])

            if step % cfg.log_every_n_steps == 0 or step == total_steps:
                with annotate("trainer.log"):
                    # float() here is also the device sync point
                    row = {k: float(v) for k, v in metrics.items()}
                    row["epoch_fraction"] = epoch_frac
                    if self.lr_fn is not None:
                        row.update(self.lr_fn(step - 1))
                    self._check_postmortem()
                    now = time.perf_counter()
                    row["train_rays_per_sec"] = rays_since_row / max(now - t_row, 1e-9)
                    t_row, rays_since_row = now, 0
                    # wall seconds since fit() started: time-to-quality studies
                    # integrate over it
                    row["wall_s"] = round(now - t_start, 3)
                    if self.pose_error_fn is not None and (
                            step - self._last_pose_step >= cfg.pose_error_every_n_steps
                            or step == total_steps):
                        self._last_pose_step = step
                        with torch.no_grad():
                            row["pose_error"] = float(self.pose_error_fn(state.params))
                    self.metric_logger.log(row, step)
                    if cfg.rollback_enabled:
                        state, step = self._rollback_check(state, step)

            for cb in self.callbacks:
                cb(self, state, step, epoch_frac)

            if (self.val_fn is not None and self.val_store is not None
                    and epoch_frac >= next_val):
                next_val += cfg.val_every_n_epochs
                self._run_validation(state, step, scalars)

            if epoch_frac >= next_ckpt and self.checkpoint_manager is not None:
                next_ckpt += cfg.checkpoint_every_n_epochs
                self._save(step, state)

        if self.checkpoint_manager is not None:
            self._save(step, state)
        return state

    def _save(self, step: int, state) -> None:
        """A checkpoint of the full parameters and Adam moments, written by
        global rank 0 (with a model axis every rank first takes part in
        gathering the split moments)."""
        if self.mesh is not None:
            state = shard_lib.checkpoint_view(state, self.mesh)
        if self._lead:
            self.checkpoint_manager.save(step, state)

    def _rollback_check(self, state, step: int):
        """Fetch the buffered losses in one transfer, run the spike detector,
        and on a sustained divergence restore the snapshot and perturb the
        seed stream (mix_seed(base0, n_rollbacks)). Returns (state, step),
        possibly rewound."""
        cfg = self.cfg
        if not self._pending_losses:
            return state, step
        losses = torch.stack([torch.as_tensor(v, dtype=torch.float32)
                              for v in self._pending_losses]).double().cpu().numpy()
        self._pending_losses.clear()
        triggered = False
        for v in losses:
            spiking = (not np.isfinite(v)) or (
                self._ref_loss is not None and v > cfg.rollback_spike_factor * self._ref_loss)
            if spiking:
                self._spike_run += 1
            else:
                self._spike_run = 0
                self._ref_loss = (float(v) if self._ref_loss is None
                                  else 0.99 * self._ref_loss + 0.01 * float(v))
            if (self._spike_run >= cfg.rollback_patience
                    and step > cfg.rollback_warmup_steps
                    and self._snapshot is not None
                    and self._rollbacks < cfg.rollback_max):
                triggered = True
        if triggered:
            self._rollbacks += 1
            snap_step, snap_state = self._snapshot
            self._base_seed = mix_seed(self._base_seed0, self._rollbacks)
            self.metric_logger.log({
                "rollback": float(self._rollbacks),
                "rollback_from_step": float(step),
                "rollback_to_step": float(snap_step),
                "rollback_ref_loss": float(self._ref_loss or -1.0),
            }, step)
            self._spike_run = 0
            self._pending_finite.clear()
            # hand back a copy: the snapshot must survive in-place steps
            return copy.deepcopy(snap_state), snap_step
        if (self._spike_run == 0 and self._snapshot is not None
                and step - self._snapshot[0] >= cfg.rollback_snapshot_every_n_steps):
            # healthy interval: move the snapshot forward
            self._snapshot = (step, copy.deepcopy(state))
        return state, step

    def _check_postmortem(self) -> None:
        """Scan the buffered grads_finite flags (one transfer per log
        interval); dump the first offending batch."""
        if self._postmortem_done or not self._pending_finite:
            self._pending_finite.clear()
            return
        flags = torch.stack([torch.as_tensor(p[2]) for p in self._pending_finite]).cpu()
        for (bad_step, scalars, _), ok in zip(self._pending_finite, flags.tolist()):
            if not ok:
                if self._lead:
                    self._dump_postmortem(bad_step, scalars)
                self._postmortem_done = True
                break
        self._pending_finite.clear()

    def _dump_postmortem(self, bad_step: int, scalars) -> None:
        out_dir = os.path.dirname(self.metric_logger.path)
        os.makedirs(out_dir, exist_ok=True)
        batch = self.regen_batch(bad_step)
        payload = {f"batch_{k}": v.cpu().numpy() for k, v in batch.items()}
        payload["scalars"] = np.asarray([float(s) for s in scalars])
        payload["step"] = np.asarray(bad_step)
        payload["seed"] = np.asarray(mix_seed(self._base_seed, bad_step))
        np.savez(os.path.join(out_dir, f"postmortem_{bad_step}.npz"), **payload)
        self.metric_logger.log({"postmortem_step": float(bad_step)}, bad_step)

    def _run_validation(self, state, step: int, scalars=()) -> None:
        if not hasattr(self, "_val_takes_scalars"):
            # a val_fn declared (params, batch, *scalars) receives the LIVE
            # schedule scalars: eval paths that must match the training-time
            # encoding/activation state need them
            sig = inspect.signature(self.val_fn)
            self._val_takes_scalars = (
                len(sig.parameters) > 2
                or any(p.kind == inspect.Parameter.VAR_POSITIONAL
                       for p in sig.parameters.values()))
        store = self.val_store
        batch_size = min(self.cfg.batch_size, 1024)
        gen = torch.Generator(device=store.device).manual_seed(
            mix_seed(self._base_seed0, _VAL_STREAM, step))
        sc = tuple(scalars) if self._val_takes_scalars else ()
        vals: Dict[str, list] = {}
        arrays = store.arrays()
        with torch.no_grad():
            for _ in range(self.cfg.val_batches):
                idx = torch.randint(0, store.n_rays, (batch_size,), generator=gen,
                                    device=store.device)
                batch = sampler_lib.gather_batch_arrays(arrays, store.pixel_width, idx)
                for name, v in self.val_fn(state.params, batch, *sc).items():
                    vals.setdefault(f"val_{name}", []).append(float(v))
        self.metric_logger.log({k: float(np.mean(v)) for k, v in vals.items()}, step)
