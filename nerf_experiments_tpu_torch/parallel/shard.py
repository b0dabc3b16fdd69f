"""Data-parallel training and rendering over a mesh's data group.

Port of `nerf_experiments_tpu/parallel/shard.py`. XLA inserts the gradient
all-reduce from sharding annotations there; here the step says it
(`update`): after the backward, `sync_grads` takes the mean of the
gradients over the data group (JAX's `pmean`) and `sync_metrics` the mean of
the losses, and then the non-finite guard and Adam run on every rank on the
same numbers, so the replicated parameters stay equal bit for bit. With a
model axis, Adam updates each split leaf's columns on its rank and the
model group all-gathers them back into the full leaf. No DistributedDataParallel:
the fused steps set `p.grad` from the kernels directly, where DDP's autograd
hooks would never fire; one explicit reduction serves every step alike.

Every step takes this rank's shard of the global batch (`mesh.shard_batch`,
as the trainer hands it):
  * `pjit_train_step`: global semantics. Its draws are the global batch's
    (`ops/sampling.py:RowShard`), so with a global batch split over the ranks
    its trajectory is the single-device step's on that batch;
  * `shard_map_train_step`: a loss function's per-shard gradients reduced,
    every rank drawing from the generator it is given;
  * `shard_map_train_step_fused`: the flagship train kernel (K4) on every
    rank's shard; the rank is folded into the step's seed.
"""
from __future__ import annotations

import types
from typing import Callable, Dict, Iterable, List

import torch
import torch.distributed as dist

from nerf_experiments_tpu_torch.ops.metrics import psnr
from nerf_experiments_tpu_torch.ops.sampling import RowShard
from nerf_experiments_tpu_torch.parallel.mesh import Mesh, shard_params
from nerf_experiments_tpu_torch.training import optim


@torch.no_grad()
def sync_grads(params: Iterable[torch.Tensor], mesh: Mesh) -> None:
    """Every parameter's gradient <- its mean over the data group: one
    all-reduce of one flat buffer, in the parameters' order, divided by the
    group's size (a missing gradient counts as zeros, as the guard makes
    it). The result is the same bits on every rank."""
    params = list(params)
    flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                      for p in params])
    dist.all_reduce(flat, group=mesh.data_group)
    flat.div_(mesh.data_size)
    offset = 0
    for p in params:
        p.grad = flat[offset:offset + p.numel()].view_as(p)
        offset += p.numel()


@torch.no_grad()
def sync_metrics(metrics: Dict, mesh: Mesh) -> Dict:
    """The mean over the data group of every floating-point metric (loss,
    loss_fine, loss_coarse, ...), in one all-reduce; `psnr` recomputed from
    the reduced `loss_fine` (or `radiance_loss`), as the JAX step takes it
    from the pmean'd loss."""
    keys = [k for k, v in metrics.items()
            if torch.is_tensor(v) and v.is_floating_point() and k != "psnr"]
    if keys:
        stacked = torch.stack([metrics[k].detach().float().reshape(()) for k in keys])
        dist.all_reduce(stacked, group=mesh.data_group)
        stacked.div_(mesh.data_size)
        metrics.update({k: stacked[i].to(metrics[k].dtype) for i, k in enumerate(keys)})
    for source in ("loss_fine", "radiance_loss"):
        if "psnr" in metrics and source in metrics:
            metrics["psnr"] = psnr(metrics[source])
            break
    return metrics


def shard_state(state, mesh: Mesh):
    """Place a fresh training state (`.params`, `.optimizer` before its
    first step) on the mesh: the parameters broadcast from rank 0, and with
    a model axis the optimizer updating each split leaf's shard in place of
    the leaf (`mesh.shard_params`)."""
    shards = shard_params(state.params, mesh)
    if shards:
        swap = {id(s.full): s.shard for s in shards}
        for group in state.optimizer.adam.param_groups:
            group["params"] = [swap.get(id(p), p) for p in group["params"]]
        state.optimizer.model_shards = shards
    return state


def full_params(optimizer) -> List[torch.Tensor]:
    """The optimizer's parameters with each model shard's full leaf in its
    place: the tensors the backward gives gradients to."""
    swap = {id(s.shard): s.full for s in optimizer.model_shards}
    return [swap.get(id(p), p) for p in optimizer.params()]


def update(state, metrics: Dict, mesh: Mesh) -> Dict:
    """After the backward, in place of the guard and Adam of a step without
    a mesh: the gradients and metrics averaged over the data group, the
    guard on the full gradients (the same decision on every rank), each
    model shard's columns of its leaf's gradient handed to Adam, the update,
    and the split leaves gathered whole again."""
    opt = state.optimizer
    full = full_params(opt)
    sync_grads(full, mesh)
    metrics = sync_metrics(metrics, mesh)
    metrics["grads_finite"] = optim.guard_nonfinite(full)
    for s in opt.model_shards:
        s.shard.grad = s.full.grad[..., s.lo:s.hi].contiguous()
        s.full.grad = None
    opt.step()
    with torch.no_grad():
        for s in opt.model_shards:
            parts = [torch.empty_like(s.shard) for _ in range(mesh.model_size)]
            dist.all_gather(parts, s.shard.detach(), group=mesh.model_group)
            s.full.copy_(torch.cat(parts, dim=-1))
    return metrics


_MOMENTS = ("exp_avg", "exp_avg_sq")


@torch.no_grad()
def full_optimizer_state(optimizer, mesh: Mesh) -> dict:
    """The optimizer's `state_dict` with every model shard's Adam moments
    all-gathered whole (a collective: every rank calls it): the layout of
    the same optimizer without a model axis."""
    sd = optimizer.state_dict()
    if not optimizer.model_shards:
        return sd
    index = {id(p): i for i, p in enumerate(optimizer.params())}
    state = {i: dict(st) for i, st in sd["adam"]["state"].items()}
    for s in optimizer.model_shards:
        st = state.get(index[id(s.shard)], {})
        for k in _MOMENTS:
            if k in st:
                parts = [torch.empty_like(st[k]) for _ in range(mesh.model_size)]
                dist.all_gather(parts, st[k].contiguous(), group=mesh.model_group)
                st[k] = torch.cat(parts, dim=-1)
    return dict(sd, adam=dict(sd["adam"], state=state))


def checkpoint_view(state, mesh: Mesh):
    """What a checkpoint of `state` holds: the state itself, or with a model
    axis its full parameters and `full_optimizer_state` (a collective)."""
    if not state.optimizer.model_shards:
        return state
    sd = full_optimizer_state(state.optimizer, mesh)
    return types.SimpleNamespace(params=state.params, step=state.step,
                                 optimizer=types.SimpleNamespace(state_dict=lambda: sd))


@torch.no_grad()
def reshard(state) -> None:
    """After a checkpoint (of full leaves and moments, from a mesh or one
    device) is loaded into a model-sharded state: each shard <- its columns
    of the loaded leaf, and its moments <- their columns."""
    opt = state.optimizer
    for s in opt.model_shards:
        s.shard.copy_(s.full[..., s.lo:s.hi])
        st = opt.adam.state.get(s.shard, {})
        for k in _MOMENTS:
            if k in st and st[k].shape != s.shard.shape:
                st[k] = st[k][..., s.lo:s.hi].contiguous()


def pjit_train_step(step_fn: Callable, mesh: Mesh) -> Callable:
    """`step_fn(state, batch, generator, *scalars, mesh=mesh)` (a step that
    reduces over `mesh`, such as `systems.barf.train_step`) ->
    `step(state, batch, generator, *scalars)` on this rank's batch shard,
    drawing its rows of the global draws from the step generator."""

    def stepped(state, batch, generator, *scalars):
        gen = (None if generator is None
               else RowShard(generator, mesh.data_rank, mesh.data_size))
        return step_fn(state, batch, gen, *scalars, mesh=mesh)

    return stepped


def shard_map_train_step(loss_fn: Callable, mesh: Mesh) -> Callable:
    """loss_fn(params, batch, generator, *scalars) -> (loss, metrics) ->
    step(state, batch, generator, *scalars): the shard's loss and gradients,
    their mean over the data group, then the guard and Adam on every rank.
    The metrics gain `loss` and `grads_finite`."""

    def step(state, batch, generator, *scalars):
        state.optimizer.zero_grad()
        loss, metrics = loss_fn(state.params, batch, generator, *scalars)
        loss.backward()
        metrics = update(state, dict(metrics, loss=loss.detach()), mesh)
        state.step += 1
        return state, metrics

    return step


def shard_map_train_step_fused(cfg, mesh: Mesh) -> Callable:
    """The data-parallel BARF step through the flagship train kernel: every
    rank runs K4 on its ray shard (rays are independent: the kernel needs no
    communication), the gradients and losses are averaged over the data
    group, and the update is the same on every rank. With more than one
    data rank the step generator's seed is folded with the rank
    (`mix_seed(seed, data_rank)`, JAX's `fold_in(key, axis_index)`) for the
    bins; the occupancy refresh keeps the unfolded seed, so the grid stays
    replicated. Returns step(state,
    batch, generator, alpha_pos, alpha_dir, blur_sigma)."""
    from nerf_experiments_tpu_torch.systems import barf

    def step(state, batch, generator, alpha_pos, alpha_dir, blur_sigma):
        return barf.train_step_fused(state, cfg, batch, generator, alpha_pos, alpha_dir,
                                     blur_sigma, mesh=mesh)

    return step


def sharded_render(forward_fn: Callable, mesh: Mesh) -> Callable:
    """forward_fn(params, origs, dirs, pixel_width) -> rgb (N, 3) ->
    render(params, origs, dirs, pixel_width) with the rays split over the
    data group: padded with zero rays to a multiple of its size, this
    rank's slice forwarded, the slices all-gathered and the padding cut.
    Every rank of the group must call it with the same rays."""

    def render(params, origs, dirs, pixel_width):
        n = origs.shape[0]
        w = mesh.data_size
        pad = (-n) % w
        if pad:
            def zpad(x):
                return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
            origs, dirs, pixel_width = zpad(origs), zpad(dirs), zpad(pixel_width)
        per = (n + pad) // w
        lo = mesh.data_rank * per
        out = forward_fn(params, origs[lo:lo + per], dirs[lo:lo + per],
                         pixel_width[lo:lo + per]).contiguous()
        parts = [torch.empty_like(out) for _ in range(w)]
        dist.all_gather(parts, out, group=mesh.data_group)
        return torch.cat(parts)[:n]

    return render
