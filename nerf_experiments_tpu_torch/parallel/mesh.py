"""The device mesh over `torch.distributed`: ranks, groups and sharding rules.

Port of `nerf_experiments_tpu/parallel/mesh.py`. There a mesh is an array of
TPU devices with named axes and XLA places arrays by sharding annotations;
here every device is a process (a rank) started by `torchrun` (or by
`parallel/launch.py:run_ranks`), and the mesh is the set of process groups
those ranks reduce and gather over:

  * axes ("data", "model"), or ("host", "data", "model") with an outer host
    axis: rays are split over host x data jointly, flattened host-major (the
    order in which JAX's sharding lays out a batch over those two axes);
  * the whole ray store and the parameters are replicated on every rank's
    device, as the JAX store is; `shard_batch` keeps a rank's rows of the
    global batch;
  * with a model axis above 1, `param_spec` (the JAX rule) picks the leaves
    whose last dim is split over the model group: each rank keeps its
    columns, and their Adam moments, as the copy the optimizer updates
    (`shard_params`); the full leaf is gathered after every update, so the
    forward reads whole weights, and the trajectory is the replicated one.

A mesh of one rank is the single-device program: the collectives of a
one-rank group return their input, and the steps of `parallel/shard.py` then
give the bits of the steps without a mesh.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

DATA_AXIS = "data"
MODEL_AXIS = "model"
HOST_AXIS = "host"  # outer data-parallel axis


@dataclasses.dataclass(eq=False)
class Mesh:
    """One rank's view of the mesh: its device, the groups it reduces over
    and its index in each. `data_group` is host x data flattened; every rank
    of one model group holds the same data index, hence the same rays."""

    device_mesh: DeviceMesh
    device: torch.device
    data_group: dist.ProcessGroup
    model_group: dist.ProcessGroup
    data_rank: int
    data_size: int
    model_rank: int
    model_size: int
    owns_group: bool = False  # the default group was created by make_mesh

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.device_mesh.mesh_dim_names)

    @property
    def shape(self) -> Dict[str, int]:
        """{axis: size}, as `jax.sharding.Mesh.shape`."""
        return dict(zip(self.axis_names, self.device_mesh.mesh.shape))

    @property
    def rank(self) -> int:
        """The global rank: the one that writes logs and checkpoints is 0."""
        return dist.get_rank()

    def close(self) -> None:
        """Destroy the default group if this mesh created it (a run without
        a launcher), so that a later entry point in the process can make
        its own."""
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()
        self.owns_group = False


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def _resolve_device(device: Union[str, torch.device, None], world: int) -> torch.device:
    """The rank's device: `cuda` means cuda:LOCAL_RANK, which must exist; an
    explicit index is the caller's choice (several ranks may then share a
    card, over gloo); `cpu` is the CPU."""
    device = torch.device(device if device is not None else "cuda")
    if device.type != "cuda" or device.index is not None:
        return device
    local_rank = _env_int("LOCAL_RANK", 0)
    count = torch.cuda.device_count()
    if local_rank >= count:
        raise RuntimeError(
            f"a mesh of {world} ranks puts local rank {local_rank} on cuda:{local_rank}, "
            f"but torch.cuda.device_count() is {count}: one card holds at most one NCCL rank")
    return torch.device("cuda", local_rank)


def make_mesh(
    n_data: Optional[int] = None,
    n_model: int = 1,
    n_hosts: int = 1,
    *,
    device: Union[str, torch.device, None] = None,
    backend: Optional[str] = None,
) -> Mesh:
    """Mesh over (data, model), or (host, data, model) when n_hosts > 1, over
    every rank of the default process group.

    The group is the one the caller or `torchrun` set up (RANK, WORLD_SIZE,
    MASTER_ADDR in the environment); in a process with neither, make_mesh
    creates a one-rank group and `Mesh.close` destroys it. `backend=None`
    means NCCL on CUDA and gloo on the CPU. `n_data` defaults to the world
    size over n_model * n_hosts."""
    world = dist.get_world_size() if dist.is_initialized() else _env_int("WORLD_SIZE", 1)
    if n_data is None:
        n_data = world // (n_model * n_hosts)
    assert n_hosts * n_data * n_model == world, (
        f"mesh {n_hosts}x{n_data}x{n_model} != {world} devices")
    device = _resolve_device(device, world)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.cuda.init()
    owns = not dist.is_initialized()
    if owns:
        if "MASTER_ADDR" in os.environ:
            dist.init_process_group(backend, init_method="env://",
                                    rank=_env_int("RANK", 0), world_size=world)
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    try:
        rank = dist.get_rank()
        if n_hosts > 1:
            shape, names = (n_hosts, n_data, n_model), (HOST_AXIS, DATA_AXIS, MODEL_AXIS)
        else:
            shape, names = (n_data, n_model), (DATA_AXIS, MODEL_AXIS)
        device_mesh = init_device_mesh(device.type, shape, mesh_dim_names=names)
        if n_hosts > 1:
            # host x data flattened: every group is made by every rank, in
            # the same order, as new_group requires
            data_group = None
            for m in range(n_model):
                ranks = list(range(m, world, n_model))
                group = dist.new_group(ranks)
                if rank in ranks:
                    data_group = group
        else:
            data_group = device_mesh.get_group(DATA_AXIS)
        return Mesh(device_mesh=device_mesh, device=device, data_group=data_group,
                    model_group=device_mesh.get_group(MODEL_AXIS),
                    data_rank=rank // n_model, data_size=n_hosts * n_data,
                    model_rank=rank % n_model, model_size=n_model, owns_group=owns)
    except BaseException:
        if owns:
            dist.destroy_process_group()
        raise


def is_lead(mesh: Optional[Mesh]) -> bool:
    """True on the rank that writes logs and checkpoints: global rank 0, or
    the one process of a run without a mesh."""
    return mesh is None or mesh.rank == 0


def data_axes(mesh: Mesh) -> Tuple[str, ...]:
    """The batch-sharding axes: ("host", "data") on a mesh with hosts."""
    if HOST_AXIS in mesh.axis_names:
        return (HOST_AXIS, DATA_AXIS)
    return (DATA_AXIS,)


def shard_batch(batch, mesh: Mesh, block: int = 1):
    """This rank's rows of a global batch (a tensor or a dict of tensors with
    a leading ray dim): data rank r of W keeps rows [r B/W, (r+1) B/W). The
    batch must split into whole runs of `block` rays (`batch_block`) on
    every rank."""
    rows = (next(iter(batch.values())) if isinstance(batch, dict) else batch).shape[0]
    w = mesh.data_size
    if rows % (w * block):
        raise ValueError(f"a batch of {rows} rays does not split into {w} shards of whole "
                         f"{block}-ray blocks")
    lo = mesh.data_rank * (rows // w)
    hi = lo + rows // w
    if isinstance(batch, dict):
        return {k: v[lo:hi] for k, v in batch.items()}
    return batch[lo:hi]


@torch.no_grad()
def replicate(params: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Broadcast every parameter and buffer from global rank 0, in place, so
    that every rank starts from rank 0's state."""
    for t in params.state_dict().values():
        dist.broadcast(t, src=0)
    return params


def param_spec(shape, n_model: int, min_dim: int = 256) -> Tuple:
    """The JAX rule for one leaf: split the last dim over "model" when the
    leaf has rank >= 2 and that dim is >= min_dim and divisible by n_model;
    replicate otherwise (the 257-wide segment head stays whole). Returns the
    PartitionSpec as a tuple: (None, ..., "model") or ()."""
    if n_model > 1 and len(shape) >= 2 and shape[-1] >= min_dim and shape[-1] % n_model == 0:
        return (None,) * (len(shape) - 1) + (MODEL_AXIS,)
    return ()


@dataclasses.dataclass(eq=False)
class ModelShard:
    """A leaf split over the model axis: the module's parameter `full` (the
    gathered working copy that the forward and backward read) and this
    rank's columns `shard` = full[..., lo:hi], the copy that Adam updates
    (its moments are the shard's size)."""

    full: torch.nn.Parameter
    shard: torch.Tensor
    lo: int
    hi: int


@torch.no_grad()
def shard_params(params: torch.nn.Module, mesh: Mesh) -> List[ModelShard]:
    """Place parameters on the mesh: every rank takes global rank 0's
    (`replicate`); with a model axis above 1, each leaf that `param_spec`
    splits also gets this rank's columns of its last dim, returned as
    `ModelShard`s (none without a model axis). `parallel/shard.py:shard_state`
    hands those to the optimizer."""
    replicate(params, mesh)
    if mesh.model_size == 1:
        return []
    out = []
    for p in params.parameters():
        if param_spec(tuple(p.shape), mesh.model_size):
            width = p.shape[-1] // mesh.model_size
            lo = mesh.model_rank * width
            shard = p.detach()[..., lo:lo + width].clone().requires_grad_(True)
            out.append(ModelShard(p, shard, lo, lo + width))
    return out
