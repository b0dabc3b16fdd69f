"""Start the ranks of a mesh on one machine without a launcher.

`torchrun` is the launcher of a real run (`torchrun --standalone
--nproc_per_node=N -m nerf_experiments_tpu_torch.experiments.run_barf --mesh
auto ...`). `run_ranks` is the in-process counterpart for tests and the card's
smoke test: it spawns one process a rank, joins each to a default group over
a file store (no ports), runs a function in every rank and re-raises any
rank's failure, with a bound on the whole that raises instead of hanging.
"""
from __future__ import annotations

import datetime
import os
import time
from typing import Callable, Sequence

import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_entry(rank: int, fn: Callable, world_size: int, init_file: str, backend: str,
                group_timeout_s: float, args: Sequence) -> None:
    # the ranks are this machine's: each is its own local rank, as torchrun
    # numbers them
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world_size))
    dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=group_timeout_s))
    try:
        fn(rank, world_size, *args)
    finally:
        dist.destroy_process_group()


def run_ranks(fn: Callable, world_size: int, args: Sequence = (), *, init_file: str,
              backend: str = "gloo", timeout_s: float = 120.0,
              group_timeout_s: float = 60.0) -> None:
    """Run `fn(rank, world_size, *args)` in `world_size` spawned processes,
    each in a default group of `backend` over the file store `init_file`
    (a path that does not exist yet). `fn` must be importable by the
    children (a module-level function). Raises the first failure of any
    rank, and TimeoutError (after terminating every rank) when they have not
    all finished within `timeout_s`."""
    ctx = mp.start_processes(
        _rank_entry, args=(fn, world_size, init_file, backend, group_timeout_s, tuple(args)),
        nprocs=world_size, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    # join raises as soon as any rank fails, after terminating the others
    while not ctx.join(timeout=max(0.1, min(5.0, deadline - time.monotonic()))):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
            for p in ctx.processes:
                p.join(10)
                if p.is_alive():
                    p.kill()
            raise TimeoutError(f"{world_size} ranks of {getattr(fn, '__name__', fn)} did not "
                               f"finish within {timeout_s} s")
