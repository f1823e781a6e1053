"""The process mesh and its replication helpers: ``evfly_tpu/parallel/
mesh.py`` on ``torch.distributed``.

The JAX package's mesh is a 1-D ``data`` axis over the chips of one
process, parameters replicated, the batch's leading axis sharded, and XLA
inserting the gradient all-reduce.  Here a mesh is one process per card:
(world size, this process's rank, its device).  A world of 1 is this
process alone and needs no process group; a larger one needs a group of
exactly that many processes, NCCL between cards, gloo on the CPU (or for
several processes on one card).  ``torchrun --nproc_per_node=N`` starts
such a group (``init_from_env``); a script can start one itself with
``init_group`` (``tcp://localhost:<port>`` or ``file://<path>``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Mapping, Optional

import torch
import torch.distributed as dist

from ..device import DeviceLike, resolve_device


@dataclass(frozen=True)
class Mesh:
    """(world size, rank, device) of this process."""

    world_size: int
    rank: int
    device: torch.device

    def all_reduce_sum_(self, t: torch.Tensor) -> torch.Tensor:
        """t summed over the processes, in place (nothing in a world of 1)."""
        if self.world_size > 1:
            dist.all_reduce(t, op=dist.ReduceOp.SUM)
        return t

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """t as rank ``src`` holds it, in place (nothing in a world of 1)."""
        if self.world_size > 1:
            dist.broadcast(t, src=src)
        return t


def backend_for(device: DeviceLike, n_processes: int = 1) -> str:
    """NCCL where each process has a card of its own, else gloo (the CPU,
    or several processes sharing one card: gloo reduces CUDA tensors too)."""
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= n_processes:
        return "nccl"
    return "gloo"


def init_group(world_size: int, rank: int, init_method: str, device: DeviceLike) -> None:
    """Start this process's part of a group of ``world_size`` on
    ``device`` (``backend_for``)."""
    dist.init_process_group(backend_for(device, world_size), init_method=init_method,
                            world_size=world_size, rank=rank)


def init_from_env() -> Optional[Mesh]:
    """The group ``torchrun`` describes in the environment (WORLD_SIZE,
    RANK, LOCAL_RANK, MASTER_ADDR, MASTER_PORT), each process on card
    LOCAL_RANK (the CPU without a card); None outside torchrun or in a
    world of 1."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return None
    dev = torch.device("cpu")
    if torch.cuda.is_available():
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        init_group(world, int(os.environ["RANK"]), "env://", dev)
    return Mesh(world, dist.get_rank(), dev)


def make_mesh(n_devices: Optional[int] = None, device: DeviceLike = None) -> Mesh:
    """The mesh of ``n_devices`` processes (None or 0: 1) on ``device`` (the
    card unless the caller names another).  More than 1 needs an
    initialized process group of exactly that size, else this raises with
    how to launch one."""
    n = 1 if not n_devices else int(n_devices)
    dev = resolve_device(device)
    if n == 1:
        return Mesh(1, 0, dev)
    hint = (f"launch one process per card with `torchrun --nproc_per_node={n} -m "
            f"evfly_tpu_torch.train --config <file>` (dp_devices = {n}), or call "
            f"torch.distributed.init_process_group(world_size={n}, rank=..., "
            f"init_method='tcp://localhost:<port>') in each process first")
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(f"dp_devices = {n} needs a torch.distributed process group of {n} "
                           f"processes and none is initialized: {hint}")
    if dist.get_world_size() != n:
        raise RuntimeError(f"dp_devices = {n} but the process group has "
                           f"{dist.get_world_size()} processes: {hint}")
    return Mesh(n, dist.get_rank(), dev)


def replicate_params(params, mesh: Mesh):
    """Every tensor of ``params`` (a module's state, a state_dict or an
    optimizer) as rank 0 holds it, in place; returns ``params``."""
    if isinstance(params, torch.nn.Module):
        tensors = list(params.state_dict().values())
    elif isinstance(params, torch.optim.Optimizer):
        tensors = [v for st in params.state.values() for v in st.values()
                   if isinstance(v, torch.Tensor) and v.device == mesh.device]
    else:
        tensors = list(params.values())
    for t in tensors:
        mesh.broadcast_(t)
    return params


def batch_sharding(mesh: Mesh, n: int) -> slice:
    """The rows of a leading axis of ``n`` that this rank holds: a
    contiguous 1/world of them (n divisible by the world size)."""
    if n % mesh.world_size:
        raise ValueError(f"a leading axis of {n} does not split over {mesh.world_size} processes")
    per = n // mesh.world_size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def shard_batch(batch: Mapping[str, Any], mesh: Mesh) -> dict:
    """This rank's slice of every array's leading (chunk or stream) axis."""
    return {k: v[batch_sharding(mesh, len(v))] for k, v in batch.items()}


def spawn_ranks(fn, n_processes: int, *args, device: DeviceLike = "cpu", init_dir: str):
    """Run ``fn(mesh, *args)`` in ``n_processes`` processes started by
    ``torch.multiprocessing`` (spawn), one group through
    ``file://<init_dir>/group``: on NCCL each process on its own card, on
    gloo all on ``device``.  ``fn`` must live in an importable module, and
    the caller's main script, which each process imports, must keep its
    work under ``if __name__ == "__main__"``.  Returns when all have ended;
    raises with a failed process's traceback and stops the others."""
    os.makedirs(init_dir, exist_ok=True)
    init = "file://" + os.path.join(os.path.abspath(init_dir), "group")
    torch.multiprocessing.start_processes(_rank_entry, (fn, n_processes, init, str(device), args),
                                          nprocs=n_processes, start_method="spawn")


def _rank_entry(rank: int, fn, world: int, init: str, device: str, args) -> None:
    """One process of ``spawn_ranks``: join the group, run ``fn``."""
    dev = torch.device(device)
    if backend_for(dev, world) == "nccl":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    init_group(world, rank, init, dev)
    try:
        fn(Mesh(world, rank, dev), *args)
    finally:
        dist.destroy_process_group()
