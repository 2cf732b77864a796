"""Multi-process control plane — the port of the JAX package's
``parallel/multihost.py`` over ``torch.distributed``.

- ``initialize()``: idempotent, environment-driven init of the process
  group; a no-op for one process, so the same script runs on one card or
  under a launcher.  It reads torchrun's variables (``MASTER_ADDR``,
  ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``) where the JAX package reads
  ``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``.
- ``process_info()``: rank, world size, local and global devices (the
  JSON ``train_llama`` prints).
- ``local_batch_to_global()``: each process feeds its own rows of the
  batch.  With one process it is the trainer's ``shard_batch``, as JAX's
  degenerates to a plain ``device_put``; with several, each process's
  virtual ranks take the rows it loaded.  ``process_rows()`` cuts a host
  global batch to this process's rows (a ``CountedBatch``'s count leaf
  to its rank's entries).
- ``process_device()``: this process's device (``ring_procs.proc_device``
  under a group, the device asked for without one).
- ``process_mean()``: the mean of every process's scalar (the loss).
- ``barrier()``: every process arrives before any leaves.

``DPTrainer``, ``DDPTrainer`` and ``ShardedTrainer`` at dp span processes
(one rank a process, ``ops.ring_procs``: the fused BFP ring over CUDA IPC
peer buffers on one node, gloo sends for CPU rows), sync-BN's moments
through ``ring_procs.rank_gather``; what they do not take there, and the
other trainers, refuse a process group of more than one
(``refuse_processes``, ROADMAP A.11).  The group is gloo: it carries
control (barriers, IPC handles, the loss, sync-BN's moments) and the CPU
rows' frames; NCCL is not used.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import torch
import torch.distributed as dist

__all__ = ["initialize", "process_info", "local_batch_to_global",
           "barrier", "world_size", "process_index", "refuse_processes",
           "process_rows", "process_device", "process_mean"]

_initialized = False


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Idempotent ``torch.distributed.init_process_group``.  Each field:
    the argument, else torchrun's environment (``MASTER_ADDR`` and
    ``MASTER_PORT`` as ``tcp://addr:port``, ``WORLD_SIZE``, ``RANK``).  No
    coordinator and at most one process: nothing to coordinate, a no-op.
    The backend is gloo (the module docstring)."""
    global _initialized
    if _initialized or (dist.is_available() and dist.is_initialized()):
        _initialized = True
        return
    env = os.environ
    coord = coordinator_address
    if coord is None and env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        coord = f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    nproc = num_processes if num_processes is not None else int(
        env.get("WORLD_SIZE", "0") or 0) or None
    pid = process_id if process_id is not None else (
        int(env["RANK"]) if "RANK" in env else None)
    if coord is None and nproc in (None, 1):
        return
    if coord is None or nproc is None or pid is None:
        raise ValueError(
            f"multi-process init needs a coordinator, a world size and a "
            f"rank (got {coord!r}, {nproc!r}, {pid!r})")
    if not coord.startswith(("tcp://", "file://", "env://")):
        coord = f"tcp://{coord}"
    dist.init_process_group("gloo", init_method=coord, world_size=nproc,
                            rank=pid)
    _initialized = True


def _group() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_info() -> dict:
    """This process's rank, the world size, and the devices: cards where
    CUDA is available (one process drives its cards), else one CPU a
    process."""
    nproc = dist.get_world_size() if _group() else 1
    local = torch.cuda.device_count() if torch.cuda.is_available() else 1
    return {"process_id": dist.get_rank() if _group() else 0,
            "num_processes": nproc, "local_devices": local,
            "global_devices": local * nproc}


def world_size() -> int:
    """The processes of the group (1 without one)."""
    return dist.get_world_size() if _group() else 1


def process_index() -> int:
    return dist.get_rank() if _group() else 0


def refuse_processes(what: str) -> None:
    """Raise for ``what`` under a group of more than one process."""
    if world_size() > 1:
        raise NotImplementedError(
            f"{what} across processes is not ported (ROADMAP A.11): "
            "DPTrainer (a fused optimizer), DDPTrainer and ShardedTrainer "
            "at dp span processes with BFP (sublane) or no codec; "
            "here run one process with virtual ranks")


def local_batch_to_global(batch: Any, trainer: Any) -> Any:
    """The trainer's sharded batch from this process's rows: with one
    process ``trainer.shard_batch(batch)``.  With several, the process's
    rows are its share of the global batch in rank order (process i the
    rows rank i takes), the one rank it holds their only shard: no
    process ever holds the whole batch."""
    if getattr(trainer, "world", 1) > 1:
        from .mesh import VirtualRanks
        return VirtualRanks(1, trainer.ranks.device).shard_batch(batch)
    return trainer.shard_batch(batch)


def process_rows(batch: Any, rank: Optional[int] = None,
                 world: Optional[int] = None) -> Any:
    """Process ``rank``'s rows (default: this process's) of a host global
    batch, a tuple of leaves with a leading batch axis: rows ``rank B /
    world`` onward, and of a ``CountedBatch`` (``bert.with_global_count``)
    its count leaf's entries of that rank.  One process: the batch as it
    is."""
    from .mesh import CountedBatch
    world = world_size() if world is None else world
    rank = process_index() if rank is None else rank
    if world == 1:
        return batch
    *leaves, last = batch

    def rows(x):
        if x.shape[0] % world:
            raise ValueError(f"a batch leaf of {x.shape[0]} rows does not "
                             f"split over {world} processes")
        b = x.shape[0] // world
        return x[rank * b:(rank + 1) * b]
    if isinstance(batch, CountedBatch):
        return CountedBatch(tuple(rows(x) for x in leaves) + (rows(last),))
    return type(batch)(rows(x) for x in batch)


def process_device(device: Any = "cuda") -> torch.device:
    """This process's device: ``device`` itself (resolved) without a
    group; under one, the CPU when asked, else its card
    (``ring_procs.proc_device``), made the current one."""
    from ..device import resolve_device
    from ..ops import ring_procs
    if world_size() == 1:
        return resolve_device(device)
    dev = ring_procs.proc_device(process_index(), world_size(), device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


def process_mean(value: torch.Tensor) -> torch.Tensor:
    """The mean over the processes of every process's scalar (the
    one-process trainer's mean over its ranks of the rank losses, in rank
    order), gathered over the gloo group; the value itself without a
    group."""
    if world_size() == 1:
        return value
    mine = value.detach().reshape(1).to("cpu", torch.float32)
    parts = [torch.empty_like(mine) for _ in range(world_size())]
    dist.all_gather(parts, mine)
    return torch.cat(parts).to(value.device).mean()


def barrier(name: str = "barrier") -> None:
    """Block until every process arrives (a no-op for one process)."""
    if _group():
        dist.barrier()
