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
  virtual ranks take the rows it loaded.
- ``barrier()``: every process arrives before any leaves.

The port's trainers run their ranks as virtual ranks of one process (one
card); ROADMAP A.11 carries the rings across cards.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import torch
import torch.distributed as dist

__all__ = ["initialize", "process_info", "local_batch_to_global",
           "barrier"]

_initialized = False


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Idempotent ``torch.distributed.init_process_group``.  Each field:
    the argument, else torchrun's environment (``MASTER_ADDR`` and
    ``MASTER_PORT`` as ``tcp://addr:port``, ``WORLD_SIZE``, ``RANK``).  No
    coordinator and at most one process: nothing to coordinate, a no-op.
    The backend is NCCL where CUDA is available, else gloo."""
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
    dist.init_process_group(
        "nccl" if torch.cuda.is_available() else "gloo",
        init_method=coord, world_size=nproc, rank=pid)
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


def local_batch_to_global(batch: Any, trainer: Any) -> Any:
    """The trainer's sharded batch from this process's rows: with one
    process ``trainer.shard_batch(batch)``.  With several, the process's
    rows are its share of the global batch in rank order, and its virtual
    ranks shard them: each process holds the ranks that consume its
    rows, so no process ever holds the whole batch."""
    return trainer.shard_batch(batch)


def barrier(name: str = "barrier") -> None:
    """Block until every process arrives (a no-op for one process)."""
    if _group():
        dist.barrier()
