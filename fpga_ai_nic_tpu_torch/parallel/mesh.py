"""Virtual ranks on one card — what stands in for the JAX package's dp
mesh axis (``parallel/mesh.py``).

The port runs the reference's 1-D data-parallel ring in loopback: n ranks
share one device, every per-rank tensor is stacked over the ranks as its
leading dimension, and a ring hop is a write into the neighbour's rows
(``ops.ring_cuda``).  This mirrors the JAX package's
``ring_pallas.loopback_microbench``, which runs ``virtual_n`` ranks on one
TPU chip.  Rings across cards (NCCL) are not part of the port yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import torch

from ..device import DeviceLike, resolve_device
from ..utils.config import MeshConfig


@dataclass(frozen=True)
class VirtualRanks:
    """n data-parallel ranks stacked on one device."""

    n: int
    device: torch.device

    def __post_init__(self) -> None:
        if self.n < 1:
            raise ValueError(f"need at least one rank, got {self.n}")

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        """[B, ...] global batch -> [n, B/n, ...] on the device: rank i
        gets rows i*B/n .. (i+1)*B/n - 1 (the MPI_Scatter analogue)."""
        if x.shape[0] % self.n:
            raise ValueError(f"global batch {x.shape[0]} does not split "
                             f"over {self.n} ranks")
        return x.to(self.device).reshape(self.n, -1, *x.shape[1:])

    def shard_batch(self, batch: Sequence[torch.Tensor]
                    ) -> Tuple[torch.Tensor, ...]:
        return tuple(self.shard(x) for x in batch)


def make_ranks(cfg: MeshConfig, device: DeviceLike = "cuda"
               ) -> VirtualRanks:
    """The dp axis of a MeshConfig as virtual ranks on ``device``; the
    other axes are not ported."""
    for name, size in cfg.axis_sizes():
        if name != "dp" and size != 1:
            raise NotImplementedError(
                f"mesh axis {name}={size} is not ported: the port runs "
                "data parallelism only")
    return VirtualRanks(cfg.dp, resolve_device(device))
