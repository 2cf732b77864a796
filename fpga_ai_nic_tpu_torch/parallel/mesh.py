"""Virtual ranks on one card — what stands in for the JAX package's dp,
fsdp, sp, ep and pp mesh axes (``parallel/mesh.py``).

The port runs the reference's 1-D data-parallel ring in loopback: n ranks
share one device, every per-rank tensor is stacked over the ranks as its
leading dimension, and a ring hop is a write into the neighbour's rows
(``ops.ring_cuda``).  This mirrors the JAX package's
``ring_pallas.loopback_microbench``, which runs ``virtual_n`` ranks on one
TPU chip.  Rings across cards (NCCL) are not part of the port yet.

An sp axis (sequence parallelism) stacks the sequence shards of each dp
rank as a second leading dimension: a ``[B, S]`` batch leaf becomes
``[n_dp, n_sp, B / n_dp, S / n_sp]`` (JAX's ``P(dp, sp)``: rank (d, s)
holds JAX device (d, s)'s rows and columns), and one dp rank's loss runs
over its n_sp shards at once (``models.llama.loss_fn(..., sp_axis=...)``).

An ep axis (expert parallelism) splits the batch alongside dp, as JAX's
``P((dp, ep), sp)`` does: a ``[B, S]`` leaf becomes ``[n_dp, n_ep, B /
(n_dp n_ep), S]``, rank (d, e) holding JAX device (d, e)'s rows (dp
major), and the MoE loss runs over all the ranks at once
(``models.llama.dp_loss_fn``).  With both, a ``[B, S]`` leaf becomes
``[n_dp, n_ep, n_sp, B / (n_dp n_ep), S / n_sp]``: device (d, e, s)
holds JAX device (d, s, e)'s rows and columns of ``P((dp, ep), sp)``.

A pp axis (pipeline parallelism) does not split the batch (JAX's batch
spec never names pp): each dp rank's batch runs through its pp stages,
one parameter row a (pp, dp) rank (``parallel.sharded``,
``parallel.pipeline``).  With sp or ep too the batch keeps the layout
above, and a stage's trees are the pp index into the parameter rows
(``P((pp, ep, dp))``).

An fsdp axis (ZeRO-3, ``parallel.fsdp.FSDPTrainer``) runs alone, as JAX's
FSDPTrainer shards over its fsdp axis only: its ranks are stacked as the
leading dimension and split the batch as dp ranks do.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import torch

from ..device import DeviceLike, resolve_device
from ..utils.config import MeshConfig


@dataclass(frozen=True)
class VirtualRanks:
    """n data-parallel ranks stacked on one device, each holding ``ep``
    expert-parallel ranks, each of those ``sp`` sequence shards; each
    rank's model split over ``pp`` pipeline stages."""

    n: int
    device: torch.device
    sp: int = 1
    ep: int = 1
    pp: int = 1

    def __post_init__(self) -> None:
        if min(self.n, self.sp, self.ep, self.pp) < 1:
            raise ValueError(f"need at least one rank, got dp={self.n}, "
                             f"sp={self.sp}, ep={self.ep}, pp={self.pp}")

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        """[B, ...] global batch -> [n, B/n, ...] on the device: rank i
        gets rows i*B/n .. (i+1)*B/n - 1 (the MPI_Scatter analogue).  With
        ep > 1, [B, ...] -> [n, ep, B/(n ep), ...]: rank (i, e) gets rows
        (i ep + e) B/(n ep) onward.  With sp > 1 the sequence axis splits
        too, its shards stacked after the rank axes: [B, S, ...] -> [n,
        sp, B/n, S/sp, ...] (or [n, ep, sp, B/(n ep), S/sp, ...]), rank
        (i[, e], j) holding its rows' columns j*S/sp .. (j+1)*S/sp - 1."""
        if x.shape[0] % (self.n * self.ep):
            raise ValueError(f"global batch {x.shape[0]} does not split "
                             f"over {self.n * self.ep} ranks")
        x = x.to(self.device)
        lead = (self.n, self.ep) if self.ep > 1 else (self.n,)
        if self.sp == 1:
            return x.reshape(*lead, -1, *x.shape[1:])
        if x.dim() < 2 or x.shape[1] % self.sp:
            raise ValueError(f"a batch leaf of shape {tuple(x.shape)} has "
                             f"no sequence axis that splits over "
                             f"sp={self.sp} ranks")
        B, S = x.shape[:2]
        rows = B // (self.n * self.ep)
        return x.reshape(*lead, rows, self.sp, S // self.sp,
                         *x.shape[2:]).transpose(len(lead),
                                                 len(lead) + 1).contiguous()

    def shard_batch(self, batch: Sequence[torch.Tensor]
                    ) -> Tuple[torch.Tensor, ...]:
        return tuple(self.shard(x) for x in batch)


UNPORTED_AXES = {"tp": "ROADMAP A.5 (the tp axis of parallel/sharded.py)"}


def make_ranks(cfg: MeshConfig, device: DeviceLike = "cuda"
               ) -> VirtualRanks:
    """The dp, sp, ep and pp axes of a MeshConfig as virtual ranks on
    ``device``, or its fsdp axis alone (ZeRO-3, ``parallel.fsdp``: the
    fsdp ranks stacked as the leading dimension, JAX's 1-D fsdp mesh); tp
    is not ported."""
    for name, size in cfg.axis_sizes():
        if name in UNPORTED_AXES and size != 1:
            raise NotImplementedError(
                f"mesh axis {name}={size} is not ported: "
                f"{UNPORTED_AXES[name]}; the port runs dp, sp, ep and pp, "
                "or fsdp")
    if cfg.fsdp != 1:
        if cfg.nproc != cfg.fsdp:
            raise NotImplementedError(
                f"fsdp={cfg.fsdp} with other axes ({cfg}): FSDPTrainer "
                "shards over the fsdp axis alone, as the JAX package's")
        return VirtualRanks(cfg.fsdp, resolve_device(device))
    return VirtualRanks(cfg.dp, resolve_device(device), cfg.sp, cfg.ep,
                        cfg.pp)
