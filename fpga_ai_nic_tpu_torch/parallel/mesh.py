"""Virtual ranks on one card — what stands in for the JAX package's dp,
fsdp, tp, sp, ep and pp mesh axes (``parallel/mesh.py``).

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

A tp axis (tensor parallelism, Megatron's column/row split) does not
split the batch either (JAX's ``_bspec`` never names tp): the tp ranks
of a dp rank see the same batch shard and each holds its own slice of
the weights, one parameter row a (tp, dp) rank, tp major
(``P((tp, pp, ep, dp))``, JAX's ``_waxes``).  Which dimension of a leaf
splits over which axis is its ``Spec``.  With pp too, a (tp, pp, dp)
rank holds its tp rank's slice of its stage (Megatron's 3-D layout).

An fsdp axis (ZeRO-3, ``parallel.fsdp.FSDPTrainer``) runs alone, as JAX's
FSDPTrainer shards over its fsdp axis only: its ranks are stacked as the
leading dimension and split the batch as dp ranks do.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple, Union

import torch

from ..device import DeviceLike, resolve_device
from ..utils.config import MeshConfig


class Spec:
    """Which mesh axis each dimension of a parameter leaf splits over —
    JAX's ``PartitionSpec`` for the port's parameter trees: ``Spec(None,
    "tp")`` splits dimension 1 over tp (a column-parallel weight),
    ``Spec("ep", None, "tp")`` dimension 0 over ep and 2 over tp.  A spec
    tree's leaf is a Spec, None (replicated) or the shorthand string of
    the leading dimensions' axes (``"ep"``, ``"pp"``, ``"pp,ep"``:
    ``Spec("pp", "ep")``); a Spec is one leaf of the tree walk (not a
    tuple, which the walk would enter)."""

    __slots__ = ("dims",)

    def __init__(self, *dims: Optional[str]) -> None:
        self.dims = tuple(dims)

    def __eq__(self, other) -> bool:
        return isinstance(other, Spec) and spec_dims(other) == spec_dims(
            self)

    def __hash__(self) -> int:
        return hash(spec_dims(self))

    def __repr__(self) -> str:
        return f"Spec{self.dims!r}"


SpecLike = Union[None, str, Spec]


def spec_dims(spec: SpecLike) -> Tuple[Optional[str], ...]:
    """A spec as one axis (or None) a leading dimension, trailing Nones
    dropped: None -> (), ``"pp,ep"`` -> ("pp", "ep"), ``Spec(None, "tp",
    None)`` -> (None, "tp")."""
    if spec is None:
        return ()
    dims = (tuple(spec.split(",")) if isinstance(spec, str)
            else spec.dims)
    while dims and dims[-1] is None:
        dims = dims[:-1]
    return dims


@dataclass(frozen=True)
class VirtualRanks:
    """n data-parallel ranks stacked on one device, each holding ``ep``
    expert-parallel ranks, each of those ``sp`` sequence shards; each
    rank's model split over ``pp`` pipeline stages and ``tp`` tensor
    ranks."""

    n: int
    device: torch.device
    sp: int = 1
    ep: int = 1
    pp: int = 1
    tp: int = 1

    def __post_init__(self) -> None:
        if min(self.n, self.sp, self.ep, self.pp, self.tp) < 1:
            raise ValueError(f"need at least one rank, got dp={self.n}, "
                             f"sp={self.sp}, ep={self.ep}, pp={self.pp}, "
                             f"tp={self.tp}")

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

    def shard_count(self, x: torch.Tensor) -> torch.Tensor:
        """A per-rank count leaf, ``[n a]`` int64
        (``models.bert.with_global_count``: dp rank i's a entries, the
        global label count of each microbatch) -> ``[n, a]``, or ``[n, ep,
        a]`` with ep: it replicates over the ep ranks and the sp shards of
        its dp rank, as JAX's psum of the count over the batch axes leaves
        the same global count on every device, while each shard's labels
        are still counted against it."""
        if x.shape[0] % self.n:
            raise ValueError(f"a count leaf of {x.shape[0]} entries does "
                             f"not split over {self.n} dp ranks")
        x = x.to(self.device).reshape(self.n, -1)
        if self.ep > 1:
            x = x[:, None].expand(self.n, self.ep, x.shape[1]).contiguous()
        return x

    def shard_batch(self, batch: Sequence[torch.Tensor]
                    ) -> Tuple[torch.Tensor, ...]:
        """Each leaf through ``shard``, the last leaf of a
        ``CountedBatch`` through ``shard_count``."""
        if isinstance(batch, CountedBatch):
            *leaves, count = batch
            return tuple(self.shard(x) for x in leaves) + (
                self.shard_count(count),)
        return tuple(self.shard(x) for x in batch)


class CountedBatch(tuple):
    """A global batch whose last leaf is its per-rank label count
    (``models.bert.with_global_count``), which ``shard_batch`` lays out by
    ``shard_count``: that leaf has no rows of its own to split."""


def make_ranks(cfg: MeshConfig, device: DeviceLike = "cuda"
               ) -> VirtualRanks:
    """The dp, tp, sp, ep and pp axes of a MeshConfig as virtual ranks on
    ``device``, or its fsdp axis alone (ZeRO-3, ``parallel.fsdp``: the
    fsdp ranks stacked as the leading dimension, JAX's 1-D fsdp mesh)."""
    if cfg.fsdp != 1:
        if cfg.nproc != cfg.fsdp:
            raise NotImplementedError(
                f"fsdp={cfg.fsdp} with other axes ({cfg}): FSDPTrainer "
                "shards over the fsdp axis alone, as the JAX package's")
        return VirtualRanks(cfg.fsdp, resolve_device(device))
    return VirtualRanks(cfg.dp, resolve_device(device), cfg.sp, cfg.ep,
                        cfg.pp, cfg.tp)
