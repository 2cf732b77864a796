"""Bucketed gradient all-reduce — the port of the JAX package's
``ops/bucketed.py``: the reference's per-layer collective issue
(sw/mlp_mpi_example_f32.cpp:753-756), in buckets.

Leaves are walked in reverse tree order (the order their gradients appear
in the backward) and grouped until a bucket holds ``bucket_elems``
elements; each bucket is one f32 vector, zero-padded so that every rank's
chunk is whole codec units (``fused_update.pad_multiple``).  Over the n
virtual ranks a bucket is an ``[n, padded_len]`` tensor, one row a rank:
each gradient leaf is copied once, straight into its rank's row of its
bucket (``bucket_locals``), and each bucket is reduced by one collective
(``fused_update.ring_all_reduce_routed``: the fused BFP ring kernels with
``fused_kernel``, or a sum over the rows for ``impl="xla"``).  Everything
stays f32 from the copy to the update (``all_reduce_bucketed_flat``), as
the JAX function keeps a bf16 model's dp-mean out of the leaf dtype.
Reductions run one bucket after the other, after the backward
(``parallel.ddp``), or one issue a bucket through the explicit queue
(``parallel.queued``, ``runtime.queue``).
"""

from __future__ import annotations

from typing import Iterable, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from . import fused_update
from .fused_update import Path
from ..utils.config import CollectiveConfig


class Bucket(NamedTuple):
    leaf_ids: Tuple[int, ...]    # indices into the tree's leaves, in the
                                 # reverse (issue) order they are packed in
    sizes: Tuple[int, ...]       # flat sizes of those leaves
    padded_len: int              # bucket vector length after padding


class BucketPlan(NamedTuple):
    keys: Tuple[Path, ...]       # leaf paths, forward tree order
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[torch.dtype, ...]
    buckets: Tuple[Bucket, ...]  # in issue (reverse-leaf) order


def plan_buckets(tree, coll: CollectiveConfig, n: int) -> BucketPlan:
    """Static bucket assignment of a parameter tree (tensors or numpy
    arrays; shapes and dtypes only): leaves in reverse tree order, a
    bucket closed once it holds at least ``coll.bucket_elems`` elements,
    each padded to ``fused_update.pad_multiple(coll, n)``."""
    meta = fused_update.flat_meta(tree, coll, n)
    m = fused_update.pad_multiple(coll, n)
    buckets: List[Bucket] = []
    cur: List[int] = []
    cur_n = 0

    def close() -> None:
        buckets.append(Bucket(tuple(cur), tuple(meta.sizes[j] for j in cur),
                              cur_n + (-cur_n) % m))

    for i in reversed(range(len(meta.sizes))):
        cur.append(i)
        cur_n += meta.sizes[i]
        if cur_n >= coll.bucket_elems:
            close()
            cur, cur_n = [], 0
    if cur:
        close()
    return BucketPlan(meta.keys, meta.shapes, meta.dtypes, tuple(buckets))


def bucket_rows(plan: BucketPlan, n: int, device) -> List[torch.Tensor]:
    """Empty per-bucket gradient rows, ``[n, padded_len]`` f32 each, the
    padding already zero."""
    rows = []
    for b in plan.buckets:
        r = torch.empty((n, b.padded_len), dtype=torch.float32,
                        device=device)
        r[:, sum(b.sizes):] = 0
        rows.append(r)
    return rows


def bucket_locals(leaves: Sequence[torch.Tensor], plan: BucketPlan,
                  out: Sequence[torch.Tensor], add: bool = False) -> None:
    """One rank's gradient leaves (forward tree order) -> its rows of
    ``bucket_rows`` (``out``, in issue order): each leaf copied once into
    its place, or with ``add`` added to it in f32 (accumulation)."""
    for b, vec in zip(plan.buckets, out):
        off = 0
        for i, size in zip(b.leaf_ids, b.sizes):
            dst = vec[off:off + size]
            if add:
                dst.add_(leaves[i].reshape(-1))
            else:
                dst.copy_(leaves[i].reshape(-1))
            off += size


def assemble_flat(bucket_vecs: Iterable[torch.Tensor], plan: BucketPlan,
                  div: int = 1) -> torch.Tensor:
    """Inverse of ``bucket_locals`` into the forward flat layout: bucket
    vectors ``[..., padded_len]`` in issue order (any iterable: each is
    dropped once placed) -> one f32 ``[..., L]`` in forward leaf order,
    padding dropped (the layout of ``fused_update.flatten_tree`` with no
    padding), every element divided by ``div`` in the same copy."""
    sizes = [int(np.prod(s)) if s else 1 for s in plan.shapes]
    offs = np.cumsum([0] + sizes[:-1]).tolist()
    flat = None
    for b, red in zip(plan.buckets, bucket_vecs):
        if flat is None:
            flat = torch.empty(tuple(red.shape[:-1]) + (sum(sizes),),
                               dtype=torch.float32, device=red.device)
        off = 0
        for i, size in zip(b.leaf_ids, b.sizes):
            torch.div(red[..., off:off + size], div,
                      out=flat[..., offs[i]:offs[i] + size])
            off += size
    return flat


def reduce_bucket(rows: torch.Tensor, coll: CollectiveConfig
                  ) -> torch.Tensor:
    """One bucket's sum: ``[n, padded_len]`` per-rank rows -> the same
    shape, every row the sum over the rows (a plain sum for
    ``impl="xla"``, the routed ring otherwise)."""
    if coll.impl == "xla":
        return rows.sum(dim=0, keepdim=True).expand(rows.shape[0], -1)
    return fused_update.ring_all_reduce_routed(rows, coll)


def all_reduce_bucketed_flat(rows: List[torch.Tensor],
                             coll: CollectiveConfig,
                             plan: BucketPlan) -> torch.Tensor:
    """Bucketed mean all-reduce of the per-rank bucket rows (``rows``, as
    ``bucket_rows`` made them, in issue order), assembled into the forward
    flat f32 layout ``[n, L]``: ``assemble_flat`` of every
    ``reduce_bucket``, one bucket at a time, divided by n on the way.
    ``rows`` is consumed (each bucket is released once it is reduced and
    placed).  Never rounded to a leaf dtype."""
    n = rows[0].shape[0]
    return assemble_flat((reduce_bucket(rows.pop(0), coll)
                          for _ in plan.buckets), plan, div=n)


def bucket_wire_bytes(plan: BucketPlan, n: int,
                      coll: CollectiveConfig) -> int:
    """Per-rank ring bytes of one bucketed all-reduce (the flit-counter
    arithmetic of ``fused_update.wire_bytes_for``, summed over buckets)."""
    return sum(fused_update.wire_bytes_for(coll, b.padded_len, n)
               for b in plan.buckets)
