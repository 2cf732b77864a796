"""Input pipeline: host batches onto the virtual ranks with a bounded
prefetch window — the port of the JAX package's ``data.py``
(``ShardedLoader``, ``synthetic_batches`` and ``epochs_of`` with its
native staging path; text comes through ``text.lm_batches``).

``ShardedLoader`` places each host batch on the ranks' device split as the
trainers split it (``VirtualRanks.shard``: ``[B, ...] -> [n, B/n, ...]``,
the per-step MPI_Scatter) and keeps ``prefetch`` batches in flight.  On a
card each batch is copied from pinned host memory with
``non_blocking=True``, so the copies queue behind the step the card is
running, as JAX's ``device_put`` rides its async dispatch.  The host work
that makes a batch (``make_batch``) is not hidden: it runs on the caller's
thread between steps.  Under a process group of W > 1 (one rank a
process) each process places only its own rows of every host batch
(``multihost.process_rows``), as one rank: ``[1, B/W, ...]``.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Callable, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from .parallel import multihost
from .parallel.mesh import CountedBatch, VirtualRanks


class ShardedLoader:
    """An iterable of host batches (tuples of CPU tensors with a leading
    global-batch axis) as an iterator of batches split over ``ranks``
    (``[n, B/n, ...]`` on their device), ``prefetch`` of them in flight;
    under a process group, this process's rows as its one rank."""

    def __init__(self, source: Iterable[Tuple[torch.Tensor, ...]],
                 ranks: VirtualRanks, prefetch: int = 2):
        if prefetch < 1:
            raise ValueError(f"prefetch must be at least 1, got {prefetch}")
        self._source = source
        self._world = multihost.world_size()
        self._ranks = (VirtualRanks(1, ranks.device) if self._world > 1
                       else ranks)
        self._prefetch = prefetch

    def _put(self, batch: Tuple[torch.Tensor, ...]
             ) -> Tuple[torch.Tensor, ...]:
        if self._world > 1:
            batch = multihost.process_rows(batch)
        if self._ranks.device.type != "cuda":
            return self._ranks.shard_batch(batch)
        moved = tuple(x.pin_memory().to(self._ranks.device,
                                        non_blocking=True) for x in batch)
        return self._ranks.shard_batch(CountedBatch(moved) if isinstance(
            batch, CountedBatch) else moved)

    def __iter__(self) -> Iterator[Tuple[torch.Tensor, ...]]:
        window: deque = deque()
        it = iter(self._source)
        for x in it:
            window.append(self._put(x))
            if len(window) == self._prefetch:
                break
        while window:
            out = window.popleft()
            nxt = next(it, None)
            if nxt is not None:
                window.append(self._put(nxt))
            yield out


def synthetic_batches(make_batch: Callable[[np.random.Generator], Any], *,
                      seed: int = 0,
                      num_batches: Optional[int] = None) -> Iterator[Any]:
    """A deterministic stream: ``make_batch(rng)`` on one numpy generator
    seeded with ``seed``, ``num_batches`` times (forever when None)."""
    rng = np.random.default_rng(seed)
    n = 0
    while num_batches is None or n < num_batches:
        yield make_batch(rng)
        n += 1


def _flatten(arrays: Any) -> Tuple[List[Any], Callable[[List[Any]], Any]]:
    """A dict (keys sorted), tuple or list of arrays, or one array, as
    ``(leaves, rebuild)``."""
    if isinstance(arrays, dict):
        keys = sorted(arrays)
        return [arrays[k] for k in keys], lambda ls: dict(zip(keys, ls))
    if isinstance(arrays, (tuple, list)):
        kind = type(arrays)
        return list(arrays), lambda ls: kind(ls)
    return [arrays], lambda ls: ls[0]


def epochs_of(arrays: Any, batch_size: int, *, seed: int = 0,
              epochs: Optional[int] = None, drop_remainder: bool = True,
              native: bool = False) -> Iterator[Any]:
    """Shuffled minibatch epochs over in-memory arrays (a dict, tuple or
    list of numpy arrays, or one, sharing a leading example axis): each
    epoch one ``permutation`` of numpy's generator seeded with ``seed``,
    cut into ``batch_size`` rows (the last partial batch dropped unless
    ``drop_remainder=False``), so the index stream is the JAX package's.
    Batches are numpy arrays in the input's structure.

    ``native=True`` gathers the rows through the C++ staging engine
    (``runtime.staging``): the next batch stages on a team of threads while
    the caller consumes this one.  It needs ``drop_remainder`` (fixed
    slot sizes) and raises when the library cannot be built; it never
    falls back to numpy.  Its leaves are owned copies out of the pool."""
    leaves, rebuild = _flatten(arrays)
    leaves = [np.asarray(x) for x in leaves]
    n = leaves[0].shape[0]
    if any(x.shape[0] != n for x in leaves):
        raise ValueError("ragged leading axis")
    rng = np.random.default_rng(seed)
    if native:
        if not drop_remainder:
            raise ValueError("native staging needs drop_remainder=True "
                             "(its slots have one size)")
        yield from _epochs_native(leaves, rebuild, n, batch_size, rng,
                                  epochs)
        return
    e = 0
    while epochs is None or e < epochs:
        order = rng.permutation(n)
        stop = (n // batch_size) * batch_size if drop_remainder else n
        for lo in range(0, stop, batch_size):
            idx = order[lo:lo + batch_size]
            yield rebuild([x[idx] for x in leaves])
        e += 1


def _epochs_native(leaves: List[np.ndarray], rebuild, n: int,
                   batch_size: int, rng: np.random.Generator,
                   epochs: Optional[int]) -> Iterator[Any]:
    """Double-buffered native staging: batch k+1's gathers are submitted
    before batch k is yielded.  One pool, two right-sized slots a leaf."""
    from .runtime.staging import Stager
    np_leaves = [np.ascontiguousarray(x) for x in leaves]
    leaf_bytes = [batch_size * x.dtype.itemsize
                  * int(np.prod(x.shape[1:], dtype=np.int64))
                  for x in np_leaves]
    pool = Stager.sized(sorted(leaf_bytes * 2))
    try:
        def submit(idx):
            return [pool.submit(x, idx) for x in np_leaves]

        def materialize(slots):
            # copied out of the pool: closing the generator frees the
            # native buffers, so a yielded view would dangle
            out = [np.array(pool.wait(s)) for s in slots]
            for s in slots:
                pool.release(s)
            return rebuild(out)

        def index_stream():
            e = 0
            while epochs is None or e < epochs:
                order = rng.permutation(n)
                for lo in range(0, (n // batch_size) * batch_size,
                                batch_size):
                    yield order[lo:lo + batch_size]
                e += 1

        pending = None
        for idx in index_stream():
            slots = submit(idx)
            if pending is not None:
                yield materialize(pending)
            pending = slots
        if pending is not None:
            yield materialize(pending)
    finally:
        pool.close()
