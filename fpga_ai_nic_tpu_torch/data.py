"""Input pipeline: host batches onto the virtual ranks with a bounded
prefetch window — the port of the JAX package's ``data.py``
(``synthetic_batches`` and ``ShardedLoader``; ``epochs_of``, the native
path, ``text.py`` and ``parallel/accum.py`` are ROADMAP A.1).

``ShardedLoader`` places each host batch on the ranks' device split as the
trainers split it (``VirtualRanks.shard``: ``[B, ...] -> [n, B/n, ...]``,
the per-step MPI_Scatter) and keeps ``prefetch`` batches in flight.  On a
card each batch is copied from pinned host memory with
``non_blocking=True``, so the copies queue behind the step the card is
running, as JAX's ``device_put`` rides its async dispatch.  The host work
that makes a batch (``make_batch``) is not hidden: it runs on the caller's
thread between steps.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Callable, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from .parallel.mesh import VirtualRanks


class ShardedLoader:
    """An iterable of host batches (tuples of CPU tensors with a leading
    global-batch axis) as an iterator of batches split over ``ranks``
    (``[n, B/n, ...]`` on their device), ``prefetch`` of them in flight."""

    def __init__(self, source: Iterable[Tuple[torch.Tensor, ...]],
                 ranks: VirtualRanks, prefetch: int = 2):
        if prefetch < 1:
            raise ValueError(f"prefetch must be at least 1, got {prefetch}")
        self._source = source
        self._ranks = ranks
        self._prefetch = prefetch

    def _put(self, batch: Tuple[torch.Tensor, ...]
             ) -> Tuple[torch.Tensor, ...]:
        if self._ranks.device.type != "cuda":
            return self._ranks.shard_batch(batch)
        return self._ranks.shard_batch(tuple(
            x.pin_memory().to(self._ranks.device, non_blocking=True)
            for x in batch))

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
