"""The queued DDP trainer — the port of the JAX package's
``parallel/queued.py`` (``QueuedDDPTrainer``): the reference's host-driven
step, the backward's per-bucket gradient rows issued one collective a
bucket through a bounded window (``runtime.queue.CollectiveQueue``),
then waited for, then the optimizer.

    grads   : the ranks' backward into the bucket rows (``DDPTrainer.grads``,
              with accumulation)
    issue   : one mean all-reduce a bucket (``ops.bucketed.reduce_bucket``
              -> ``fused_update.ring_all_reduce_routed``, divided by n),
              on the queue's side stream on a card
    wait    : every ticket, in issue order, each mean placed in the
              forward flat layout (``bucketed.assemble_flat``)
    update  : every rank's replicated optimizer (``DDPTrainer.update``)

Same state and numerics as ``DDPTrainer``: the same bucket plan, add
order, codec and division, so the masters are bit-equal.  The buckets are
issued after the backward, as JAX's are.  Unlike JAX's, the collective
keeps the configured route: with ``fused_kernel`` the fused BFP ring
kernels carry each bucket, as they do in ``DDPTrainer`` (JAX pins its
separate-op ring here for its wire-byte lint; the per-bucket wire
counters below are the same either way).  Each bucket's declared wire
and raw bytes ride its ticket into ``profiler.collectives``, and the
first step lands one ``bucket<i>.compression_ratio`` counter a bucket in
``profiler.events``.  With ``obs_metrics`` the step's loss is delivered to
the active sink on the host (``obs.metrics.host_observe``), as JAX's is.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from . import multihost
from .ddp import DDPState, DDPTrainer
from .mesh import VirtualRanks
from ..obs import metrics as obs_metrics
from ..ops import bucketed, fused_update
from ..runtime.queue import CollectiveQueue
from ..utils.config import TrainConfig
from ..utils.observability import Profiler


class QueuedDDPTrainer(DDPTrainer):
    """``loss_fn(params, batch) -> scalar`` (or a ``joint_ranks`` loss), as
    ``DDPTrainer``; ``2 + n_buckets`` phases a step through a
    ``CollectiveQueue`` instead of one call after another."""

    def __init__(self, loss_fn: Callable, ranks: VirtualRanks,
                 cfg: TrainConfig, profiler: Optional[Profiler] = None):
        multihost.refuse_processes("QueuedDDPTrainer")
        super().__init__(loss_fn, ranks, cfg)
        self.profiler = profiler or Profiler()
        self.queue = CollectiveQueue(self.reduce_fn, cfg.collective,
                                     self.profiler)
        self._bucket_telemetry_done = False

    def reduce_fn(self, rows: torch.Tensor) -> torch.Tensor:
        """The collective the queue issues: one bucket's mean all-reduce,
        ``[n, padded_len]`` rows -> every row their mean."""
        return bucketed.reduce_bucket(rows, self.cfg.collective) / self.n

    def step(self, state: DDPState, batch) -> Tuple[DDPState, torch.Tensor]:
        coll, n = self.cfg.collective, self.n
        with self.profiler.bucket("grads"):
            rows, loss = self.grads(state, batch)
        plan = self.plan
        tickets = []
        with self.profiler.bucket("issue"):
            for i, b in enumerate(plan.buckets):
                raw = fused_update.wire_bytes_for(coll, b.padded_len, n,
                                                  codec=None)
                wire = fused_update.wire_bytes_for(coll, b.padded_len, n)
                if not self._bucket_telemetry_done:
                    # named a bucket: the stream summary keeps the latest
                    # value a name
                    self.profiler.events.counter(
                        f"bucket{i}.compression_ratio", raw / wire,
                        bucket=i, padded_len=b.padded_len,
                        wire_bytes=wire, raw_bytes=raw)
                tickets.append(self.queue.issue(rows.pop(0), raw_bytes=raw,
                                                wire_bytes=wire))
            self._bucket_telemetry_done = True

        def means():
            # each ticket dropped once waited for, so each bucket's mean
            # is freed once placed
            while tickets:
                yield self.queue.wait(tickets.pop(0))

        with self.profiler.bucket("update"):
            new = self.update(state, bucketed.assemble_flat(means(), plan))
        if self.cfg.obs_metrics:
            # delivered on the host: the queue has waited for every
            # bucket, and the loss was computed before them
            obs_metrics.host_observe({"loss": float(loss)})
        return new, loss


__all__ = ["QueuedDDPTrainer"]
