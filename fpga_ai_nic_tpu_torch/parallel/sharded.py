"""ZeRO-1 sharded trainer over virtual ranks — the port of the JAX
package's ``parallel/sharded.py`` (``ShardedTrainer``) for its dp and sp
axes.

The JAX step, phase by phase (``sharded.py`` ``step_fn``):

  1. per-rank gradients of ``loss_fn`` (``parallel.train.per_rank_grads``,
     the loop ``DPTrainer.grads`` runs);
  2. ``fused_update.reduce_scatter(flat_g) / n`` — with
     ``fused_kernel=True`` on the card, the BFP ring kernels;
  3. ``optim.clip_by_global_norm`` when ``clip_norm`` is set;
  4. ``optim.apply`` on each rank's owned f32 master shard;
  5. ``fused_update.all_gather_flat`` of the updated masters into every
     rank's replica, cast to the model dtype for the next step.

With sp > 1 (``MeshConfig(dp, sp)``) the batch shards as JAX's ``P(dp,
sp)`` (``VirtualRanks.shard``) and each dp rank's loss takes its n_sp
sequence shards stacked (a loss closed over ``sp_axis``, e.g.
``llama.loss_fn(..., sp_axis="sp")``): one graph over the shards, so
autograd sums the sp ranks' contributions to the replicated weights, as
JAX's varying-axes transposes psum them over sp.  The dp phases then run
once per dp rank; JAX runs them once per (dp, sp) device on identical
inputs, with the same result.

As in the JAX package the fused optimizer kernel is not used: the update
is ``optim.apply`` between the two collectives.  Other mesh axes (tp,
pp, ep, fsdp), ``loss_and_grads_fn`` (the 1F1B schedule) and
``accum_steps > 1`` raise ``NotImplementedError``; ``integrity_check``
raises ``ValueError``, as the JAX package's does (it is DPTrainer's).
The state is ``parallel.train.TrainState``; ``step`` drops the flat
gradients before the update, so at full width they never coexist with
the gathered replicas.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from .mesh import VirtualRanks
from .train import DPTrainer, TrainState
from ..ops import fused_update
from ..utils.config import TrainConfig


class ShardedTrainer(DPTrainer):
    """``loss_fn(params, batch) -> scalar`` over n virtual dp ranks (each
    holding ``ranks.sp`` sequence shards); a batch is a tuple of tensors
    with a leading global-batch axis (and, with sp, a sequence axis),
    split over the ranks by ``shard_batch``."""

    takes_sp = True

    def __init__(self, loss_fn: Callable, ranks: VirtualRanks,
                 cfg: TrainConfig, *,
                 loss_and_grads_fn: Optional[Callable] = None):
        for name, size in cfg.mesh.axis_sizes():
            if name not in ("dp", "sp") and size != 1:
                raise NotImplementedError(
                    f"mesh axis {name}={size} is not ported: ShardedTrainer "
                    "runs the dp and sp axes")
        if loss_and_grads_fn is not None:
            raise NotImplementedError(
                "loss_and_grads_fn (explicit-gradient schedules such as the "
                "1F1B pipeline) is not ported: ROADMAP A.6")
        if cfg.accum_steps != 1:
            raise NotImplementedError(
                "accum_steps > 1 is not ported: ROADMAP A.1")
        if cfg.collective.integrity_check:
            raise ValueError(
                "integrity_check is implemented on DPTrainer only (both "
                "value and exact wire tiers ride its step diag); "
                "ShardedTrainer's dp reduce/gather do not thread the "
                "verdicts, and a silently ignored flag would be "
                "claimed-but-absent coverage: construct with "
                "integrity_check=False")
        super().__init__(loss_fn, ranks, cfg)
        # as in the JAX package, this trainer carries no error-feedback
        # residual: a codec's error_feedback flag is not read here
        self._ef = False

    def apply_grads(self, state: TrainState, flat_g: torch.Tensor,
                    codec_state: Optional[torch.Tensor] = None
                    ) -> TrainState:
        """Phases 2-5 on given per-rank gradients ``[n, L_pad]``."""
        return self.update(state, self._reduce(flat_g))

    def _reduce(self, flat_g: torch.Tensor) -> torch.Tensor:
        return fused_update.reduce_scatter(flat_g, self.cfg.collective) / self.n

    def step(self, state: TrainState, batch
             ) -> Tuple[TrainState, torch.Tensor]:
        flat_g, loss = self.grads(state, batch)
        held = [self._reduce(flat_g)]
        del flat_g
        # pop: update() holds the only reference and frees the reduced
        # gradient before the all-gather allocates the new replicas
        return self.update(state, held.pop()), loss
