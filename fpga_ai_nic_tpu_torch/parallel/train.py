"""Data-parallel training with the fused scatter-update-gather collective —
the port of the JAX package's ``parallel/train.py`` (``DPTrainer``).

Each virtual rank runs forward and backward on its batch shard with its own
replica of the working weights; the flat gradients ``[n, L_pad]`` then go
through the two phases of the JAX ``step_fn``:

  phase 1: ``fused_update.reduce_scatter_update`` — ring reduce-scatter
    (BFP on every hop) with the ZeRO-1 optimizer update of each rank's
    owned master shard on the final hop;
  phase 2: ``fused_update.all_gather_flat`` — ring all-gather of the
    updated masters into every rank's replica.

The loss is the mean of the per-rank losses.  ``step`` = ``grads`` then
``apply_grads``; the two halves are public so a caller can run the same
gradients through another collective (``chip_smoke.py`` does).  Nothing is
updated in place: a step returns a new TrainState.
"""

from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Tuple

import torch

from .mesh import VirtualRanks
from .. import optim
from ..ops import fused_update
from ..utils.config import TrainConfig

Params = Any


class TrainState(NamedTuple):
    params: Params              # rank 0's working weights (views of replicas)
    replicas: torch.Tensor      # [n, L_pad] every rank's working weights
    w_own: torch.Tensor         # [n, C] f32 master shards (ZeRO-1)
    opt_state: optim.OptState   # {key: [n, C]} optimizer state shards
    step: int


class DPTrainer:
    """Per-rank gradients + fused collective over n virtual ranks.

    ``loss_fn(params, batch) -> scalar``; a batch is a tuple of tensors
    with a leading global-batch axis, split over the ranks by
    ``shard_batch``."""

    def __init__(self, loss_fn: Callable, ranks: VirtualRanks,
                 cfg: TrainConfig):
        if cfg.mesh.nproc != ranks.n or cfg.mesh.dp != ranks.n:
            raise ValueError(f"cfg.mesh ({cfg.mesh}) does not describe "
                             f"{ranks.n} dp ranks")
        coll = cfg.collective
        for name, unported in (
                ("collective.integrity_check", coll.integrity_check),
                ("obs_metrics", cfg.obs_metrics),
                ("accum_steps > 1", cfg.accum_steps != 1),
                ("adapt.enabled", cfg.adapt.enabled)):
            if unported:
                raise NotImplementedError(f"{name} is not ported")
        codec = fused_update.resolve_codec(coll)
        if coll.impl == "ring" and codec is not None and codec.error_feedback:
            raise NotImplementedError("error-feedback codecs are not ported")
        if coll.fused_optimizer and cfg.optimizer.clip_norm is not None:
            raise ValueError(
                "fused_optimizer cannot honor clip_norm: a global-norm clip "
                "needs a barrier between the reduce-scatter and the update")
        self.loss_fn = loss_fn
        self.ranks = ranks
        self.n = ranks.n
        self.cfg = cfg
        self._meta = None

    # -- init -----------------------------------------------------------------

    def init_state(self, params: Params) -> TrainState:
        """Split replicated params into the ranks' master shards; every
        rank starts from the given weights as they are."""
        coll, opt_cfg = self.cfg.collective, self.cfg.optimizer
        params = {k: [t.to(self.ranks.device) for t in v]
                  for k, v in params.items()}
        w_own, opt_state, meta = fused_update.init_master_shard(
            params, coll, opt_cfg, self.n)
        self._meta = meta
        replicas = w_own.reshape(1, -1).expand(self.n, -1)
        return TrainState(fused_update.unflatten_tree(replicas[0], meta),
                          replicas, w_own, opt_state, 0)

    def shard_batch(self, batch) -> Tuple[torch.Tensor, ...]:
        """[B, ...] host tensors -> [n, B/n, ...] on the ranks' device."""
        return self.ranks.shard_batch(batch)

    # -- step -----------------------------------------------------------------

    def grads(self, state: TrainState, batch
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-rank backward: ``(flat_g [n, L_pad], mean loss)``.  Rank i
        differentiates ``loss_fn`` at its own replica on its own shard."""
        meta = self._meta
        if meta is None:
            raise RuntimeError("call init_state first")
        flat_g = torch.empty((self.n, meta.padded_len), dtype=torch.float32,
                             device=state.w_own.device)
        total = sum(meta.sizes)
        losses: List[torch.Tensor] = []
        for i in range(self.n):
            tree = fused_update.unflatten_tree(state.replicas[i], meta)
            leaves = [t.detach().requires_grad_()
                      for k in sorted(tree) for t in tree[k]]
            it = iter(leaves)
            params_i = {k: [next(it) for _ in tree[k]] for k in sorted(tree)}
            loss = self.loss_fn(params_i, tuple(b[i] for b in batch))
            gs = torch.autograd.grad(loss, leaves)
            torch.cat([g.reshape(-1).to(torch.float32) for g in gs],
                      out=flat_g[i, :total])
            losses.append(loss.detach())
        flat_g[:, total:] = 0
        return flat_g, torch.stack(losses).mean()

    def apply_grads(self, state: TrainState, flat_g: torch.Tensor
                    ) -> TrainState:
        """Phase 1 (reduce-scatter + update) and phase 2 (all-gather)."""
        coll, opt_cfg = self.cfg.collective, self.cfg.optimizer
        if coll.fused_optimizer:
            _, w_new, opt_state = fused_update.reduce_scatter_update(
                flat_g, state.w_own, state.opt_state, state.step, coll,
                opt_cfg)
        else:
            g_own = fused_update.reduce_scatter(flat_g, coll) / self.n
            g_own = optim.clip_by_global_norm(opt_cfg, g_own)
            w_new, opt_state = optim.apply(opt_cfg, state.w_own, g_own,
                                           state.opt_state, state.step)
        replicas = fused_update.all_gather_flat(w_new, coll)
        return TrainState(fused_update.unflatten_tree(replicas[0],
                                                      self._meta),
                          replicas, w_new, opt_state, state.step + 1)

    def step(self, state: TrainState, batch
             ) -> Tuple[TrainState, torch.Tensor]:
        flat_g, loss = self.grads(state, batch)
        return self.apply_grads(state, flat_g), loss

    # -- restore --------------------------------------------------------------

    def params_from_master(self, w_own: torch.Tensor) -> Params:
        """Working params rebuilt from the master shards by the step's own
        gather phase."""
        if self._meta is None:
            raise RuntimeError("call init_state first")
        replicas = fused_update.all_gather_flat(w_own, self.cfg.collective)
        return fused_update.unflatten_tree(replicas[0], self._meta)
