"""ZeRO-1 sharded trainer over virtual ranks — the port of the JAX
package's ``parallel/sharded.py`` (``ShardedTrainer``) for its dp, sp, ep
and pp axes.

The JAX step, phase by phase (``sharded.py`` ``step_fn``):

  1. per-rank gradients of ``loss_fn`` (``parallel.train.rank_grads``,
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

With ep > 1 (``MeshConfig(dp, ep=...)``, ``param_specs`` naming the
leaves that shard over ep, e.g. ``llama.param_specs``) the state is JAX's
master layout ``P((ep, dp))``: one flat row a (dp, ep) rank, row ``e n_dp
+ d``, holding the replicated leaves and ep rank e's expert shard; the
batch shards as ``P((dp, ep))`` and the loss runs over every rank at once
(``joint_ranks``, ``llama.dp_loss_fn``).  After the backward each
replicated leaf's gradient is summed over the ep ranks of its dp rank
and written into every ep row (JAX's varying-axes psum over ep); the
dp phases 2-5 then run within each ep group (rows ``e n_dp`` to ``(e + 1)
n_dp - 1``), one reduce-scatter and one all-gather a group, so the BFP
codec quantizes the blocks of JAX's layout.  ``clip_norm`` with ep takes
the global norm over every row's owned shard with JAX's norm weights
(``norm_weight_tables``: a replicated leaf 1/ep a copy, an expert shard
1, the padding 0), so each parameter counts once.  With sp and ep
together (``MeshConfig(dp, sp, ep)``) the batch is ``[n_dp, n_ep, n_sp,
B, S_local]`` and the joint loss runs each (dp, ep) rank's sp ring
(``llama.dp_loss_fn(..., n_sp=)``): the one backward sums a rank's sp
shards (JAX's psum over sp), then the ep sum and the dp phases as above.

With pp > 1 (``MeshConfig(dp, pp=...)``, ``param_specs`` naming the
stacked layer leaves that split over pp, ``llama.stacked_param_specs``)
the layout is JAX's ``P((pp, dp))``: one flat row a (pp, dp) rank, row
``s n_dp + d``, holding stage s's layer slice and its copy of the
replicated leaves (embedding, final norm, head), so the BFP blocks on
the wire are JAX's.  The loss takes one dp rank's stage trees at once
(``loss_fn(stage_params, batch)``, e.g. ``llama.loss_fn_pp``), a dp rank
at a time, and autograd differentiates the whole pipeline; each stage's
gradient goes into its row and the replicated leaves' are summed over
the stages (the embedding's come from stage 0, the head's from the
last: JAX's psum over pp).  ``loss_and_grads_fn(stage_params, batch,
out=...) -> (loss, grads)`` (the 1F1B schedules,
``llama.loss_and_grads_pp_1f1b``) writes its gradients, the replicated
leaves' already summed, into ``out``, the stages' f32 rows.  The dp
phases then run within each stage group, as within an ep group;
``clip_norm`` counts a replicated leaf 1/pp a copy.

As in the JAX package the fused optimizer kernel is not used: the update
is ``optim.apply`` between the two collectives.  Other mesh axes (tp,
fsdp) and ``accum_steps > 1`` raise ``NotImplementedError``;
``loss_and_grads_fn`` with ``accum_steps > 1`` and ``integrity_check``
raise ``ValueError``, as the JAX package's do (the latter is
DPTrainer's).  The state is ``parallel.train.TrainState``; ``step``
drops the flat gradients before the update, so at full width they never
coexist with the gathered replicas.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from .mesh import UNPORTED_AXES, VirtualRanks
from .train import DPTrainer, Params, TrainState, _rank_leaves
from .. import optim
from ..ops import fused_update
from ..utils.config import TrainConfig


def split_ep(params: Params, specs: Any, n_ep: int) -> List[Params]:
    """The whole tree as the n_ep ranks' local trees: a leaf whose spec is
    set (``"ep"``, or ``"pp"`` for a stacked layer leaf) split on its
    leading axis (rank e's chunk, a view), the others shared."""
    pairs = fused_update._leaves(params)
    paths = tuple(p for p, _ in pairs)
    flags = [s is not None for s in fused_update.tree_leaves(specs)]
    if len(flags) != len(pairs):
        raise ValueError("param_specs does not match the params tree")
    return [fused_update.tree_from_leaves(paths, [
        leaf.chunk(n_ep)[e] if sharded else leaf
        for (_, leaf), sharded in zip(pairs, flags)]) for e in range(n_ep)]


def join_ep(trees: List[Params], specs: Any) -> Params:
    """Inverse of ``split_ep``: the sharded leaves concatenated, the
    others rank 0's."""
    pairs = fused_update._leaves(trees[0])
    leaves = zip(*(fused_update.tree_leaves(t) for t in trees))
    return fused_update.tree_from_leaves(tuple(p for p, _ in pairs), [
        torch.cat(ls) if s is not None else ls[0]
        for ls, s in zip(leaves, fused_update.tree_leaves(specs))])


class ShardedTrainer(DPTrainer):
    """``loss_fn(params, batch) -> scalar`` over n virtual dp ranks (each
    holding ``ranks.sp`` sequence shards), or a loss marked
    ``joint_ranks`` over all n x ``ranks.ep`` ranks, or with pp > 1 a loss
    over one dp rank's ``ranks.pp`` stage trees (or
    ``loss_and_grads_fn``); a batch is a tuple of tensors with a leading
    global-batch axis (and, with sp, a sequence axis), split over the
    ranks by ``shard_batch``.  ``param_specs``: a tree of the params'
    structure, ``"ep"`` (``"pp"``) at each leaf split over ep (pp) on its
    leading axis and None at each replicated leaf (needed with ep or pp
    > 1)."""

    takes_sp = True

    def __init__(self, loss_fn: Optional[Callable], ranks: VirtualRanks,
                 cfg: TrainConfig, *, param_specs: Any = None,
                 loss_and_grads_fn: Optional[Callable] = None):
        if loss_and_grads_fn is not None and cfg.accum_steps > 1:
            raise ValueError(
                "loss_and_grads_fn (explicit-gradient schedule) does not "
                "compose with accum_steps > 1 — fold accumulation into "
                "the schedule's num_microbatches instead")
        for name, size in cfg.mesh.axis_sizes():
            if name not in ("dp", "sp", "ep", "pp") and size != 1:
                raise NotImplementedError(
                    f"mesh axis {name}={size} is not ported: "
                    f"{UNPORTED_AXES[name]}; ShardedTrainer runs the dp, "
                    "sp, ep and pp axes")
        if loss_and_grads_fn is not None and ranks.pp == 1:
            raise NotImplementedError(
                "loss_and_grads_fn without pp is not ported: the port's "
                "takes the pp stages (the 1F1B schedules, pp > 1)")
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
        if ranks.ep > 1:
            if param_specs is None:
                raise ValueError("ep > 1 needs param_specs: which leaves "
                                 "shard over ep (llama.param_specs)")
            if not getattr(loss_fn, "joint_ranks", False):
                raise ValueError("ep > 1 needs a loss over all ranks at "
                                 "once (joint_ranks, llama.dp_loss_fn): "
                                 "the ep ranks exchange tokens")
        if ranks.pp > 1 and param_specs is None:
            raise ValueError("pp > 1 needs param_specs: which leaves split "
                             "over the stages (llama.stacked_param_specs)")
        super().__init__(loss_fn, ranks, cfg)
        # as in the JAX package, this trainer carries no error-feedback
        # residual: a codec's error_feedback flag is not read here
        self._ef = False
        self.loss_and_grads_fn = loss_and_grads_fn
        # model shards a dp rank's parameters split into: its ep ranks or
        # its pp stages (not both: VirtualRanks), one flat row each
        self.n_shards = ranks.ep * ranks.pp
        self.param_specs = param_specs
        self._rep_spans: List[Tuple[int, int]] = []

    # -- the ep / pp layout ----------------------------------------------------

    def init_state(self, params: Params) -> TrainState:
        """Every (dp, shard) rank's master shard of its shard's flat row
        (``P((ep, dp))`` or ``P((pp, dp))``); with one shard,
        ``DPTrainer.init_state``."""
        if self.n_shards == 1:
            return super().init_state(params)
        params = fused_update.tree_map(lambda t: t.to(self.ranks.device),
                                       params)
        local = split_ep(params, self.param_specs, self.n_shards)
        meta = fused_update.flat_meta(local[0], self.cfg.collective, self.n)
        self._meta = meta
        spans, off = [], 0
        for size, spec in zip(meta.sizes, fused_update.tree_leaves(
                self.param_specs)):
            if spec is None:       # merge neighbouring replicated leaves
                if spans and spans[-1][1] == off:
                    spans[-1] = (spans[-1][0], off + size)
                else:
                    spans.append((off, off + size))
            off += size
        self._rep_spans = spans
        if self.cfg.optimizer.clip_norm is not None:
            self._norm_weights = self.norm_weight_tables()
        flat = torch.empty((self.n_shards, meta.padded_len),
                           dtype=torch.float32, device=self.ranks.device)
        for t, row in zip(local, flat):
            fused_update.flatten_tree(t, meta, out=row)
        del local, params
        w_own = flat.reshape(self.n_shards * self.n, -1)
        opt_state = optim.init_state(self.cfg.optimizer, w_own.shape,
                                     device=w_own.device)
        replicas, side = self._working(flat)
        replicas = replicas.repeat_interleave(self.n, dim=0)
        side = None if side is None else side.repeat_interleave(self.n, 0)
        return TrainState(self._rank0(replicas, side), replicas, w_own,
                          opt_state, 0, None, side)

    def norm_weight_tables(self) -> Tuple[np.ndarray, np.ndarray]:
        """JAX's ``_norm_weight_tables`` over one flat row of the ep (pp)
        layout: ``(bounds [m + 1] int32, values [m] f32)``, a segment a
        leaf, its value 1/ep (1/pp) where the leaf replicates over the
        shards (each of their rows holds a copy) and 1 where it is the
        shard's own slice, then the padding at 0.  ``optim.global_norm``
        reads them over the ``[n_shards n_dp, C]`` owned shards."""
        if self._meta is None:
            raise RuntimeError("call init_state first")
        bounds, values = [0], []
        for size, spec in zip(self._meta.sizes, fused_update.tree_leaves(
                self.param_specs)):
            bounds.append(bounds[-1] + size)
            values.append(1.0 if spec is not None else 1.0 / self.n_shards)
        if bounds[-1] < self._meta.padded_len:
            bounds.append(self._meta.padded_len)
            values.append(0.0)
        return (np.asarray(bounds, np.int32),
                np.asarray(values, np.float32))

    def _groups(self, rows: torch.Tensor) -> List[torch.Tensor]:
        """The shard groups' rows of a ``[n_shards n_dp, ...]`` tensor."""
        return list(rows.split(self.n))

    def global_params(self, state: TrainState) -> Params:
        """The whole tree the state holds: each shard group's slice (its
        dp rank 0's row), the replicated leaves of group 0."""
        if self.n_shards == 1:
            return state.params
        return join_ep([self._rank0(
            state.replicas[e * self.n:],
            None if state.side is None else state.side[e * self.n:])
            for e in range(self.n_shards)], self.param_specs)

    # -- step ------------------------------------------------------------------

    def grads(self, state: TrainState, batch
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The ranks' backward; with ep or pp > 1, each replicated leaf's
        gradient summed over the shards of its dp rank, in shard order,
        and written into every shard's row (``loss_and_grads_fn`` gives
        the sum itself)."""
        if self.ranks.pp > 1:
            flat_g, loss = self._stage_grads(state, batch)
            if self.loss_and_grads_fn is not None:
                return flat_g, loss
        else:
            flat_g, loss = super().grads(state, batch)
        if self.n_shards > 1:
            g = flat_g.view(self.n_shards, self.n, -1)
            for a, b in self._rep_spans:
                acc = g[0, :, a:b]
                for e in range(1, self.n_shards):
                    acc.add_(g[e, :, a:b])
                for e in range(1, self.n_shards):
                    g[e, :, a:b].copy_(acc)
        return flat_g, loss

    def _grad_tree(self, row: torch.Tensor) -> Params:
        """A flat f32 gradient row as a tree of views, one a leaf."""
        meta = self._meta
        return fused_update.unflatten_tree(row, meta._replace(
            dtypes=(torch.float32,) * len(meta.dtypes)))

    def _stage_grads(self, state: TrainState, batch
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """pp > 1: a dp rank at a time, the loss over its stage trees (rows
        ``s n_dp + d``) and each stage's gradients into its row of a
        zeroed ``[n_pp n_dp, L_pad]`` f32 flat_g; ``(flat_g, mean
        loss)``."""
        meta, n, pp = self._meta, self.n, self.ranks.pp
        if meta is None:
            raise RuntimeError("call init_state first")
        flat_g = torch.zeros((pp * n, meta.padded_len), dtype=torch.float32,
                             device=state.replicas.device)
        losses = []
        for d in range(n):
            rows = [s * n + d for s in range(pp)]
            leaves = [_rank_leaves(state.replicas, meta, r, state.side)
                      for r in rows]
            trees = [fused_update.tree_from_leaves(meta.keys, ls)
                     for ls in leaves]
            b = tuple(x[d] for x in batch)
            outs = [self._grad_tree(flat_g[r]) for r in rows]
            if self.loss_and_grads_fn is not None:
                loss, _ = self.loss_and_grads_fn(trees, b, out=outs)
            else:
                loss = self.loss_fn(trees, b)
                gs = torch.autograd.grad(loss, [t for ls in leaves
                                                for t in ls],
                                         allow_unused=True)
                views = [v for o in outs
                         for v in fused_update.tree_leaves(o)]
                for v, g in zip(views, gs):
                    if g is not None:
                        v.copy_(g)
                del gs
            del leaves, trees, outs
            losses.append(loss.detach())
        return flat_g, torch.stack(losses).mean()

    def apply_grads(self, state: TrainState, flat_g: torch.Tensor,
                    codec_state: Optional[torch.Tensor] = None
                    ) -> TrainState:
        """Phases 2-5 on given per-rank gradients ``[n, L_pad]`` (with
        ep or pp, ``grads``'s rows, the shard sum taken)."""
        return self.update(state, self._reduce(flat_g))

    def _reduce(self, flat_g: torch.Tensor) -> torch.Tensor:
        coll = self.cfg.collective
        if self.n_shards == 1:
            return fused_update.reduce_scatter(flat_g, coll) / self.n
        out = torch.empty((flat_g.shape[0], flat_g.shape[1] // self.n),
                          dtype=torch.float32, device=flat_g.device)
        for g, o in zip(self._groups(flat_g), self._groups(out)):
            torch.div(fused_update.reduce_scatter(g, coll), self.n, out=o)
        return out

    def _gather(self, w_new: torch.Tensor, opt_state: optim.OptState,
                step: int, codec_state: Optional[torch.Tensor] = None,
                diag: Optional[dict] = None):
        if self.n_shards == 1:
            return super()._gather(w_new, opt_state, step, codec_state,
                                   diag)
        reps, sides = [], []
        for w in self._groups(w_new):
            r, s = self._working(fused_update.all_gather_flat(
                w, self.cfg.collective))
            reps.append(r)
            sides.append(s)
        replicas = torch.cat(reps)
        del reps
        side = None if sides[0] is None else torch.cat(sides)
        return TrainState(self._rank0(replicas, side), replicas, w_new,
                          opt_state, step, codec_state, side)

    def params_from_master(self, w_own: torch.Tensor) -> Params:
        """Rank 0's working params rebuilt from the master shards (its
        shard group's gather)."""
        if self.n_shards == 1:
            return super().params_from_master(w_own)
        return super().params_from_master(self._groups(w_own)[0])

    def step(self, state: TrainState, batch
             ) -> Tuple[TrainState, torch.Tensor]:
        flat_g, loss = self.grads(state, batch)
        held = [self._reduce(flat_g)]
        del flat_g
        # pop: update() holds the only reference and frees the reduced
        # gradient before the all-gather allocates the new replicas
        return self.update(state, held.pop()), loss
