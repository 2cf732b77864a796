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

pp composes with sp and ep (``MeshConfig(dp, pp=, sp=, ep=)``): the batch
keeps its ``P((dp, ep), sp)`` layout (pp never splits it) and the rows
are JAX's ``P((pp, ep, dp))``, row ``(s n_ep + e) n_dp + d``, rank (d,
e)'s slice of stage s (``llama.stacked_param_specs(cfg, ep_axis="ep")``:
a MoE layer's experts ``"pp,ep"``, split over pp, then over ep).  A loss marked
``joint_ranks`` (a MoE model's, ``llama.pp_dp_loss_fn`` or
``pp_dp_loss_and_grads_fn``) takes every rank's stage trees and the
whole batch at once.  After the backward a leaf every row holds (the
embedding, norm, head) is summed over the stages and the ep ranks of
its dp rank, a stage's slice that replicates over ep (attention, norms,
the router) over the stage's ep ranks; the dp phases run within each
(pp, ep) group, and ``clip_norm`` weights a leaf 1 / (its copies over
pp x ep).

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

import itertools
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .mesh import UNPORTED_AXES, VirtualRanks
from .train import (DPTrainer, Params, TrainState, _rank_leaves,
                    refuse_fsdp)
from .. import optim
from ..ops import fused_update
from ..utils.config import TrainConfig


def _spec_axes(spec: Optional[str]) -> Tuple[str, ...]:
    """The mesh axis each leading dimension of a leaf splits over, from
    its spec: None (replicated) -> (), ``"ep"`` -> ("ep",), ``"pp,ep"``
    -> ("pp", "ep") (JAX's ``P("pp", "ep")``)."""
    return () if spec is None else tuple(spec.split(","))


def _shard_grid(specs: Any, n: Union[int, Dict[str, int]]
                ) -> Dict[str, int]:
    """The shard axes and their sizes, major first: ``n`` as given, or an
    int for the one axis the specs name."""
    if isinstance(n, dict):
        return dict(n)
    names = {a for s in fused_update.tree_leaves(specs)
             for a in _spec_axes(s)}
    if len(names) > 1:
        raise ValueError(f"specs name the axes {sorted(names)}: give "
                         "their sizes as a dict")
    return {a: n for a in names} or {"ep": n}


def split_ep(params: Params, specs: Any,
             n: Union[int, Dict[str, int]]) -> List[Params]:
    """The whole tree as the shards' local trees, one a point of the grid
    ``n`` (``{"pp": pp, "ep": ep}``: shard ``s ep + e``, pp major; an int
    for the one axis the specs name): a leaf's leading dimensions split
    over the axes its spec names (``"ep"`` or ``"pp"`` the first,
    ``"pp,ep"`` the first two; each shard's chunk a view), the others
    shared."""
    pairs = fused_update._leaves(params)
    paths = tuple(p for p, _ in pairs)
    axes = [_spec_axes(s) for s in fused_update.tree_leaves(specs)]
    if len(axes) != len(pairs):
        raise ValueError("param_specs does not match the params tree")
    grid = _shard_grid(specs, n)
    out = []
    for idx in itertools.product(*(range(k) for k in grid.values())):
        at = dict(zip(grid, idx))
        leaves = []
        for (_, leaf), names in zip(pairs, axes):
            for d, a in enumerate(names):
                leaf = leaf.chunk(grid[a], dim=d)[at[a]]
            leaves.append(leaf)
        out.append(fused_update.tree_from_leaves(paths, leaves))
    return out


def join_ep(trees: List[Params], specs: Any,
            n: Union[int, Dict[str, int], None] = None) -> Params:
    """Inverse of ``split_ep`` (``n`` as given there; by default the one
    axis the specs name, of ``len(trees)`` shards): the sharded leaves
    concatenated, the others shard 0's."""
    grid = _shard_grid(specs, len(trees) if n is None else n)
    pairs = fused_update._leaves(trees[0])
    cols = list(zip(*(fused_update.tree_leaves(t) for t in trees)))
    leaves = []
    for ls, spec in zip(cols, fused_update.tree_leaves(specs)):
        names = _spec_axes(spec)
        parts = list(ls)
        # fold the grid from its minor axis: each step joins one axis
        for a in reversed(list(grid)):
            k = grid[a]
            dim = names.index(a) if a in names else None
            parts = [torch.cat(parts[i:i + k], dim=dim) if dim is not None
                     else parts[i] for i in range(0, len(parts), k)]
        leaves.append(parts[0])
    return fused_update.tree_from_leaves(tuple(p for p, _ in pairs), leaves)


def _sum_into_all(g: torch.Tensor) -> None:
    """``g [k, ...]``: the k copies' sum, in order, written into each."""
    acc = g[0]
    for e in range(1, g.shape[0]):
        acc.add_(g[e])
    for e in range(1, g.shape[0]):
        g[e].copy_(acc)


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
        refuse_fsdp(cfg)
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
            if not getattr(loss_and_grads_fn or loss_fn, "joint_ranks",
                           False):
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
        # model shards a dp rank's parameters split into: its pp stages
        # times its ep ranks, one flat row each (pp major)
        self.n_shards = ranks.ep * ranks.pp
        self.param_specs = param_specs
        # leaves replicated over every shard, and (pp and ep together)
        # the stage slices replicated over ep: flat spans of a row
        self._rep_spans: List[Tuple[int, int]] = []
        self._ep_rep_spans: List[Tuple[int, int]] = []

    # -- the ep / pp layout ----------------------------------------------------

    def init_state(self, params: Params) -> TrainState:
        """Every (dp, shard) rank's master shard of its shard's flat row
        (``P((ep, dp))`` or ``P((pp, dp))``); with one shard,
        ``DPTrainer.init_state``."""
        if self.n_shards == 1:
            return super().init_state(params)
        params = fused_update.tree_map(lambda t: t.to(self.ranks.device),
                                       params)
        local = split_ep(params, self.param_specs, self._grid())
        meta = fused_update.flat_meta(local[0], self.cfg.collective, self.n)
        self._meta = meta
        spans, ep_spans, off = [], [], 0
        for size, spec in zip(meta.sizes, fused_update.tree_leaves(
                self.param_specs)):
            axes = _spec_axes(spec)
            into = (spans if not axes else ep_spans
                    if self.ranks.ep > 1 and "ep" not in axes else None)
            if into is not None:   # merge neighbouring spans
                if into and into[-1][1] == off:
                    into[-1] = (into[-1][0], off + size)
                else:
                    into.append((off, off + size))
            off += size
        self._rep_spans, self._ep_rep_spans = spans, ep_spans
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

    def _grid(self) -> Dict[str, int]:
        """The shard axes of a dp rank's rows and their sizes, pp major."""
        return {"pp": self.ranks.pp, "ep": self.ranks.ep}

    def norm_weight_tables(self) -> Tuple[np.ndarray, np.ndarray]:
        """JAX's ``_norm_weight_tables`` over one flat row of the pp x ep
        layout: ``(bounds [m + 1] int32, values [m] f32)``, a segment a
        leaf, its value 1 / (the product of the shard axes it does not
        split over: each of those rows holds a copy), so 1/ep, 1/pp or
        1/(pp ep) where it replicates and 1 where it is the shard's own
        slice, then the padding at 0.  ``optim.global_norm`` reads them
        over the ``[n_shards n_dp, C]`` owned shards."""
        if self._meta is None:
            raise RuntimeError("call init_state first")
        bounds, values = [0], []
        for size, spec in zip(self._meta.sizes, fused_update.tree_leaves(
                self.param_specs)):
            rep = 1
            for a, k in self._grid().items():
                if a not in _spec_axes(spec):
                    rep *= k
            bounds.append(bounds[-1] + size)
            values.append(1.0 / rep)
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
            for e in range(self.n_shards)], self.param_specs, self._grid())

    # -- step ------------------------------------------------------------------

    def grads(self, state: TrainState, batch
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The ranks' backward; with ep or pp > 1, each replicated leaf's
        gradient summed over the shards of its dp rank that hold a copy,
        in row order, and written into each of their rows: a leaf every
        shard holds over all of them (``loss_and_grads_fn`` gives the sum
        over the stages itself, so only over ep), a stage's slice that
        replicates over ep over the stage's ep ranks."""
        if self.ranks.pp > 1:
            flat_g, loss = self._stage_grads(state, batch)
        else:
            flat_g, loss = super().grads(state, batch)
        if self.n_shards > 1:
            g = flat_g.view(self.ranks.pp, self.ranks.ep, self.n, -1)
            over_pp = self.loss_and_grads_fn is None
            for a, b in self._rep_spans:
                if over_pp:
                    _sum_into_all(g[..., a:b].flatten(0, 1))
                else:
                    for s in range(self.ranks.pp):
                        _sum_into_all(g[s, :, :, a:b])
            for a, b in self._ep_rep_spans:
                for s in range(self.ranks.pp):
                    _sum_into_all(g[s, :, :, a:b])
        return flat_g, loss

    def _grad_tree(self, row: torch.Tensor) -> Params:
        """A flat f32 gradient row as a tree of views, one a leaf."""
        meta = self._meta
        return fused_update.unflatten_tree(row, meta._replace(
            dtypes=(torch.float32,) * len(meta.dtypes)))

    def _stage_grads(self, state: TrainState, batch
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """pp > 1: each stage's gradients into its rows (``(s n_ep + e)
        n_dp + d``) of a zeroed ``[pp n_ep n_dp, L_pad]`` f32 flat_g;
        ``(flat_g, mean loss)``.  A loss marked ``joint_ranks`` (a MoE
        model's: ``llama.pp_dp_loss_fn``, ``pp_dp_loss_and_grads_fn``)
        takes every rank's stage trees at once, ``trees[s][e n_dp + d]``,
        and the whole batch; any other one dp rank's stage trees and its
        batch, a dp rank at a time."""
        meta, n, pp = self._meta, self.n, self.ranks.pp
        if meta is None:
            raise RuntimeError("call init_state first")
        N = self.ranks.ep * n
        flat_g = torch.zeros((pp * N, meta.padded_len), dtype=torch.float32,
                             device=state.replicas.device)
        fn = self.loss_and_grads_fn or self.loss_fn
        if getattr(fn, "joint_ranks", False):
            calls = [([list(range(s * N, (s + 1) * N)) for s in range(pp)],
                      tuple(batch), True)]
        else:
            calls = [([[s * n + d] for s in range(pp)],
                      tuple(x[d] for x in batch), False)
                     for d in range(n)]
        losses = []
        for rows, b, joint in calls:
            leaves = [[_rank_leaves(state.replicas, meta, r, state.side)
                       for r in rs] for rs in rows]
            trees = [[fused_update.tree_from_leaves(meta.keys, ls)
                      for ls in st] for st in leaves]
            outs = [[self._grad_tree(flat_g[r]) for r in rs] for rs in rows]
            if not joint:
                trees = [st[0] for st in trees]
                outs = [o[0] for o in outs]
            if self.loss_and_grads_fn is not None:
                loss, _ = self.loss_and_grads_fn(trees, b, out=outs)
            else:
                loss = self.loss_fn(trees, b)
                flat = [t for st in leaves for ls in st for t in ls]
                gs = torch.autograd.grad(loss.sum(), flat,
                                         allow_unused=True)
                del flat
                for v, g in zip(fused_update.tree_leaves(outs), gs):
                    if g is not None:
                        v.copy_(g)
                del gs
            del leaves, trees, outs
            losses.append(loss.detach().mean())
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

    def update(self, state: TrainState, g_own: torch.Tensor,
               codec_state: Optional[torch.Tensor] = None,
               diag: Optional[dict] = None):
        """``DPTrainer.update``; with shard groups the optimizer takes a
        (pp, ep) group's rows at a time (JAX's runs a device at a time),
        so its temporaries are a group's, not every row's: the same
        elementwise arithmetic, the same bits."""
        if self.n_shards == 1:
            return super().update(state, g_own, codec_state, diag)
        opt_cfg = self.cfg.optimizer
        g_own = optim.clip_by_global_norm(opt_cfg, g_own,
                                          self._norm_weights)
        w_new = torch.empty_like(state.w_own)
        opt_state = {k: torch.empty_like(v)
                     for k, v in state.opt_state.items()}
        for i in range(self.n_shards):
            rows = slice(i * self.n, (i + 1) * self.n)
            w, st = optim.apply(opt_cfg, state.w_own[rows], g_own[rows],
                                {k: v[rows] for k, v in
                                 state.opt_state.items()}, state.step)
            w_new[rows].copy_(w)
            for k, v in st.items():
                opt_state[k][rows].copy_(v)
            del w, st
        del g_own
        return self._gather(w_new, opt_state, state.step + 1, codec_state,
                            diag)

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
