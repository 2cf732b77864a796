"""ZeRO-1 sharded trainer over virtual ranks — the port of the JAX
package's ``parallel/sharded.py`` (``ShardedTrainer``) for its dp, tp,
sp, ep and pp axes.

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
leaves' already summed, into ``out``, the stages' f32 rows.  At pp = 1
(and tp = 1) ``loss_and_grads_fn(params, batch) -> (loss, grads)`` is
JAX's explicit-gradient hook: called a dp rank at a time (or once over
every rank, marked ``joint_ranks``) where autograd would run, its
gradient trees copied into the rows; the rest of the step is unchanged.  The dp
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

With tp > 1 (``MeshConfig(dp, tp=...)``, ``param_specs`` giving each
leaf's ``mesh.Spec``, e.g. ``llama.param_specs(cfg, tp_axis="tp",
tp_size=tp)``) the layout is JAX's ``P((tp, ep, dp))``: one flat row a
(tp, dp) rank (with ep, ``(t n_ep + e) n_dp + d``), holding tp rank t's
column or row slice of each split leaf and its copy of the replicated
ones (the embedding, the norms, the router, and ``wk``/``wv`` where they
replicate because tp exceeds the kv heads).  The tp ranks of a dp rank
see the same batch shard (JAX's batch spec never names tp), and one loss
takes the dp rank's tp trees at once (``llama.loss_fn(..., tp_axis=
"tp")``; a MoE model's ``llama.dp_loss_fn(..., tp_axis="tp")`` every
rank's): each dp rank's loss is differentiated once, since its tp ranks
hold one value of it, and a backward a tp rank would count every
gradient tp times.  The replicated leaves' gradients are then summed
over the tp (and ep) rows and written into each, the dp phases run
within each (tp, ep) group, one ring launch a group, and ``clip_norm``
counts a replicated leaf 1/tp a copy.

pp composes with tp (``MeshConfig(dp, tp=, pp=)``, Megatron's 3-D
layout; ``llama.stacked_param_specs(cfg, tp_axis="tp", tp_size=tp)``):
the rows are JAX's ``P((tp, pp, ep, dp))``, row ``((t n_pp + s) n_ep +
e) n_dp + d``, and the loss takes each stage's tp ranks' trees as a
list, ``stage_trees[s] = [tree of (t, s) for t]`` (with ``joint_ranks``
``stage_trees[s][e n_dp + d]`` such a list).  The shard sums then run
over every subset of (tp, pp, ep) that holds a leaf: the embedding and
final norm over all three, the head over pp (its vocab shard is a tp
rank's own), a stage's norms (and ``wk``/``wv`` under kv replication)
over its tp rows.

``accum_steps > 1`` (``parallel.accum``) cuts every rank's local batch
into microbatches and runs the backward once a microbatch, adding the
gradients in f32 into the same rows; the shard sums, the scale by ``1 /
accum_steps`` and the dp phases then run once a step.  It composes with
tp, sp, ep and GPipe (each microbatch then goes through the pipeline's
own ``num_microbatches``).

Under a process group of W > 1 (``parallel.multihost``) the trainer at
dp = W spans the processes, one dp rank a process, as
``DPTrainer`` does (its ``_proc_initial`` and ``_gather``): phase 2 is the
ring reduce-scatter without an update over ``ops.ring_procs``, then the
division by n and ``optim.apply`` on this rank's ``[1, C]`` shard, then
the ring all-gather; ``loss_and_grads_fn`` is taken there a rank at a
time.  tp, sp, ep or pp > 1, ``clip_norm`` (its norm spans the ranks)
and what ``train.check_processes`` refuses (a ``joint_ranks`` loss that
does not pool across the processes among it) raise
``NotImplementedError`` naming ROADMAP A.11.

As in the JAX package the fused optimizer kernel is not used: the update
is ``optim.apply`` between the two collectives.  An fsdp mesh axis raises
``NotImplementedError``; ``loss_and_grads_fn`` with ``accum_steps > 1``
and ``integrity_check`` raise ``ValueError``, as the JAX package's do
(the latter is DPTrainer's).  The state is ``parallel.train.TrainState``; ``step``
drops the flat gradients before the update, so at full width they never
coexist with the gathered replicas.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from . import accum, multihost
from .mesh import VirtualRanks, spec_dims
from .train import (DPTrainer, Params, TrainState, _rank_leaves,
                    check_processes, refuse_fsdp, restored_tensor)
from .. import optim
from ..ops import fused_update
from ..utils.config import TrainConfig


def _shard_grid(specs: Any, n: Union[int, Dict[str, int]]
                ) -> Dict[str, int]:
    """The shard axes and their sizes, major first: ``n`` as given, or an
    int for the one axis the specs name."""
    if isinstance(n, dict):
        return dict(n)
    names = {a for s in fused_update.tree_leaves(specs)
             for a in spec_dims(s) if a is not None}
    if len(names) > 1:
        raise ValueError(f"specs name the axes {sorted(names)}: give "
                         "their sizes as a dict")
    return {a: n for a in names} or {"ep": n}


def split_ep(params: Params, specs: Any,
             n: Union[int, Dict[str, int]]) -> List[Params]:
    """The whole tree as the shards' local trees, one a point of the grid
    ``n`` (``{"tp": tp, "pp": pp, "ep": ep}``: shard ``(t pp + s) ep +
    e``, tp major, JAX's ``_waxes`` order; an int for the one axis the
    specs name): each dimension of a leaf splits over the axis its spec
    gives it (``mesh.Spec``; ``"ep"`` or ``"pp"`` the first dimension,
    ``"pp,ep"`` the first two; each shard's chunk a view, as JAX's
    ``NamedSharding`` cuts a dimension into equal blocks; an axis the grid
    does not name has extent 1), the others shared."""
    pairs = fused_update._leaves(params)
    paths = tuple(p for p, _ in pairs)
    dims = [spec_dims(s) for s in fused_update.tree_leaves(specs)]
    if len(dims) != len(pairs):
        raise ValueError("param_specs does not match the params tree")
    grid = _shard_grid(specs, n)
    for (path, leaf), names in zip(pairs, dims):
        for d, a in enumerate(names):
            if a is not None and leaf.shape[d] % grid.get(a, 1):
                raise ValueError(f"{path}: dimension {d} of "
                                 f"{tuple(leaf.shape)} does not split "
                                 f"over {a}={grid[a]}")
    out = []
    for idx in itertools.product(*(range(k) for k in grid.values())):
        at = dict(zip(grid, idx))
        leaves = []
        for (_, leaf), names in zip(pairs, dims):
            for d, a in enumerate(names):
                if a in grid:
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
        names = spec_dims(spec)
        parts = list(ls)
        # fold the grid from its minor axis: each step joins one axis
        for a in reversed(list(grid)):
            k = grid[a]
            dim = names.index(a) if a in names else None
            parts = [torch.cat(parts[i:i + k], dim=dim) if dim is not None
                     else parts[i] for i in range(0, len(parts), k)]
        leaves.append(parts[0])
    return fused_update.tree_from_leaves(tuple(p for p, _ in pairs), leaves)


def _merge_spans(spans: List[Tuple[int, int, Any]]
                 ) -> List[Tuple[int, int, Any]]:
    """``(start, end, key)`` spans with each run of neighbours of one key
    merged into one span."""
    out: List[Tuple[int, int, Any]] = []
    for a, b, key in spans:
        if out and out[-1][1] == a and out[-1][2] == key:
            out[-1] = (out[-1][0], b, key)
        else:
            out.append((a, b, key))
    return out


def _sum_into_all(copies: List[torch.Tensor]) -> None:
    """The copies' sum, in order, written into each."""
    acc = copies[0]
    for c in copies[1:]:
        acc.add_(c)
    for c in copies[1:]:
        c.copy_(acc)


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
        if cfg.collective.codec == "auto":
            raise NotImplementedError(
                "codec='auto' resolves on DPTrainer, DDPTrainer and "
                "FSDPTrainer, as in the JAX package: ShardedTrainer takes a "
                "concrete codec")
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
        if ranks.tp > 1 and param_specs is None:
            raise ValueError("tp > 1 needs param_specs: which dimension of "
                             "each leaf splits over tp (llama.param_specs("
                             "cfg, tp_axis='tp', tp_size=tp))")
        self.loss_and_grads_fn = loss_and_grads_fn
        super().__init__(loss_fn, ranks, cfg)
        # as in the JAX package, this trainer carries no error-feedback
        # residual: a codec's error_feedback flag is not read here
        self._ef = False
        # model shards a dp rank's parameters split into: its tp ranks
        # times its pp stages times its ep ranks, one flat row each (tp
        # major)
        self.n_shards = ranks.tp * ranks.pp * ranks.ep
        self.param_specs = param_specs
        # flat spans of a row whose leaves replicate over some shard axes,
        # with those axes: (start, end, axes)
        self._shard_spans: List[Tuple[int, int, Tuple[str, ...]]] = []
        # (start, end) of the leaves every shard holds, and with ep of the
        # split leaves that replicate over ep (a stage's attention)
        self._rep_spans: List[Tuple[int, int]] = []
        self._ep_rep_spans: List[Tuple[int, int]] = []

    def _check_processes(self) -> None:
        """At dp across processes (the module docstring): every shard axis
        1, no clip, and ``train.check_processes``."""
        for axis, size in (("tp", self.ranks.tp), ("sp", self.ranks.sp),
                           ("ep", self.ranks.ep), ("pp", self.ranks.pp)):
            if size != 1:
                multihost.refuse_processes(f"ShardedTrainer at {axis}={size}")
        check_processes(self.cfg, self.world, self._codec, False,
                        self.loss_and_grads_fn or self.loss_fn,
                        ((self.cfg.optimizer.clip_norm is not None,
                          "clip_norm"),))

    # -- the ep / pp layout ----------------------------------------------------

    def _layout(self, params: Params) -> List[Params]:
        """The tp x pp x ep layout of a params tree (shapes and dtypes
        are read): the flat meta of a shard's row, the spans of the
        leaves each shard axis replicates, the clip's norm tables; returns
        the shards' trees."""
        local = split_ep(params, self.param_specs, self._grid())
        meta = fused_update.flat_meta(local[0], self.cfg.collective, self.n)
        self._meta = meta
        shard, rep, ep_rep, off = [], [], [], 0
        for size, spec in zip(meta.sizes, fused_update.tree_leaves(
                self.param_specs)):
            dims = spec_dims(spec)
            axes = tuple(a for a, k in self._grid().items()
                         if k > 1 and a not in dims)
            span = (off, off + size)
            if axes:
                shard.append(span + (axes,))
            if not any(dims):
                rep.append(span + (None,))
            elif self.ranks.ep > 1 and "ep" not in dims:
                ep_rep.append(span + (None,))
            off += size
        self._shard_spans = _merge_spans(shard)
        self._rep_spans = [s[:2] for s in _merge_spans(rep)]
        self._ep_rep_spans = [s[:2] for s in _merge_spans(ep_rep)]
        if self.cfg.optimizer.clip_norm is not None:
            self._norm_weights = self.norm_weight_tables()
        return local

    def init_state(self, params: Params) -> TrainState:
        """Every (dp, shard) rank's master shard of its shard's flat row
        (``P((ep, dp))`` or ``P((pp, dp))``); with one shard,
        ``DPTrainer.init_state``."""
        if self.n_shards == 1:
            return super().init_state(params)
        params = fused_update.tree_map(lambda t: t.to(self.ranks.device),
                                       params)
        local = self._layout(params)
        meta = self._meta
        flat = torch.empty((self.n_shards, meta.padded_len),
                           dtype=torch.float32, device=self.ranks.device)
        for t, row in zip(local, flat):
            fused_update.flatten_tree(t, meta, out=row)
        del local, params
        w_own = flat.reshape(self.n_shards * self.n, -1)
        opt_state = optim.init_state(self.cfg.optimizer, w_own.shape,
                                     device=w_own.device)
        return self._initial(w_own, opt_state, None)

    def _initial(self, w_own: torch.Tensor, opt_state: optim.OptState,
                 codec_state: Optional[torch.Tensor]) -> TrainState:
        if self.n_shards == 1:
            return super()._initial(w_own, opt_state, codec_state)
        replicas, side = self._working(w_own.reshape(self.n_shards, -1))
        replicas = replicas.repeat_interleave(self.n, dim=0)
        side = None if side is None else side.repeat_interleave(self.n, 0)
        return TrainState(self._rank0(replicas, side), replicas, w_own,
                          opt_state, 0, codec_state, side)

    def _grid(self) -> Dict[str, int]:
        """The shard axes of a dp rank's rows and their sizes, tp major."""
        return {"tp": self.ranks.tp, "pp": self.ranks.pp,
                "ep": self.ranks.ep}

    def norm_weight_tables(self) -> Tuple[np.ndarray, np.ndarray]:
        """JAX's ``_norm_weight_tables`` over one flat row of the tp x pp x
        ep layout: ``(bounds [m + 1] int32, values [m] f32)``, a segment a
        leaf, its value 1 / (the product of the shard axes it does not
        split over: each of those rows holds a copy), so 1/tp, 1/ep, 1/pp
        or their products where it replicates and 1 where it is the
        shard's own slice, then the padding at 0.  ``optim.global_norm`` reads them
        over the ``[n_shards n_dp, C]`` owned shards."""
        if self._meta is None:
            raise RuntimeError("call init_state first")
        bounds, values = [0], []
        for size, spec in zip(self._meta.sizes, fused_update.tree_leaves(
                self.param_specs)):
            rep = 1
            for a, k in self._grid().items():
                if a not in spec_dims(spec):
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
        """The ranks' backward; with tp, pp or ep > 1, each leaf's gradient
        summed over the shards of its dp rank that hold a copy of it, in
        row order, and written into each of their rows (JAX's varying-axes
        psums): a leaf every shard holds over all of them, a slice that
        replicates over some axes (a stage's attention over ep, the
        embedding over tp) over those.  ``loss_and_grads_fn`` gives the
        sum over the stages itself, so pp is left out there."""
        if self.ranks.pp > 1 or self.ranks.tp > 1:
            flat_g, loss = accum.accumulate(
                lambda mb, into: self._shard_grads(state, mb, into), batch,
                self.cfg.accum_steps, self._lead)
        elif self.loss_and_grads_fn is not None:
            flat_g, loss = self._explicit_grads(state, batch)
        else:
            flat_g, loss = super().grads(state, batch)
        if self.n_shards > 1:
            grid = self._grid()
            names, sizes = list(grid), list(grid.values())
            g = flat_g.view(*sizes, self.n, -1)
            for a, b, rep in self._shard_spans:
                if self.loss_and_grads_fn is not None:
                    rep = tuple(x for x in rep if x != "pp")
                axes = [names.index(x) for x in rep]
                free = [i for i in range(len(names)) if i not in axes]
                for fixed in itertools.product(*(range(sizes[i])
                                                 for i in free)):
                    views = []
                    for r in itertools.product(*(range(sizes[i])
                                                 for i in axes)):
                        at = dict(zip(free, fixed))
                        at.update(zip(axes, r))
                        views.append(g[tuple(at[i] for i in range(
                            len(names)))][:, a:b])
                    _sum_into_all(views)
        return flat_g, loss

    def _explicit_grads(self, state: TrainState, batch
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """pp = tp = 1 with ``loss_and_grads_fn``: ``(flat_g [n_ep n_dp,
        L_pad] f32, mean loss)``, the function called where
        ``per_rank_grads`` / ``joint_grads`` would run autograd, JAX's
        ``loss_and_grads_fn(params, batch) -> (loss, grads)``: a rank at a
        time with its own tree (working weights, detached) and batch
        shard, or, marked ``joint_ranks``, once over every rank's tree
        and the whole batch, ``(losses [n], grads a tree a rank)``.  Each
        rank's gradient tree is copied into its row; ``grads`` then takes
        the ep sums as for autograd's."""
        meta = self._meta
        if meta is None:
            raise RuntimeError("call init_state first")
        reps, side = state.replicas, state.side
        n = reps.shape[0]
        trees = [fused_update.unflatten_tree(
            reps[i], meta, None if side is None else side[i])
            for i in range(n)]
        flat_g = torch.empty((n, meta.padded_len), dtype=torch.float32,
                             device=reps.device)
        fn = self.loss_and_grads_fn
        if getattr(fn, "joint_ranks", False):
            losses, grads = fn(trees, batch)
            for i, g in enumerate(grads):
                fused_update.flatten_tree(g, meta, out=flat_g[i])
            return flat_g, losses.detach().mean()
        losses = []
        for i, tree in enumerate(trees):
            loss, g = fn(tree, tuple(b[i] for b in batch))
            fused_update.flatten_tree(g, meta, out=flat_g[i])
            losses.append(loss.detach())
        return flat_g, multihost.process_mean(torch.stack(losses).mean())

    def _grad_tree(self, row: torch.Tensor) -> Params:
        """A flat f32 gradient row as a tree of views, one a leaf."""
        meta = self._meta
        return fused_update.unflatten_tree(row, meta._replace(
            dtypes=(torch.float32,) * len(meta.dtypes)))

    def _shard_grads(self, state: TrainState, batch,
                     into: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """pp or tp > 1: each stage's (tp rank's) gradients into its rows
        (``(s n_ep + e) n_dp + d``) of a zeroed ``[k n_ep n_dp, L_pad]`` f32
        flat_g, k the stages (tp ranks); ``(flat_g, mean loss)``.  A loss
        marked ``joint_ranks`` (a MoE model's: ``llama.dp_loss_fn``,
        ``pp_dp_loss_fn``, ``pp_dp_loss_and_grads_fn``) takes every rank's
        trees at once, ``trees[s][e n_dp + d]``, and the whole batch; any
        other one dp rank's k trees and its batch, a dp rank at a time, so
        a dp rank's loss is differentiated once, never once a tp rank.
        With both pp and tp the trees go as ``_stage_units`` gives them.
        A tree's leaf the loss leaves unused (a tp rank's copy of a
        replicated leaf) gets a zero gradient; the shard sums of ``grads``
        complete it.  ``into``: rows of an earlier microbatch that this
        one's gradients are added to in f32 (accumulation)."""
        meta, n = self._meta, self.n
        pp = self.ranks.pp * self.ranks.tp
        if meta is None:
            raise RuntimeError("call init_state first")
        N = self.ranks.ep * n
        flat_g = into if into is not None else torch.zeros(
            (pp * N, meta.padded_len), dtype=torch.float32,
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
                loss, _ = self.loss_and_grads_fn(
                    self._stage_units(trees, joint), b,
                    out=self._stage_units(outs, joint))
            else:
                loss = self.loss_fn(self._stage_units(trees, joint), b)
                flat = [t for st in leaves for ls in st for t in ls]
                gs = torch.autograd.grad(loss.sum(), flat,
                                         allow_unused=True)
                del flat
                for v, g in zip(fused_update.tree_leaves(outs), gs):
                    if g is not None:
                        (v.add_ if into is not None else v.copy_)(g)
                del gs
            del leaves, trees, outs
            losses.append(loss.detach().mean())
        return flat_g, torch.stack(losses).mean()

    def _stage_units(self, trees: List[Any], joint: bool) -> List[Any]:
        """The shards' trees (tp major: shard ``t pp + s``) as a pp loss
        takes them with tp: stage s's list of its tp ranks' trees (with
        ``joint``, rank r's entry of stage s that list); as given
        without both axes."""
        tp, pp = self.ranks.tp, self.ranks.pp
        if tp == 1 or pp == 1:
            return trees
        if not joint:
            return [[trees[t * pp + s] for t in range(tp)]
                    for s in range(pp)]
        return [[[trees[t * pp + s][r] for t in range(tp)]
                 for r in range(len(trees[0]))] for s in range(pp)]

    def apply_grads(self, state: TrainState, flat_g: torch.Tensor,
                    codec_state: Optional[torch.Tensor] = None
                    ) -> TrainState:
        """Phases 2-5 on given per-rank gradients ``[n, L_pad]`` (with
        ep or pp, ``grads``'s rows, the shard sum taken)."""
        return self.update(state, self._reduce(flat_g))

    def _reduce(self, flat_g: torch.Tensor) -> torch.Tensor:
        coll = self.cfg.collective
        if self.world > 1:
            g, _, _ = self._ring.reduce_scatter_update(flat_g[0])
            return (g / self.n)[None]
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

    def restore_state(self, restored: dict, params_like=None) -> TrainState:
        """TrainState from a ``utils.checkpoint`` restore payload: with
        shard axes, the stored global vectors are JAX's ``P((tp, pp, ep,
        dp))`` rows end to end (no re-padding, as in the JAX package), and
        each shard group's replicas are rebuilt by its gather (at step 0
        laid as ``init_state`` lays them); with none,
        ``DPTrainer.restore_state``.  ``params_like``: the whole params
        tree (as ``init_state`` takes it) when ``init_state`` has not
        run."""
        if self.n_shards == 1:
            return super().restore_state(restored, params_like)
        if params_like is not None:
            self._layout(params_like)
        if self._meta is None:
            raise RuntimeError("flat layout unknown: call init_state "
                               "first or pass params_like")
        dev = self.ranks.device

        def rows(v):
            return restored_tensor(v, dev).to(torch.float32).reshape(
                self.n_shards * self.n, -1).contiguous()

        return self._landed(rows(restored["w_own"]),
                            {k: rows(v) for k, v in
                             restored["opt_state"].items()},
                            int(restored["step"]), None)

    def step(self, state: TrainState, batch
             ) -> Tuple[TrainState, torch.Tensor]:
        flat_g, loss = self.grads(state, batch)
        held = [self._reduce(flat_g)]
        del flat_g
        # pop: update() holds the only reference and frees the reduced
        # gradient before the all-gather allocates the new replicas
        return self.update(state, held.pop()), loss
