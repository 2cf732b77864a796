"""Pipeline parallelism over virtual pp stages — the port of the JAX
package's ``parallel/pipeline.py``.

The pp stages are virtual ranks on one card, as dp, sp and ep are
(``parallel.mesh``): every stage's layer slice lives on the device, and a
per-stage argument is a list over the stages (``stage_params[s]``, stage
s's stacked ``[n_local_layers, ...]`` slice of the ``[n_layers, ...]``
stack).  A ring hop from stage s to s + 1 is handing a tensor from one
unit to the next.

- ``pipeline_apply(_aux)``: GPipe.  Microbatch m goes through stage 0,
  then 1, and so on, in the order of JAX's tick loop (at tick t stage s
  holds microbatch t - s); autograd differentiates the whole run, as
  ``jax.grad`` does JAX's scan.  JAX computes on ring garbage at the
  bubble ticks, where a stage holds no real microbatch, and masks what
  they give; here only the real (stage, microbatch) units run: the same
  numbers, less work.
- ``pipeline_train_1f1b``: 1F1B at JAX's ticks (forward of microbatch m at
  stage s at tick ``s + 2m``, its backward at ``2 pp - 1 - s + 2m``),
  returning the gradients without an outer backward.  A forward unit runs
  under ``torch.no_grad()`` and keeps only the stage's input in a slot
  (``m % pp``); a backward unit runs the stage forward again from that
  input with grad enabled and differentiates it against the incoming
  cotangent (JAX's stage-granular recompute), so stage s holds at most
  ``pp - s`` inputs, whatever the number of microbatches.
- ``pipeline_train_1f1b_interleaved``: the same units driven by
  ``_interleaved_tables(pp, v, M)`` (Megatron's order, verified when
  built); device s holds chunks ``c pp + s`` (``interleave_layers``).

JAX's SPMD typing has no counterpart in one process: ``_pcast_to``,
``_tree_vma``, ``_widen``, ``_unwiden_grads``, the cond of ``_unit_fn``
and ``from_last_stage(_local_grad)``.  Gradients of a leaf every stage
holds (the head) are summed over the stages once, and the head runs once,
on the last stage's output.
"""

from __future__ import annotations

import heapq
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..ops.fused_update import _leaves, tree_from_leaves, tree_leaves, tree_map

Tree = Any


def stack_layers(layers: Sequence[Tree]) -> Tree:
    """[{w: [..]}, ...] -> {w: [L, ..]}: a homogeneous list of layer trees
    stacked on a new leading layer axis (the axis pp splits)."""
    paths = tuple(p for p, _ in _leaves(layers[0]))
    cols = zip(*(tree_leaves(lyr) for lyr in layers))
    return tree_from_leaves(paths, [torch.stack(c) for c in cols])


def unstack_layers(stacked: Tree) -> List[Tree]:
    """Inverse of ``stack_layers``: the layers' trees, views of the stack
    (one ``unbind`` a leaf, so autograd stacks a leaf's gradients once)."""
    pairs = _leaves(stacked)
    paths = tuple(p for p, _ in pairs)
    cols = [leaf.unbind(0) for _, leaf in pairs]
    return [tree_from_leaves(paths, [c[i] for c in cols])
            for i in range(len(cols[0]))]


def _maybe_remat(fn: Callable, remat: bool, *args):
    """``fn(*args)``, checkpointed when ``remat`` and grad is on."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def scan_layers(block_fn: Callable, stacked_params: Tree, x: torch.Tensor,
                *, remat: bool = False) -> torch.Tensor:
    """``block_fn(layer_params, x) -> x`` over a stacked ``[L, ...]`` slice;
    ``remat`` recomputes each layer in the backward (JAX's
    ``jax.checkpoint`` of the block)."""
    for lyr in unstack_layers(stacked_params):
        x = _maybe_remat(block_fn, remat, lyr, x)
    return x


def scan_layers_aux(block_fn: Callable, stacked_params: Tree,
                    x: torch.Tensor, *, remat: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``block_fn(layer_params, x) -> (x, aux)`` over a stacked slice,
    summing the layers' aux scalars in f32 (MoE's load-balance term)."""
    acc = torch.zeros((), dtype=torch.float32, device=x.device)
    for lyr in unstack_layers(stacked_params):
        x, aux = _maybe_remat(block_fn, remat, lyr, x)
        acc = acc + aux.to(torch.float32)
    return x, acc


def pipeline_apply(stage_fn: Callable, stage_params: Sequence[Tree],
                   x: torch.Tensor, num_microbatches: int) -> torch.Tensor:
    """``pipeline_apply_aux`` for an aux-free ``stage_fn(params, mb) ->
    mb``."""
    out, _ = pipeline_apply_aux(
        lambda p, mb: (stage_fn(p, mb), None), stage_params, x,
        num_microbatches)
    return out


def pipeline_apply_aux(stage_fn: Callable, stage_params: Sequence[Tree],
                       x: torch.Tensor, num_microbatches: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """GPipe over the stages ``stage_params`` (one tree a stage):
    ``stage_fn(params_s, mb) -> (mb, aux)`` applies stage s's slice to one
    microbatch and returns an aux scalar (None for a dense stack).  x:
    ``[B, ...]``, B a multiple of ``num_microbatches``.  Returns ``(out
    [B, ...], aux)``: aux is summed over the stages and averaged over the
    microbatches, as JAX's (its bubble ticks masked there, not run
    here)."""
    M = num_microbatches
    if x.shape[0] % M:
        raise ValueError(f"batch {x.shape[0]} does not split into "
                         f"{M} microbatches")
    n = len(stage_params)
    cur = list(x.split(x.shape[0] // M))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for t in range(M + n - 1):
        for s in range(max(0, t - M + 1), min(n, t + 1)):
            m = t - s
            cur[m], a = stage_fn(stage_params[s], cur[m])
            if a is not None:
                aux = aux + a.to(torch.float32)
    return torch.cat(cur), aux / M


# -- 1F1B ---------------------------------------------------------------------


def _split_tree(tree: Any, M: int) -> List[Any]:
    """A tree of ``[B, ...]`` tensors (tensors, tuples, lists, dicts) as M
    trees of ``[B / M, ...]`` microbatches."""
    if isinstance(tree, torch.Tensor):
        return list(tree.split(tree.shape[0] // M))
    if isinstance(tree, dict):
        parts = {k: _split_tree(v, M) for k, v in tree.items()}
        return [{k: parts[k][m] for k in tree} for m in range(M)]
    if isinstance(tree, (list, tuple)):
        parts = [_split_tree(v, M) for v in tree]
        return [type(tree)(p[m] for p in parts) for m in range(M)]
    raise TypeError(f"ctx leaf of type {type(tree).__name__}")


def _f32_zeros(tree: Tree) -> Tree:
    return tree_map(lambda t: torch.zeros(t.shape, dtype=torch.float32,
                                          device=t.device), tree)


class _Units:
    """The forward and backward work units both 1F1B schedulers run (the
    port of JAX's ``_unit_fn`` and the two conds of its tick body).  A
    unit is stage ``stage_fn`` on one microbatch, then the head when the
    unit produces the final activations; the loss channel is the stage's
    own loss plus the head's, the report channel rides along without
    gradient."""

    def __init__(self, stage_fn: Callable, loss_head_fn: Callable,
                 head_params: Tree, ctx: Any, M: int, report_len: int,
                 d_head: Tree, x_dtype: torch.dtype):
        self.stage_fn, self.loss_head_fn = stage_fn, loss_head_fn
        self.hp, self.M, self.R = head_params, M, report_len
        self.ctx = _split_tree(ctx, M)
        self.d_head, self.x_dtype = d_head, x_dtype
        self.loss = None
        self.report = None

    def _run(self, sp: Tree, hp: Tree, x_in: torch.Tensor, m: int,
             is_last: bool):
        c = self.ctx[m]
        out = self.stage_fn(sp, hp, x_in, c)
        h, loss = out[0], out[1].to(torch.float32)
        rep = out[2].to(torch.float32) if self.R else None
        if is_last:
            head = self.loss_head_fn(hp, h, c)
            if self.R:
                head, head_rep = head
                rep = rep + head_rep.to(torch.float32)
            loss = loss + head.to(torch.float32)
        return h, loss, rep

    def forward(self, sp: Tree, x_in: torch.Tensor, m: int,
                is_last: bool) -> torch.Tensor:
        """One forward unit without grad: the stage's output, its loss
        (over M) and report added to the accumulators."""
        with torch.no_grad():
            h, loss, rep = self._run(sp, self.hp, x_in, m, is_last)
        self.loss = loss / self.M if self.loss is None \
            else self.loss + loss / self.M
        if self.R:
            self.report = rep if self.report is None else self.report + rep
        return h.to(self.x_dtype)

    def backward(self, sp: Tree, d_sp: Tree, x_in: torch.Tensor, m: int,
                 is_last: bool, ct: Optional[torch.Tensor]) -> torch.Tensor:
        """One backward unit: the stage forward again from its saved input
        with grad on, differentiated with the loss channel seeded 1/M and
        the output seeded ``ct`` (the downstream cotangent; none on the
        unit that ran the head).  The stage's gradients are added in f32
        into ``d_sp``, the head's into ``d_head``; returns the input's
        cotangent in f32."""
        with torch.enable_grad():
            sp_l = tree_map(lambda t: t.detach().requires_grad_(), sp)
            hp_l = tree_map(lambda t: t.detach().requires_grad_(), self.hp)
            x_l = x_in.detach().requires_grad_()
            h, loss, _ = self._run(sp_l, hp_l, x_l, m, is_last)
            outs, seeds = [], []
            if loss.requires_grad:
                outs.append(loss)
                seeds.append(torch.full((), 1.0 / self.M,
                                        dtype=torch.float32,
                                        device=loss.device))
            if not is_last:
                outs.append(h)
                seeds.append(ct.to(h.dtype))
            p_sp, p_hp = tree_leaves(sp_l), tree_leaves(hp_l)
            gs = torch.autograd.grad(outs, p_sp + p_hp + [x_l], seeds,
                                     allow_unused=True)
        for acc, g in zip(tree_leaves(d_sp) + tree_leaves(self.d_head),
                          gs[:-1]):
            if g is not None:
                acc.add_(g)
        g_x = gs[-1]
        return (torch.zeros(x_in.shape, dtype=torch.float32,
                            device=x_in.device)
                if g_x is None else g_x.to(torch.float32))

    def result(self, d_stage, d_x: List[torch.Tensor], device):
        loss = (torch.zeros((), dtype=torch.float32, device=device)
                if self.loss is None else self.loss)
        out = (loss, d_stage, self.d_head, torch.cat(d_x))
        if self.R:
            return out + (self.report,)
        return out


def _check_mb(x: torch.Tensor, M: int) -> None:
    if x.shape[0] % M:
        raise ValueError(f"batch {x.shape[0]} does not split into "
                         f"{M} microbatches")


def pipeline_train_1f1b(stage_fn: Callable, loss_head_fn: Callable,
                        stage_params: Sequence[Tree], head_params: Tree,
                        x: torch.Tensor, ctx: Any, num_microbatches: int,
                        report_len: int = 0,
                        out: Optional[List[Tree]] = None,
                        stats: Optional[Dict[str, Any]] = None):
    """One forward and backward pass under the 1F1B schedule, returning
    the gradients (no outer backward).

    ``stage_fn(stage_params_s, head_params, x_in, ctx_mb) -> (x_out,
    stage_loss)``: stage s's slice on one microbatch and the stage's own
    per-microbatch loss (a zero when the stack has none);
    ``loss_head_fn(head_params, x_out, ctx_mb)``: the per-microbatch loss
    of the head, run after the last stage and added to its loss.  x:
    ``[B, ...]`` activations entering stage 0; ctx: a tree of ``[B, ...]``
    tensors microbatched alongside x and handed to every unit.  With
    ``report_len`` > 0 both callables return a third/second output, a
    report vector summed over the units (not over M) without gradient:
    the display channel.  ``out``: per-stage f32 trees to add the stage
    gradients into (zeros otherwise); ``stats``: filled with
    ``max_live``, the most saved inputs each stage held at once.

    Returns ``(loss, d_stage, d_head, d_x[, report])``: the mean over the
    microbatches of the units' losses; per-stage f32 gradients; the
    head's f32 gradient (every stage's units summed, JAX's psum over pp);
    d_x ``[B, ...]`` f32, the cotangent of x."""
    n, M = len(stage_params), num_microbatches
    _check_mb(x, M)
    x_mb = list(x.split(x.shape[0] // M))
    d_stage = out if out is not None else [_f32_zeros(p)
                                           for p in stage_params]
    units = _Units(stage_fn, loss_head_fn, head_params, ctx, M, report_len,
                   _f32_zeros(head_params), x.dtype)
    saved: List[List[Optional[torch.Tensor]]] = [[None] * n
                                                 for _ in range(n)]
    max_live = [0] * n
    d_x: List[torch.Tensor] = [None] * M
    act_in: List[Optional[torch.Tensor]] = [None] * n    # arrivals this tick
    ct_in: List[Optional[torch.Tensor]] = [None] * n
    for t in range(2 * (M + n) - 2):
        act_out: List[Optional[torch.Tensor]] = [None] * n
        ct_out: List[Optional[torch.Tensor]] = [None] * n
        for s in range(n):
            is_last = s == n - 1
            if (t - s) % 2 == 0 and 0 <= (t - s) // 2 < M:          # fwd
                m = (t - s) // 2
                x_in = x_mb[m] if s == 0 else act_in[s]
                assert saved[s][m % n] is None
                saved[s][m % n] = x_in
                max_live[s] = max(max_live[s], sum(
                    v is not None for v in saved[s]))
                act_out[s] = units.forward(stage_params[s], x_in, m, is_last)
            b = t - (2 * n - 1 - s)
            if b % 2 == 0 and 0 <= b // 2 < M:                      # bwd
                m = b // 2
                x_in, saved[s][m % n] = saved[s][m % n], None
                g_x = units.backward(stage_params[s], d_stage[s], x_in, m,
                                     is_last, None if is_last else ct_in[s])
                if s == 0:
                    d_x[m] = g_x
                else:
                    ct_out[s] = g_x
        # both rings rotate: activations down, cotangents up
        act_in = [act_out[(s - 1) % n] for s in range(n)]
        ct_in = [ct_out[(s + 1) % n] for s in range(n)]
    if stats is not None:
        stats["max_live"] = max_live
    return units.result(d_stage, d_x, x.device)


def cost_model(num_microbatches: int, pp: int, schedule: str = "gpipe",
               virtual_stages: int = 1) -> dict:
    """The bubble and memory arithmetic of a schedule, JAX's numbers (a
    tick is one unit a stage; GPipe's counts the forward ticks, whose
    bubble JAX computes on garbage and this port skips; 1F1B's live
    activations are the saved inputs a stage holds at most; the
    interleaved schedule's are read off its verified tables)."""
    if num_microbatches < 1 or pp < 1:
        raise ValueError((num_microbatches, pp))
    M = num_microbatches
    if schedule == "gpipe":
        ticks = M + pp - 1
        return {"schedule": "gpipe", "num_microbatches": M, "pp": pp,
                "ticks": ticks, "bubble_ticks": pp - 1,
                "bubble_fraction": (pp - 1) / ticks,
                "utilization": M / ticks,
                "live_activations_per_stage": M}
    if schedule == "1f1b":
        ticks = 2 * (M + pp) - 2
        return {"schedule": "1f1b", "num_microbatches": M, "pp": pp,
                "ticks": ticks, "bubble_ticks": 2 * pp - 2,
                "bubble_fraction": (2 * pp - 2) / ticks,
                "utilization": 2 * M / ticks,
                "live_activations_per_stage": min(M, pp)}
    if schedule == "1f1b-interleaved":
        v = virtual_stages
        t = _interleaved_tables(pp, v, M)
        ticks = t["T"]
        ideal = 2 * v * M
        return {"schedule": "1f1b-interleaved", "num_microbatches": M,
                "pp": pp, "virtual_stages": v, "ticks": ticks,
                "bubble_ticks": ticks - ideal,
                "bubble_fraction": (ticks - ideal) / ticks,
                "bubble_full_stage_units": (ticks - ideal) / v,
                "utilization": ideal / ticks,
                "live_activations_per_stage": t["n_aslots"]}
    raise ValueError(f"unknown schedule {schedule!r}")


# -- interleaved (virtual-stage) 1F1B ----------------------------------------


def _alloc_slots(intervals):
    """Greedy interval-graph colouring: ``intervals`` = [(start, end, key)]
    inclusive; returns ({key: slot}, n_slots), each slot's lifetimes
    disjoint (checked)."""
    assign, free, n = {}, [], 0
    for start, end, key in sorted(intervals):
        # pop every slot freed strictly before `start`, reuse the lowest
        ready = []
        while free and free[0][0] < start:
            ready.append(heapq.heappop(free)[1])
        if ready:
            slot = min(ready)
            for r in ready:
                if r != slot:
                    heapq.heappush(free, (start - 1, r))
        else:
            slot = n
            n += 1
        assign[key] = slot
        heapq.heappush(free, (end, slot))
    by_slot = {}
    for start, end, key in intervals:
        by_slot.setdefault(assign[key], []).append((start, end))
    for sl, ivs in by_slot.items():
        ivs.sort()
        for (s1, e1), (s2, e2) in zip(ivs, ivs[1:]):
            assert e1 < s2, ("slot lifetime overlap", sl, (s1, e1), (s2, e2))
    return assign, n


def _interleaved_tables(pp: int, v: int, M: int):
    """Static lockstep schedule of interleaved 1F1B (Megatron order), as
    JAX builds it: virtual stage u in [0, v pp) holds layer chunk u, on
    device u % pp; per device W(s) warm-up forwards (``2 (pp - s - 1) +
    (v - 1) pp``, capped), then strict alternation, then the cool-down
    backwards; ticks by earliest-feasible list scheduling under the ring
    dependencies, one unit a device a tick; verified here (every unit
    once, the orderings strict, slot lifetimes disjoint).  Returns numpy
    tables [T, pp]: KIND (0 idle / 1 fwd / 2 bwd), MB, CH, ASLOT (the
    unit's act slot), CTSLOT (bwd cotangent slot; -1 = the head's seed),
    ISU0 (input from x), ISHEAD (virtual stage P - 1), RA / RC (slot the
    activation / cotangent arriving this tick lands in; -1 none), and
    (T, n_aslots, n_cslots)."""
    P = v * pp
    if M % pp:
        raise ValueError(
            f"interleaved 1F1B needs num_microbatches {M} % pp {pp} == 0 "
            f"(the chunk rotation covers pp microbatches per segment)")
    vM = v * M

    def chunk_of(vmid, fwd):
        c = (vmid % (v * pp)) // pp
        return c if fwd else v - 1 - c

    def mb_of(vmid):
        return (vmid // (v * pp)) * pp + vmid % pp

    orders = []
    for s in range(pp):
        W = min(pp - s - 1 if v == 1
                else 2 * (pp - s - 1) + (v - 1) * pp, vM)
        seq, fi, bi = [], 0, 0
        for _ in range(W):
            seq.append(("F", mb_of(fi), chunk_of(fi, True)))
            fi += 1
        while fi < vM:
            seq.append(("F", mb_of(fi), chunk_of(fi, True)))
            fi += 1
            seq.append(("B", mb_of(bi), chunk_of(bi, False)))
            bi += 1
        while bi < vM:
            seq.append(("B", mb_of(bi), chunk_of(bi, False)))
            bi += 1
        orders.append(seq)

    tick_f, tick_b = {}, {}
    ptr = [0] * pp
    rows = []
    t = 0
    while any(p < 2 * vM for p in ptr):
        row = {}
        for s in range(pp):
            if ptr[s] >= 2 * vM:
                continue
            kind, m, c = orders[s][ptr[s]]
            u = c * pp + s
            if kind == "F":
                ok = u == 0 or tick_f.get((m, u - 1), t) < t
            elif u == P - 1:
                ok = tick_f.get((m, u), t) < t
            else:
                ok = tick_b.get((m, u + 1), t) < t
            if ok:
                row[s] = (kind, m, c)
                (tick_f if kind == "F" else tick_b)[(m, u)] = t
                ptr[s] += 1
        rows.append(row)
        t += 1
        if t > 100 * vM + 100:
            raise AssertionError(f"schedule non-convergence pp={pp} v={v}")
    T = t

    for m in range(M):                       # verify, don't trust
        for u in range(P):
            assert (m, u) in tick_f and (m, u) in tick_b, (m, u)
            if u > 0:
                assert tick_f[(m, u)] > tick_f[(m, u - 1)]
                assert tick_b[(m, u)] < tick_b[(m, u - 1)]
            assert tick_b[(m, u)] > tick_f[(m, u)]

    aslot, cslot = {}, {}
    n_as = n_cs = 0
    for s in range(pp):
        a_iv, c_iv = [], []
        for c in range(v):
            u = c * pp + s
            for m in range(M):
                a0 = tick_f[(m, u - 1)] + 1 if u > 0 else tick_f[(m, u)]
                a_iv.append((a0, tick_b[(m, u)], (m, u)))
                if u < P - 1:
                    c_iv.append((tick_b[(m, u + 1)] + 1,
                                 tick_b[(m, u)], (m, u)))
        amap, na = _alloc_slots(a_iv)
        cmap, nc = _alloc_slots(c_iv)
        aslot.update({(s,) + k: sl for k, sl in amap.items()})
        cslot.update({(s,) + k: sl for k, sl in cmap.items()})
        n_as, n_cs = max(n_as, na), max(n_cs, nc)

    shape = (T, pp)
    KIND = np.zeros(shape, np.int32)
    MB = np.zeros(shape, np.int32)
    CH = np.zeros(shape, np.int32)
    ASLOT = np.zeros(shape, np.int32)
    CTSLOT = np.full(shape, -1, np.int32)
    ISU0 = np.zeros(shape, np.int32)
    ISHEAD = np.zeros(shape, np.int32)
    RA = np.full(shape, -1, np.int32)
    RC = np.full(shape, -1, np.int32)
    for t2, row in enumerate(rows):
        for s, (kind, m, c) in row.items():
            u = c * pp + s
            KIND[t2, s] = 1 if kind == "F" else 2
            MB[t2, s] = m
            CH[t2, s] = c
            ASLOT[t2, s] = aslot[(s, m, u)]
            ISU0[t2, s] = int(u == 0)
            ISHEAD[t2, s] = int(u == P - 1)
            if kind == "F" and u < P - 1:
                sd = (u + 1) % pp          # arrival lands downstream next tick
                assert RA[t2 + 1, sd] == -1
                RA[t2 + 1, sd] = aslot[(sd, m, u + 1)]
            if kind == "B":
                if u < P - 1:
                    CTSLOT[t2, s] = cslot[(s, m, u)]
                if u > 0:
                    su = (u - 1) % pp      # cotangent lands upstream next tick
                    assert RC[t2 + 1, su] == -1
                    RC[t2 + 1, su] = cslot[(su, m, u - 1)]
    return dict(T=T, n_aslots=n_as, n_cslots=n_cs, KIND=KIND, MB=MB, CH=CH,
                ASLOT=ASLOT, CTSLOT=CTSLOT, ISU0=ISU0, ISHEAD=ISHEAD,
                RA=RA, RC=RC)


def pipeline_train_1f1b_interleaved(stage_fn: Callable,
                                    loss_head_fn: Callable,
                                    stage_params: Sequence[Tree],
                                    head_params: Tree, x: torch.Tensor,
                                    ctx: Any, num_microbatches: int,
                                    virtual_stages: int,
                                    report_len: int = 0,
                                    out: Optional[List[Tree]] = None,
                                    stats: Optional[Dict[str, Any]] = None):
    """Interleaved 1F1B: ``pipeline_train_1f1b`` with each stage's leaves
    carrying a leading ``[virtual_stages]`` chunk axis, chunk c of stage s
    being virtual stage ``c pp + s``; ``stage_fn`` receives one chunk's
    params.  num_microbatches must be a multiple of pp.  The units run
    at the ticks of ``_interleaved_tables``; an arriving activation or
    cotangent waits in its statically allocated slot until its unit
    runs (warm-up forwards are one tick apart, steady state two), and an
    act slot doubles as the unit's saved input until its backward.
    ``d_stage`` keeps the chunk axis; ``stats["max_live"]``: the most act
    slots a stage held at once."""
    n, M, v = len(stage_params), num_microbatches, virtual_stages
    _check_mb(x, M)
    tb = _interleaved_tables(n, v, M)
    x_mb = list(x.split(x.shape[0] // M))
    d_stage = out if out is not None else [_f32_zeros(p)
                                           for p in stage_params]
    units = _Units(stage_fn, loss_head_fn, head_params, ctx, M, report_len,
                   _f32_zeros(head_params), x.dtype)

    def chunk(tree, c):
        return tree_map(lambda t: t[c], tree)

    abuf = [[None] * tb["n_aslots"] for _ in range(n)]
    cbuf = [[None] * tb["n_cslots"] for _ in range(n)]
    max_live = [0] * n
    d_x: List[torch.Tensor] = [None] * M
    act_in: List[Optional[torch.Tensor]] = [None] * n
    ct_in: List[Optional[torch.Tensor]] = [None] * n
    for t in range(tb["T"]):
        act_out: List[Optional[torch.Tensor]] = [None] * n
        ct_out: List[Optional[torch.Tensor]] = [None] * n
        for s in range(n):
            # arrivals first: each lands in its statically assigned slot
            ra, rc = tb["RA"][t, s], tb["RC"][t, s]
            if ra >= 0:
                abuf[s][ra] = act_in[s]
            if rc >= 0:
                cbuf[s][rc] = ct_in[s]
            kind = tb["KIND"][t, s]
            if kind == 0:
                continue
            m, c, sl = int(tb["MB"][t, s]), int(tb["CH"][t, s]), \
                int(tb["ASLOT"][t, s])
            is_head = bool(tb["ISHEAD"][t, s])
            if kind == 1:
                if tb["ISU0"][t, s]:
                    abuf[s][sl] = x_mb[m]
                max_live[s] = max(max_live[s], sum(
                    a is not None for a in abuf[s]))
                act_out[s] = units.forward(chunk(stage_params[s], c),
                                           abuf[s][sl], m, is_head)
            else:
                x_in, abuf[s][sl] = abuf[s][sl], None
                csl = int(tb["CTSLOT"][t, s])
                ct = None
                if not is_head:
                    ct, cbuf[s][csl] = cbuf[s][csl], None
                g_x = units.backward(chunk(stage_params[s], c),
                                     chunk(d_stage[s], c), x_in, m,
                                     is_head, ct)
                if tb["ISU0"][t, s]:
                    d_x[m] = g_x
                else:
                    ct_out[s] = g_x
        act_in = [act_out[(s - 1) % n] for s in range(n)]
        ct_in = [ct_out[(s + 1) % n] for s in range(n)]
    if stats is not None:
        stats["max_live"] = max_live
    return units.result(d_stage, d_x, x.device)


def _layer_perm(L: int, pp: int, v: int) -> List[int]:
    """Model layer of each row of the interleaved stack: row ``s (L / pp)
    + c Lc + j`` holds model layer ``(c pp + s) Lc + j``."""
    Lc = L // (v * pp)
    if L % (v * pp):
        raise ValueError(f"{L} layers do not split into {v} chunks on "
                         f"each of {pp} stages")
    return [(c * pp + s) * Lc + j
            for s in range(pp) for c in range(v) for j in range(Lc)]


def interleave_layers(stacked: Tree, pp: int, v: int) -> Tree:
    """A model-order stacked ``[L, ...]`` layer tree permuted into the
    device-major order the interleaved scheduler splits, so stage s's
    contiguous ``L / pp`` rows are its chunks ``c pp + s``."""
    def one(a):
        return a[torch.tensor(_layer_perm(a.shape[0], pp, v),
                              device=a.device)]
    return tree_map(one, stacked)


def deinterleave_layers(stacked: Tree, pp: int, v: int) -> Tree:
    """Inverse of ``interleave_layers`` (params or gradients back in model
    order)."""
    def one(a):
        perm = _layer_perm(a.shape[0], pp, v)
        inv = [0] * len(perm)
        for new, old in enumerate(perm):
            inv[old] = new
        return a[torch.tensor(inv, device=a.device)]
    return tree_map(one, stacked)
