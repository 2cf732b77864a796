"""The model checker's core, the port of the JAX package's
``verify/mc.py``: exhaustive explicit-state model checking + the
randomized fuzz scheduler, over the shared op-stream models
(`verify.opstream`).

Checked properties, per cell of the (route x n x S x depth) grid:

  deadlock freedom   some action is enabled until every node's program
                     and every in-flight transfer has retired;
  slot overwrite     a landing never hits an undecoded frame, an encode
                     never overwrites an in-flight frame;
  decode ordering    every decode finds exactly the emission the
                     schedule expects; no payload is orphaned;
  credit safety      semaphore counts never exceed the window
                     (boundedness) and never leak at termination
                     (non-negativity is structural: waits block);
  termination        the exhaustive exploration itself is finite and
                     every maximal path ends in the final state;
  DMA discipline     (static, per node) single wait per DMA, no wait
                     before start, declared slot-reuse/RAW predecessors
                     waited, full drain at exit.

Exploration: depth-first over the interleaving graph with state hashing
at branch points and a persistent-set partial-order reduction: at each
state, one action that commutes with every other enabled action (wire
landings into distinct slots, local node steps) is executed alone;
branching happens only where genuinely dependent actions race (a
landing vs the decode of its slot, an encode vs the in-flight frame it
would overwrite).  Any action whose violation condition is already live
is explored immediately — the schedule freedom that fires it exists, so
that path IS the counterexample.  The interleaving graph is a DAG
(program counters and transfer sets strictly advance), so the classic
cycle proviso is vacuous; docs/MODELCHECK.md carries the full soundness
argument.  `check(por=False)` runs the naive full-DFS for the
POR-vs-naive state-count comparison the corpus reports.

The randomized mode (`run_random`) executes the SAME model under a
seeded scheduler — it is `ops.ring_cuda.simulate_rs_protocol`'s
backend, and the corpus uses it as the seed-sweep fuzz beyond the
exhaustive envelope (n = 8).
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, Iterable, List, Optional,
                    Sequence, Set, Tuple)

from . import opstream
from .opstream import (GatherModel, PairModel, ProtocolError, RingModel,
                       reshard_owners)
from .sched import SchedModel, build_sched, sched_cells

# The exhaustive envelope (per route; ROADMAP acceptance): every cell
# with n <= N_MAX, S <= S_MAX, depth <= D_MAX is explored EXHAUSTIVELY
# by `python -m fpga_ai_nic_tpu_torch.verify`; beyond it the randomized fuzz sweeps seeds.
N_MAX = 6
S_MAX = 6
D_MAX = 4
FUZZ_N = 8
FUZZ_SEEDS = 3

# POR-vs-naive comparison cells (small enough for the naive full DFS):
# reported by the corpus, pinned >= 5x by tests/test_torch_verify.py
COMPARE_CELLS: Tuple[Tuple[int, int, int], ...] = ((2, 2, 2), (3, 2, 1))

DEFAULT_MAX_STATES = 2_000_000


class Violation(AssertionError):
    """A protocol violation with its interleaving attached.  Subclasses
    AssertionError so `simulate_rs_protocol` callers keep their
    ``pytest.raises(AssertionError, match=...)`` contracts."""

    def __init__(self, kind: str, message: str,
                 trace: Tuple[Any, ...] = (),
                 meta: Optional[Dict[str, Any]] = None) -> None:
        super().__init__(message)
        self.kind = kind
        self.message = message
        self.trace = trace
        self.meta = dict(meta or {})


@dataclass
class CheckResult:
    """Outcome of one exhaustive exploration."""

    ok: bool
    states: int                    # transitions applied
    branch_points: int             # states where dependent actions raced
    terminal_paths: int
    por: bool
    meta: Dict[str, Any] = field(default_factory=dict)
    violation: Optional[Violation] = None

    @property
    def inconclusive(self) -> bool:
        """True when the exploration hit the state budget: NOT a
        protocol verdict in either direction (still fails the corpus —
        an unverified cell cannot be claimed verified — but is reported
        as inconclusive, with no counterexample export)."""
        return self.violation is not None and self.violation.kind == "budget"


def _unroll_trace(trace: Optional[Tuple[Any, Any]]) -> Tuple[Any, ...]:
    out: List[Any] = []
    while trace is not None:
        entry, trace = trace
        out.append(entry)
    out.reverse()
    return tuple(out)


def check(model: Any, por: bool = True,
          max_states: int = DEFAULT_MAX_STATES) -> CheckResult:
    """Exhaustively explore every inequivalent interleaving of ``model``.
    Returns a CheckResult; a violation is returned (not raised) with its
    counterexample trace attached."""
    res = CheckResult(ok=True, states=0, branch_points=0,
                      terminal_paths=0, por=por,
                      meta=dict(getattr(model, "meta", {})))
    st = model.init_state()
    stack = [st]
    seen: Set[Tuple[Any, ...]] = set()
    cur = st          # the state being advanced — carries the violation
    try:              # trace (apply records the action before checking)
        while stack:
            st = stack.pop()
            cur = st
            while True:
                if model.finished(st):
                    model.check_terminal(st)
                    res.terminal_paths += 1
                    break
                acts = model.enabled(st)
                if not acts:
                    raise ProtocolError("deadlock",
                                        model.deadlock_message(st))
                act = model.pick_action(st, acts) if por else None
                if act is not None:
                    res.states += 1
                    if res.states > max_states:
                        raise ProtocolError(
                            "budget",
                            f"state budget exceeded ({max_states}) — "
                            "exploration INCONCLUSIVE, not a protocol "
                            "verdict; raise max_states")
                    model.apply(st, act)
                    continue
                key = st.key()
                if key in seen:
                    break
                seen.add(key)
                res.branch_points += 1
                for act in acts:
                    child = st.clone()
                    res.states += 1
                    if res.states > max_states:
                        raise ProtocolError(
                            "budget",
                            f"state budget exceeded ({max_states}) — "
                            "exploration INCONCLUSIVE, not a protocol "
                            "verdict; raise max_states")
                    cur = child
                    model.apply(child, act)
                    stack.append(child)
                cur = st
                break
    except ProtocolError as e:
        res.ok = False
        res.violation = Violation(e.kind, e.message,
                                  trace=_unroll_trace(cur.trace),
                                  meta=res.meta)
    return res


def run_random(model: Any, seed: int = 0,
               max_events: int = 2_000_000) -> int:
    """Randomized-scheduler execution of one interleaving — the fuzz
    backend (`simulate_rs_protocol` delegates here).  Raises Violation
    (an AssertionError) on any protocol failure; returns the number of
    scheduler events on success."""
    rng = random.Random(seed)
    st = model.init_state()
    events = 0
    while True:
        acts = model.enabled(st)
        if not acts:
            if model.finished(st):
                try:
                    model.check_terminal(st)
                except ProtocolError as e:
                    raise Violation(e.kind, e.message,
                                    trace=_unroll_trace(st.trace)) from None
                return events
            raise Violation("deadlock", model.deadlock_message(st),
                            trace=_unroll_trace(st.trace))
        events += 1
        if events > max_events:
            raise Violation("termination", "scheduler did not terminate",
                            trace=_unroll_trace(st.trace))
        act = acts[rng.randrange(len(acts))]
        try:
            model.apply(st, act)
        except ProtocolError as e:
            raise Violation(e.kind, e.message,
                            trace=_unroll_trace(st.trace)) from None


# ---------------------------------------------------------------------------
# route builders: one model per grid cell
# ---------------------------------------------------------------------------

def build_flat(n: int, S: int, depth: int,
               integrity: bool = False) -> RingModel:
    ops, n_slots = opstream.rs_op_stream(n, S, depth,
                                         integrity=integrity)
    return RingModel(n, ops, n_slots,
                     meta={"route": "flat", "n": n, "S": S, "depth": depth,
                           **({"integrity": True} if integrity else {})})


def build_streaming(n: int, S: int, depth: int,
                    opt_kind: Optional[str] = None,
                    integrity: bool = False) -> RingModel:
    ops, n_slots = opstream.rs_stream_op_stream(n, S, depth,
                                                opt_kind=opt_kind,
                                                integrity=integrity)
    return RingModel(n, ops, n_slots,
                     meta={"route": "streaming", "n": n, "S": S,
                           "depth": depth, "opt": opt_kind or "none",
                           **({"integrity": True} if integrity else {})})


def build_ag(n: int, S: int,
             phys_slots: Optional[int] = None) -> RingModel:
    """The streaming all-gather's interleaved emission schedule under
    the full wait/credit protocol.  ``phys_slots`` overrides the
    MODEL's slot window only (the protocol stream keeps its planned
    window) — the anti-vacuity shrink: one physical slot fewer than the
    plan must overwrite."""
    ops, n_slots = opstream.ag_op_stream(n, S)
    return RingModel(n, ops,
                     n_slots if phys_slots is None else phys_slots,
                     meta={"route": "ag", "n": n, "S": S,
                           **({"phys_slots": phys_slots}
                              if phys_slots is not None else {})})


def build_hier(n: int, ni: int, s_inter: int,
               integrity: bool = False) -> PairModel:
    streams = opstream.hier_op_stream(n, ni, s_inter,
                                      integrity=integrity)
    return PairModel(streams, meta={"route": "hier", "n": n, "ni": ni,
                                    "S": s_inter,
                                    **({"integrity": True}
                                       if integrity else {})})


def build_handoff(n_layers: int, integrity: bool = False) -> PairModel:
    streams = opstream.handoff_op_stream(n_layers, integrity=integrity)
    return PairModel(streams, meta={"route": "handoff",
                                    "n_layers": n_layers,
                                    "integrity": integrity})


def reshard_layout(live: int, n_src: int, n_tgt: int
                   ) -> Tuple[int, int, int]:
    """(chunk_src, chunk_tgt, n_union) of a grid cell under the default
    ceil-padding — a thin view over THE union arithmetic
    (`opstream.union_layout`, which `parallel.reshard.make_plan` also
    consumes: one definition)."""
    padded_src = -(-live // n_src) * n_src
    padded_tgt = -(-live // n_tgt) * n_tgt
    cs, ct, nu, _seed = opstream.union_layout(live, n_src, padded_src,
                                              n_tgt, padded_tgt)
    return cs, ct, nu


def build_reshard(live: int, n_src: int, n_tgt: int,
                  residual: bool = False,
                  integrity: bool = False,
                  n_flat_leaves: int = 1) -> PairModel:
    chunk_src, chunk_tgt, n_union = reshard_layout(live, n_src, n_tgt)
    owners = reshard_owners(n_src, n_tgt) if residual else None
    streams = opstream.reshard_op_stream(live, chunk_src, chunk_tgt,
                                         n_union, owners,
                                         n_flat_leaves=n_flat_leaves,
                                         integrity=integrity)
    return PairModel(streams, meta={"route": "reshard", "live": live,
                                    "n_src": n_src, "n_tgt": n_tgt,
                                    "residual": residual,
                                    **({"integrity": True}
                                       if integrity else {})})


def flat_cells() -> List[Tuple[int, int, int]]:
    return [(n, S, D) for n in range(2, N_MAX + 1)
            for S in range(1, S_MAX + 1) for D in range(1, D_MAX + 1)]


def ag_cells() -> List[Tuple[int, int]]:
    return [(n, S) for n in range(2, N_MAX + 1)
            for S in range(1, S_MAX + 1)]


def hier_cells() -> List[Tuple[int, int, int]]:
    return [(n, ni, s) for n in range(2, N_MAX + 1)
            for ni in range(1, n + 1) if n % ni == 0
            for s in (1, 2)]


def handoff_cells() -> List[Tuple[int, bool]]:
    # n_layers spans trivial -> multi-block; integrity adds the ledger
    # chk pairs + the verdict exchange (the route M2 audits)
    return [(L, integ) for L in (1, 2, 3) for integ in (False, True)]


def build_gather(n_pages: int, n_live: int, depth: int) -> GatherModel:
    """The paged gather-attend kernel's per-(request, kv-head) DMA
    schedule (`opstream.paged_attend_op_stream` — the one definition
    the JAX package's `ops.paged_attend_pallas` also lowers) as a single-node async-DMA
    model: `check` explores the landing interleavings for semaphore-slot
    aliasing, and `_static_violations` runs the exact live-page coverage
    pass (`opstream.check_gather_coverage`) plus the generic DMA
    discipline first."""
    ops = opstream.paged_attend_op_stream(n_pages, n_live, depth)
    return GatherModel(ops, depth,
                       meta={"route": "gather", "P": n_pages,
                             "n_live": n_live, "depth": depth})


def gather_cells() -> List[Tuple[int, int, int]]:
    # every occupancy of every table width up to N_MAX, per buffer
    # depth — n_live == 0 (all-dead row: an inactive slot's schedule)
    # and depth > P (the prologue clamp) are both in-envelope
    return [(P, nl, d) for P in range(1, N_MAX + 1)
            for nl in range(0, P + 1) for d in (1, 2, 3)]


def reshard_cells() -> List[Tuple[int, int, int, bool]]:
    # 48 divides evenly almost everywhere; 37 is prime — every chunk
    # boundary of either layout cuts (the nothing-divides-anything case)
    cells = []
    for live in (48, 37):
        for ns in range(2, N_MAX + 1):
            for nt in range(2, N_MAX + 1):
                if ns == nt:
                    continue
                for residual in (False, True):
                    cells.append((live, ns, nt, residual))
    return cells


# ---------------------------------------------------------------------------
# the corpus: everything `python -m fpga_ai_nic_tpu_torch.verify` runs
# (CPU-only, < 60 s)
# ---------------------------------------------------------------------------

@dataclass
class CellReport:
    route: str
    cell: Tuple[Any, ...]
    states: int
    branch_points: int
    ok: bool
    message: str = ""


@dataclass
class RouteStats:
    """One route's share of the corpus: a row of the envelope record
    (`envelope_record`)."""

    route: str
    cells: int = 0
    states: int = 0
    branch_points: int = 0
    wall_s: float = 0.0


@dataclass
class CorpusStats:
    cells: int = 0
    states: int = 0
    branch_points: int = 0
    fuzz_runs: int = 0
    routes: List[RouteStats] = field(default_factory=list)
    compare: List[Dict[str, Any]] = field(default_factory=list)
    failures: List[CellReport] = field(default_factory=list)
    wall_s: float = 0.0


def _mc_findings(route: str, cell: Tuple[Any, ...], message: str,
                 code: str = "M1") -> "Any":
    from ..lint.findings import Finding
    return Finding(code, f"<mc:{route}>", 0,
                   f"cell {cell}: {message}")


def _static_violations(model: Any) -> List[Tuple[str, str]]:
    """The static pre-passes over a model's streams, no interleaving
    needed: per-node DMA discipline (single wait, ordered hazards, full
    drain) on RingModel streams, and the M2 checksum-weight pass
    (oddness, 1:1 emit/arrive pairing, program-distinctness) on every
    stream.  Returns (kind, message) pairs."""
    out: List[Tuple[str, str]] = []
    if isinstance(model, RingModel):
        dma = opstream.check_dma_discipline(model.ops)
        if dma:
            out.append(("dma", "; ".join(dma)))
        m2 = opstream.check_weight_conservation(model.ops)
    elif isinstance(model, GatherModel):
        dma = opstream.check_dma_discipline(model.ops)
        cov = opstream.check_gather_coverage(
            model.ops, model.meta["P"], model.meta["n_live"])
        if dma or cov:
            out.append(("dma", "; ".join(dma + cov)))
        m2 = opstream.check_weight_conservation(model.ops)
    elif isinstance(model, SchedModel):
        # the control-plane family carries no op streams — its static
        # pre-pass is the validate_shape analogue (a lone request must
        # fit one pool, or the liveness claim is forfeit unexplored)
        shape = model.shape_violations()
        if shape:
            out.append(("shape", "; ".join(shape)))
        m2 = []
    else:
        m2 = opstream.check_weight_conservation(model.streams)
    if m2:
        out.append(("weights", "; ".join(m2)))
    return out


def run_cell(route: str, cell: Tuple[Any, ...],
             max_states: int = DEFAULT_MAX_STATES
             ) -> Tuple[CheckResult, Any]:
    """Build and exhaustively check one grid cell; returns the
    CheckResult and the model (for replay).  The static passes (DMA
    discipline, M2 weight conservation) run first — deterministic, no
    interleaving needed."""
    builder: Dict[str, Callable[..., Any]] = {
        "flat": build_flat, "streaming": build_streaming,
        "ag": build_ag, "hier": build_hier, "reshard": build_reshard,
        "handoff": build_handoff, "gather": build_gather,
        "sched": build_sched}
    model = builder[route](*cell)
    static = _static_violations(model)
    if static:
        res = CheckResult(ok=False, states=0, branch_points=0,
                          terminal_paths=0, por=True,
                          meta=dict(model.meta))
        res.violation = Violation(static[0][0],
                                  "; ".join(m for _, m in static))
        return res, model
    return check(model, por=True, max_states=max_states), model


def run_corpus(emit: Optional[Callable[[str], None]] = None,
               counterexample_dir: Optional[str] = None
               ) -> Tuple[List[Any], CorpusStats]:
    """The full bounded corpus: exhaustive over the envelope for all
    four routes, POR-vs-naive comparison on the reported cells, and the
    randomized seed-sweep fuzz beyond the envelope (n = 8).  Returns
    (findings, stats); findings non-empty => the CLI exits 1."""
    import time
    t_corpus = time.perf_counter()
    log = emit or (lambda s: None)
    findings: List[Any] = []
    stats = CorpusStats()

    def sweep(route: str, cells: Iterable[Tuple[Any, ...]]) -> None:
        t0 = time.perf_counter()
        rs = RouteStats(route=route)
        for cell in cells:
            res, model = run_cell(route, cell)
            rs.cells += 1
            rs.states += res.states
            rs.branch_points += res.branch_points
            stats.branch_points += res.branch_points
            if not res.ok:
                assert res.violation is not None
                msg = f"{res.violation.kind}: {res.violation.message}"
                code = "M2" if res.violation.kind == "weights" else "M1"
                stats.failures.append(CellReport(
                    route, cell, res.states, res.branch_points, False,
                    msg))
                findings.append(_mc_findings(route, cell, msg, code=code))
                if counterexample_dir is not None \
                        and not res.inconclusive \
                        and res.violation.trace:
                    from . import replay
                    replay.export_counterexample(
                        model, res.violation, counterexample_dir)
        rs.wall_s = time.perf_counter() - t0
        stats.routes.append(rs)
        stats.cells += rs.cells
        stats.states += rs.states
        log(f"[graftmc] route {route}: {rs.cells} cells exhaustive, "
            f"{rs.states} states, {rs.wall_s:.2f}s")

    # integrity variants ride every route whose lowering carries the
    # checksum ops — the chk pairs join the explored streams and
    # the M2 static pass audits their weights per cell
    sweep("flat", [c + (integ,) for c in flat_cells()
                   for integ in (False, True)])
    sweep("streaming", [c + v for c in flat_cells()
                        for v in ((None, False), ("adamw", False),
                                  (None, True), ("adamw", True))])
    sweep("ag", ag_cells())
    sweep("hier", [c + (integ,) for c in hier_cells()
                   for integ in (False, True)])
    sweep("reshard", [c + (integ,) for c in reshard_cells()
                      for integ in (False, True)])
    sweep("handoff", handoff_cells())
    sweep("gather", gather_cells())
    sweep("sched", sched_cells())

    # POR-vs-naive comparison on the reported cells (flat route; the
    # naive full DFS is only tractable on small cells)
    for cell in COMPARE_CELLS:
        res_por, _ = run_cell("flat", cell)
        res_naive = check(build_flat(*cell), por=False)
        stats.compare.append({
            "cell": cell, "por_states": res_por.states,
            "naive_states": res_naive.states,
            "agree": res_por.ok == res_naive.ok,
            "reduction": (res_naive.states / max(1, res_por.states)),
        })
        if res_por.ok != res_naive.ok:
            findings.append(_mc_findings(
                "flat", cell,
                "POR and naive DFS disagree on the verdict — the "
                "reduction is unsound for this cell"))
        log(f"[graftmc] POR vs naive on flat{cell}: "
            f"{res_por.states} vs {res_naive.states} states "
            f"({res_naive.states / max(1, res_por.states):.1f}x)")

    # fuzz beyond the exhaustive envelope: n = 8 randomized seed sweep
    # (the old simulate_rs_protocol coverage, now on the shared model)
    for route, build in (("flat", build_flat),
                         ("streaming", build_streaming)):
        for S in (2, 4):
            for depth in (2, 4):
                for seed in range(FUZZ_SEEDS):
                    stats.fuzz_runs += 1
                    try:
                        run_random(build(FUZZ_N, S, depth), seed=seed)
                    except Violation as v:
                        findings.append(_mc_findings(
                            route, (FUZZ_N, S, depth, seed),
                            f"fuzz {v.kind}: {v.message}"))
    log(f"[graftmc] fuzz beyond envelope: {stats.fuzz_runs} runs at "
        f"n={FUZZ_N}")
    stats.wall_s = time.perf_counter() - t_corpus
    return findings, stats


def envelope_record(stats: CorpusStats) -> Dict[str, Any]:
    """The corpus as a record: per-route cell counts / states / branch
    points / wall time, the POR-vs-naive comparison rows, fuzz count,
    totals (the JAX package banks the same record as
    MC_ENVELOPE_r*.json; the CLI writes it only to ``--out``)."""
    return {
        "schema_version": 1,
        "routes": [{"route": r.route, "cells": r.cells,
                    "states": r.states,
                    "branch_points": r.branch_points,
                    "wall_s": round(r.wall_s, 3)}
                   for r in stats.routes],
        "compare": [{"cell": list(c["cell"]),
                     "por_states": c["por_states"],
                     "naive_states": c["naive_states"],
                     "reduction": round(c["reduction"], 2),
                     "agree": c["agree"]} for c in stats.compare],
        "fuzz_runs": stats.fuzz_runs,
        "total_cells": stats.cells,
        "total_states": stats.states,
        "total_branch_points": stats.branch_points,
        "failures": len(stats.failures),
        "wall_s": round(stats.wall_s, 3),
    }


def run_fixture(path: str,
                counterexample_dir: Optional[str] = None) -> List[Any]:
    """Load a fixture module (the CLI's ``--fixture``, the
    anti-vacuity pattern): the module's ``build()`` returns a mutated
    model that MUST violate.  The violation surfaces as an M1 finding
    (M2 for the static weight pass — same pass order as `run_cell`:
    static first); a fixture that does NOT violate is itself a finding
    (the checker would be vacuous)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("graftmc_fixture", path)
    assert spec is not None and spec.loader is not None, path
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    model = mod.build()
    static = _static_violations(model)
    if static:
        return [_mc_findings(
            "fixture", (path,), f"{kind}: {msg}",
            code="M2" if kind == "weights" else "M1")
            for kind, msg in static]
    res = check(model)
    if res.ok:
        return [_mc_findings(
            "fixture", (path,),
            "fixture model completed clean — the mutated protocol was "
            "expected to violate; the checker would be vacuous")]
    assert res.violation is not None
    if counterexample_dir is not None and res.violation.trace:
        from . import replay
        replay.export_counterexample(model, res.violation,
                                     counterexample_dir)
    return [_mc_findings("fixture", (path,),
                         f"{res.violation.kind}: {res.violation.message}")]
