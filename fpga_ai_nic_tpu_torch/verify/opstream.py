"""The shared protocol IR, one op-stream EMITTER per collective route:
the port of the JAX package's ``verify/opstream.py``, in plain Python.

An *op stream* is the per-node wait/signal/transfer order of a protocol,
as plain data.  Each route's schedule is emitted once, by an emitter in
this module, and collected by `ListSink` as the abstract op list the
exhaustive checker (`verify.mc.check`) and the randomized fuzz backend
(`verify.mc.run_random`, behind `ops.ring_cuda.simulate_rs_protocol`)
explore.  Where a docstring below names a Pallas kernel, its sink or an
XLA lowering (``ops.ring_pallas``, ``ops.paged_attend_pallas``), it names
the JAX package's consumer of the same emitter.  The port's CUDA kernels
(``csrc/ring_rs.cu``, ``ring_ag.cu``, ``paged_attend.cu``) do not run
these schedules: over virtual ranks on one card a frame never leaves a
thread's registers, so the flat, streaming, ag and gather routes check
the JAX package's protocols through this copy.  One link to the card is
shared: the integrity weights (``ring_rs.cu`` weights emission q by
2q + 1, `msg_weight`).  The hier, handoff and reshard programs are the
ones the port executes: ``ops.ring_hier``, ``serve.handoff`` and
``parallel.reshard`` consume `hier_program`, `handoff_program` and the
reshard action lists below.  Six routes:

  flat       the depth-D pipelined ring reduce-scatter: barrier,
             prologue sends, per-step launch/consume with the
             (D+1)-slot credit window (`RsEmitter`; optional fused-opt
             update + integrity ops).
  streaming  the HBM-streaming variant: the same wire protocol plus the
             slice-load prefetch window (ld), the recv-side
             store-load/writeback pair (st/wb) with the single-wait
             discipline, and, with a fused optimizer, the w/m/v 2-deep
             state window (`RsStreamEmitter`).
  ag         the HBM-streaming interleaved-emission ring all-gather: the
             `ag_schedule` emission order (P1/P2) under the S+2 slot
             window with credits (`AgStreamEmitter`).
  hier       `ops.ring_hier`'s two-hop schedule: the raw intra subring
             hops, the program-order intra->inter handoff, then the
             sliced double-buffered codec hops across groups, RS then
             AG; phases, perms and conservation message ids all from
             `hier_program`.
  reshard    `parallel.reshard`'s transfer program: one exact-length
             single-pair move per owner-changing intersection segment,
             in table order, plus the EF-residual ownership moves
             (`reshard_leaf_actions`/`reshard_residual_actions`, message
             ids included).
  handoff    `serve.handoff`'s KV-migration pair program: one gathered
             page block per layer per K/V crossing the pair, plus the
             integrity verdict exchange (`handoff_program`).

With ``integrity=True`` the emitters add the checksum ops as paired
``chk_emit``/``chk_arrive`` IR ops carrying their conservation message
id and odd weight; the static M2 pass (`check_weight_conservation`)
verifies every emission has exactly one arrival partner with the SAME
weight, all weights odd and program-distinct.

Two execution models give the streams small-step semantics shared by the
exhaustive checker and the randomized fuzz backend:

  RingModel  neighbor wire slots cycling mod n_slots with blocking
             semaphores and asynchronous landings: a started transfer
             lands at an arbitrary later scheduler event, exactly the
             freedom real hardware has.
  PairModel  tag-matched directed sends: a send never blocks, a recv
             blocks until its (src, tag) payload landed.
  GatherModel  one node's asynchronous DMA landings (the paged gather).

Local DMA discipline (the ld/st/wb/opt windows) is deterministic per
node, so it is checked statically by `check_dma_discipline` (single wait
per DMA, wait-after-start, window/RAW predecessors waited, full drain at
exit), keeping the interleaving state space to the events that are
actually concurrent.

The serving control plane's rules (`SchedEmitter`, `SCHED_RULES`) live
here too: the scheduler, fleet, autoscaler and ``tune.adapt`` bind this
one object (``serve.sched_rules`` re-exports it) and `verify.sched`
explores it.  This module imports neither torch nor numpy.
"""

from __future__ import annotations

from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Sequence, Set, Tuple)

Op = Tuple[Any, ...]
Action = Tuple[Any, ...]

# fused-optimizer state-tensor counts (w rides as tensor 0 on top):
# mirrors optim.OptimizerSpec.n_state without importing torch —
# tests/test_torch_verify.py pins the equivalence.
OPT_N_STATE: Dict[str, int] = {"sgd": 0, "momentum": 1, "adamw": 2}

# default launch-ahead depth — mirrors the JAX package's
# ops.ring_pallas._PIPE_DEPTH (tests/test_torch_verify.py pins the
# equality).
DEFAULT_PIPE_DEPTH = 2


def msg_weight(msg: int) -> int:
    """THE odd conservation weight of message ``msg`` — the plain
    twin of `ops.integrity.hop_weight` (2*msg + 1 mod 2^32; odd, hence
    invertible, so a single corrupted word can never vanish from the
    weighted sum).  tests/test_torch_verify.py pins the equivalence; the M2
    pass (`check_weight_conservation`) checks oddness and
    program-distinctness of the weights the emitters attach."""
    return (2 * msg + 1) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# the sink interface: every emitter emits through one of these
# ---------------------------------------------------------------------------

class OpSink:
    """Abstract-op consumer.  An emitter calls exactly these methods, in
    per-node program order; `ListSink` collects them as the checked op
    stream, and each lowering implements a sink that maps them onto its
    real DMA/semaphore/collective calls
    (`ops.ring_pallas._KernelSink`).  ``when(cond)`` is the predication seam: with a python
    bool it either runs or skips the decorated thunk (the checker and
    the unrolled interpreter schedule); with a traced bool the kernel
    sink lowers it to `pl.when` (the rolled hardware schedule) — one
    emitter text therefore serves both execution styles."""

    def when(self, cond: Any) -> Any:
        raise NotImplementedError

    def barrier(self) -> None:
        raise NotImplementedError

    def send(self, q: Any, src: Any = None) -> None:
        raise NotImplementedError

    def wait_send(self, j: Any) -> None:
        raise NotImplementedError

    def wait_recv(self, g: Any) -> None:
        raise NotImplementedError

    def credit_wait(self) -> None:
        raise NotImplementedError

    def credit_signal(self) -> None:
        raise NotImplementedError

    def credit_drain(self, k: int) -> None:
        raise NotImplementedError

    def encode(self, q: Any, src: Any = None) -> None:
        raise NotImplementedError

    def decode(self, g: Any) -> None:
        raise NotImplementedError

    def update(self, g: Any) -> None:
        raise NotImplementedError

    def local(self, name: str, *args: Any) -> None:
        raise NotImplementedError

    def dma_start(self, chan: str, i: Any, *conf: Tuple[str, Any]) -> None:
        raise NotImplementedError

    def dma_wait(self, chan: str, i: Any) -> None:
        raise NotImplementedError

    def chk_emit(self, msg: Any, carry: str = "wire",
                 weight: Optional[int] = None) -> None:
        raise NotImplementedError

    def chk_arrive(self, msg: Any, carry: str = "wire",
                   weight: Optional[int] = None) -> None:
        raise NotImplementedError


class ListSink(OpSink):
    """Collects the abstract op stream (the checker's view).  Driven
    only with concrete indices/conditions — ``when`` evaluates its bool
    immediately.  Checksum ops record ``(kind, carry, msg, weight)``
    with the weight resolved through `msg_weight` unless overridden (the
    override exists for M2's bad fixtures, which must be able to inject
    a weight collision)."""

    def __init__(self) -> None:
        self.ops: List[Op] = []

    def when(self, cond: Any) -> Any:
        def deco(f: Any) -> None:
            if cond:
                f()
        return deco

    def barrier(self) -> None:
        self.ops.append(("barrier",))

    def send(self, q: Any, src: Any = None) -> None:
        # ``src`` is a lowering hint (which buffer the frame leaves
        # from — the AG forward reuses its arrival's recv slot); the
        # wire protocol is src-agnostic, so the IR op records only q
        self.ops.append(("send", q))

    def wait_send(self, j: Any) -> None:
        self.ops.append(("wait_send", j))

    def wait_recv(self, g: Any) -> None:
        self.ops.append(("wait_recv", g))

    def credit_wait(self) -> None:
        self.ops.append(("credit_wait",))

    def credit_signal(self) -> None:
        self.ops.append(("credit_signal",))

    def credit_drain(self, k: int) -> None:
        self.ops.append(("credit_drain", k))

    def encode(self, q: Any, src: Any = None) -> None:
        self.ops.append(("encode", q))

    def decode(self, g: Any) -> None:
        self.ops.append(("decode", g))

    def update(self, g: Any) -> None:
        self.ops.append(("update", g))

    def local(self, name: str, *args: Any) -> None:
        self.ops.append(("local", name, tuple(args)))

    def dma_start(self, chan: str, i: Any, *conf: Tuple[str, Any]) -> None:
        self.ops.append(("dma_start", chan, i,
                         tuple((c, j) for c, j in conf if j >= 0)))

    def dma_wait(self, chan: str, i: Any) -> None:
        self.ops.append(("dma_wait", chan, i))

    def chk_emit(self, msg: Any, carry: str = "wire",
                 weight: Optional[int] = None) -> None:
        self.ops.append(("chk_emit", carry, msg,
                         msg_weight(msg) if weight is None else weight))

    def chk_arrive(self, msg: Any, carry: str = "wire",
                   weight: Optional[int] = None) -> None:
        self.ops.append(("chk_arrive", carry, msg,
                         msg_weight(msg) if weight is None else weight))


class ProtocolError(Exception):
    """A protocol violation raised by a model's apply/terminal check.
    ``kind`` is one of: deadlock, recv_overwrite, send_overwrite,
    ordering, credit, dma, termination — or ``budget``, which is NOT a
    protocol verdict: the exploration hit its state cap and is
    inconclusive (CheckResult.inconclusive)."""

    def __init__(self, kind: str, message: str) -> None:
        super().__init__(message)
        self.kind = kind
        self.message = message


# ---------------------------------------------------------------------------
# plan + op-stream extraction: flat ring RS
# ---------------------------------------------------------------------------

def rs_plan(n: int, S: int, depth: Optional[int],
            default_depth: int = DEFAULT_PIPE_DEPTH
            ) -> Tuple[int, int, bool]:
    """(D, n_slots, launch_first) for the deep-pipelined RS schedule —
    THE plan definition (`ops.ring_pallas._rs_plan` delegates here).

    D (launch-ahead / pipeline depth) and the comm-slot window n_slots
    are bound by three schedule invariants (checked for every plan by
    the model checker and stated in ops.ring_pallas):

      RAW   send q's source rows are finalized by consume q-S.
            Launching q BEFORE consume(g) at step g needs q-S <= g-1,
            i.e. D <= S-1; launching AFTER consume(g) relaxes to D <= S.
      SLOT  emission q overwrites wire slot q % n_slots; its downstream
            decode of arrival q - n_slots must come first: n_slots >=
            D+1 makes every credit edge point to a strictly earlier
            downstream step (acyclic wait-for graph).
      CAP   no more emissions than total = (n-1)*S.
    """
    total = (n - 1) * S
    D = max(1, min(default_depth if depth is None else depth, S, total))
    launch_first = D < S              # RAW: ahead-of-consume needs D<=S-1
    n_slots = min(total, D + 1)
    return D, n_slots, launch_first


class RsEmitter:
    """THE deep-pipelined (VMEM-resident) RS program — the exact
    wait/signal/transfer order `_rs_kernel` executes (every node runs
    the identical program).  The kernel consumes this emitter through
    its `_KernelSink`; the checker consumes it through `ListSink`
    (`rs_op_stream`); there is no second copy of the schedule.

    ``opt_kind`` adds the fused-optimizer final-hop ``update`` ops;
    ``integrity`` adds the paired ``chk_emit``/``chk_arrive`` checksum
    ops exactly where the kernel reads the frames (post-encode on the
    send side, post-wait_recv on the receive side)."""

    def __init__(self, n: int, S: int, depth: Optional[int],
                 opt_kind: Optional[str] = None, integrity: bool = False,
                 default_depth: int = DEFAULT_PIPE_DEPTH) -> None:
        self.n = n
        self.S = S
        self.total = (n - 1) * S
        self.D, self.n_slots, self.launch_first = rs_plan(
            n, S, depth, default_depth)
        self.final_g0 = (n - 2) * S
        self.opt_kind = opt_kind
        self.integrity = integrity

    def launch(self, sink: OpSink, q: Any) -> None:
        @sink.when(q < self.total)
        def _launch() -> None:
            @sink.when(q >= self.n_slots)
            def _reuse() -> None:         # frame slot q % n_slots drained?
                sink.wait_send(q - self.n_slots)
            sink.encode(q)
            if self.integrity:
                sink.chk_emit(q)
            @sink.when(q >= self.n_slots)
            def _credit() -> None:        # downstream freed the slot?
                sink.credit_wait()
            sink.send(q)

    def consume(self, sink: OpSink, g: Any) -> None:
        sink.wait_recv(g)
        if self.integrity:
            sink.chk_arrive(g)
        sink.decode(g)
        if self.opt_kind is not None:
            @sink.when(g >= self.final_g0)
            def _update() -> None:        # this slice lands in OUR chunk
                sink.update(g)
        sink.credit_signal()

    def prologue(self, sink: OpSink) -> None:
        sink.barrier()
        for q in range(self.D):           # fill the pipe (no reuse:
            self.launch(sink, q)          # D < n_slots, guards all false)

    def step(self, sink: OpSink, g: Any) -> None:
        if self.launch_first:
            self.launch(sink, g + self.D)
            self.consume(sink, g)
        else:
            self.consume(sink, g)
            self.launch(sink, g + self.D)

    def epilogue(self, sink: OpSink) -> None:
        for j in range(max(0, self.total - self.n_slots), self.total):
            sink.wait_send(j)
        sink.credit_drain(min(self.total, self.n_slots))

    def stream(self) -> Tuple[List[Op], int]:
        sink = ListSink()
        self.prologue(sink)
        for g in range(self.total):
            self.step(sink, g)
        self.epilogue(sink)
        return sink.ops, self.n_slots


def rs_op_stream(n: int, S: int, depth: Optional[int],
                 default_depth: int = DEFAULT_PIPE_DEPTH,
                 opt_kind: Optional[str] = None,
                 integrity: bool = False) -> Tuple[List[Op], int]:
    """The checked view of `RsEmitter` (one emitter, two consumers)."""
    return RsEmitter(n, S, depth, opt_kind=opt_kind, integrity=integrity,
                     default_depth=default_depth).stream()


# ---------------------------------------------------------------------------
# op-stream extraction: HBM-streaming RS (+ fused-optimizer state window)
# ---------------------------------------------------------------------------

class RsStreamEmitter:
    """THE HBM-streaming RS program — the flat-ring wire protocol plus
    the streaming-only DMA windows, consumed by `_rs_stream_kernel`'s
    sink AND by the checker:

      ld      send-side slice load, 2-deep, prefetched ONE emission
              ahead when ``launch_first and D + 2 <= S`` (the prefetch
              RAW gate);
      st/wb   recv-side store-load + writeback pair, 2-deep, single-wait
              discipline (1-lag head wait when launch_first, in-loop
              wait at D == S);
      optld/optwb<t>  with ``opt_kind``: the w/m/v state window — each
              final-hop consume streams 1 + n_state tensor slices
              through a 2-deep VMEM window with its own DMA pairs.

    DMA ops carry their static hazard predecessors:
    ``("dma_start", chan, i, ((chan', j), ...))`` asserts each (chan',
    j) was *waited* before this start (VMEM slot reuse + the wb->ld RAW)
    — `check_dma_discipline` verifies the discipline per node (the
    lowering sink ignores the predecessor annotations; they are the
    checker's evidence, not schedule)."""

    def __init__(self, n: int, S: int, depth: Optional[int],
                 opt_kind: Optional[str] = None, integrity: bool = False,
                 default_depth: int = DEFAULT_PIPE_DEPTH) -> None:
        self.n = n
        self.S = S
        self.total = (n - 1) * S
        self.D, self.n_slots, self.launch_first = rs_plan(
            n, S, depth, default_depth)
        self.final_g0 = (n - 2) * S
        self.prefetch = self.launch_first and self.D + 2 <= S
        self.opt_kind = opt_kind
        self.n_t = 0 if opt_kind is None else 1 + OPT_N_STATE[opt_kind]
        self.integrity = integrity

    def _ld(self, sink: OpSink, i: Any) -> None:
        # window: ld(i-2) drained; RAW: ld reads what wb(i-S) wrote
        sink.dma_start("ld", i, ("ld", i - 2), ("wb", i - self.S))

    def prologue(self, sink: OpSink) -> None:
        sink.barrier()
        if self.prefetch:
            self._ld(sink, 0)
        for q in range(self.D):           # fill the pipeline: emissions
            if self.prefetch:             # 0..D-1, no slot reuse yet
                if q + 1 < self.total:
                    self._ld(sink, q + 1)
            else:
                self._ld(sink, q)
            sink.dma_wait("ld", q)
            sink.encode(q)
            if self.integrity:
                sink.chk_emit(q)
            sink.send(q)

    def launch(self, sink: OpSink, q: Any) -> None:
        @sink.when(q < self.total)
        def _launch() -> None:
            if self.prefetch:
                @sink.when(q + 1 < self.total)
                def _prefetch() -> None:  # hide the next HBM read
                    self._ld(sink, q + 1)
            else:
                self._ld(sink, q)
            @sink.when(q >= self.n_slots)
            def _reuse() -> None:         # frame slot drained?
                sink.wait_send(q - self.n_slots)
            sink.dma_wait("ld", q)
            sink.encode(q)
            if self.integrity:
                sink.chk_emit(q)
            @sink.when(q >= self.n_slots)
            def _credit() -> None:
                sink.credit_wait()
            sink.send(q)

    def consume(self, sink: OpSink, g: Any) -> None:
        if self.opt_kind is not None:
            @sink.when(g >= self.final_g0 + 2)
            def _opt_slot_free() -> None:  # VMEM window slot reuse guard
                for t in range(self.n_t):
                    sink.dma_wait(f"optwb{t}", g - 2)

            @sink.when(g >= self.final_g0)
            def _opt_ld() -> None:         # hide the state read under
                for t in range(self.n_t):  # the wire wait + decode
                    sink.dma_start(f"optld{t}", g,
                                   (f"optld{t}", g - 2),
                                   (f"optwb{t}", g - 2))
        sink.dma_start("st", g, ("st", g - 2), ("wb", g - 2))
        sink.wait_recv(g)
        if self.integrity:
            sink.chk_arrive(g)
        sink.dma_wait("st", g)
        sink.decode(g)
        sink.credit_signal()
        sink.dma_start("wb", g, ("wb", g - 2))
        if self.opt_kind is not None:
            @sink.when(g >= self.final_g0)
            def _opt_update() -> None:     # grad wb streams out above
                for t in range(self.n_t):  # while the VPU updates here
                    sink.dma_wait(f"optld{t}", g)
                sink.update(g)
                for t in range(self.n_t):
                    sink.dma_start(f"optwb{t}", g, (f"optwb{t}", g - 2))

    def step(self, sink: OpSink, g: Any) -> None:
        if self.launch_first:
            @sink.when(g >= 1)
            def _wb_prev() -> None:        # single wait, 1-iteration lag
                sink.dma_wait("wb", g - 1)
            self.launch(sink, g + self.D)
            self.consume(sink, g)
        else:
            self.consume(sink, g)          # RAW is immediate at D == S
            sink.dma_wait("wb", g)
            self.launch(sink, g + self.D)

    def epilogue(self, sink: OpSink) -> None:
        if self.launch_first:
            sink.dma_wait("wb", self.total - 1)
        if self.opt_kind is not None:
            for gg in range(max(self.final_g0, self.total - 2),
                            self.total):
                for t in range(self.n_t):
                    sink.dma_wait(f"optwb{t}", gg)
        for j in range(max(0, self.total - self.n_slots), self.total):
            sink.wait_send(j)
        sink.credit_drain(min(self.total, self.n_slots))

    def stream(self) -> Tuple[List[Op], int]:
        sink = ListSink()
        self.prologue(sink)
        for g in range(self.total):
            self.step(sink, g)
        self.epilogue(sink)
        return sink.ops, self.n_slots


def rs_stream_op_stream(n: int, S: int, depth: Optional[int],
                        opt_kind: Optional[str] = None,
                        default_depth: int = DEFAULT_PIPE_DEPTH,
                        integrity: bool = False) -> Tuple[List[Op], int]:
    """The checked view of `RsStreamEmitter` (one emitter, two
    consumers)."""
    return RsStreamEmitter(n, S, depth, opt_kind=opt_kind,
                           integrity=integrity,
                           default_depth=default_depth).stream()


# ---------------------------------------------------------------------------
# static DMA discipline (deterministic per node — no interleaving needed)
# ---------------------------------------------------------------------------

def check_dma_discipline(ops: Sequence[Op]) -> List[str]:
    """Verify the per-node DMA discipline of an op stream: every wait
    follows its start, every DMA is waited exactly ONCE (two waits on
    one signal deadlock real hardware — invisibly to the lockstep
    interpreter), every start's declared hazard predecessors (VMEM slot
    reuse, wb->ld RAW) were waited first, and nothing is left in flight
    at exit.  Returns violation messages (empty = clean)."""
    started: Set[Tuple[str, int]] = set()
    waited: Set[Tuple[str, int]] = set()
    out: List[str] = []
    for pos, op in enumerate(ops):
        if op[0] == "dma_start":
            _, chan, i, conf = op
            key = (chan, i)
            if key in started and key not in waited:
                out.append(f"op {pos}: DMA {chan}[{i}] restarted while "
                           "still in flight")
            for c in conf:
                if c in started and c not in waited:
                    out.append(
                        f"op {pos}: DMA slot/RAW hazard — {chan}[{i}] "
                        f"starts before required wait of {c[0]}[{c[1]}]")
            started.add(key)
        elif op[0] == "dma_wait":
            _, chan, i = op
            key = (chan, i)
            if key not in started:
                out.append(f"op {pos}: wait on never-started DMA "
                           f"{chan}[{i}] (hardware deadlock)")
            elif key in waited:
                out.append(f"op {pos}: second wait on DMA {chan}[{i}] — "
                           "one signal per DMA (hardware deadlock)")
            waited.add(key)
    for key in sorted(started - waited):
        out.append(f"exit: DMA {key[0]}[{key[1]}] started but never "
                   "waited (unsynchronized buffer at kernel exit)")
    return out


# ---------------------------------------------------------------------------
# the paged gather-attend DMA program (consumed by
# ops.paged_attend_pallas AND the checker — the serving fast path's
# per-page schedule, one definition)
# ---------------------------------------------------------------------------


def negate(cond: Any) -> Any:
    """Logical negation across the two predication styles ``when``
    serves: python bools (the checker and the unrolled interpreter
    schedules) take ``not``; traced bools (the rolled kernel schedule)
    take ``~`` — ``not`` on a tracer raises, and ``~True`` is the
    python int -2.  Plain Python on purpose: tracers only ever reach this
    through a kernel sink."""
    if isinstance(cond, bool):
        return not cond
    return ~cond


class PagedAttendEmitter:
    """One definition of the paged gather-attend decode kernel's
    per-(request, kv-head) DMA schedule (`ops.paged_attend_pallas`) —
    the same discipline applied to the serving fast path: the SAME
    stream drives the kernel lowering (through its sink) and the
    graftmc ``gather`` family (`verify.mc.build_gather`), so the gather
    protocol that ships is the protocol that was checked.

    ``n_pages`` table slots per sequence; the first ``n_live`` hold
    every visible position (``live(i)``: a python bool per slot for the
    checker, a traced bool for the rolled kernel).  Per live page i the
    stream is a ``depth``-deep double buffer over dedicated VMEM spans
    (page i lands at rows [i*page_size, (i+1)*page_size) of the K/V
    tile buffers — transfers never share a destination), with the DMA
    *semaphores* cycling mod depth:

        wait kpg[i]; wait vpg[i]        (the prologue started 0..depth-1)
        start kpg[i+depth], vpg[i+depth] if that slot is live — declared
                                        hazard predecessor: page i, just
                                        waited, which shares its
                                        semaphore slot (i mod depth)
        attend_tile(i)                  (scores tile from the landed
                                        K page)

    Dead slots (i >= n_live) emit only ``dead_fill`` — their pages are
    NEVER transferred.  The allocated-extent bytes the reference gather
    pays for dead slots are exactly the bytes this schedule saves, and
    `check_gather_coverage` pins the other direction: every live
    (page, offset) is read exactly once, zero overlap."""

    K_CHAN = "kpg"
    V_CHAN = "vpg"

    def __init__(self, n_pages: int, depth: int = 2) -> None:
        assert n_pages >= 1 and depth >= 1, (n_pages, depth)
        self.n_pages = n_pages
        self.depth = depth

    def stream(self, sink: OpSink, live: Callable[[int], Any]) -> None:
        P, depth = self.n_pages, self.depth
        for i in range(min(depth, P)):
            @sink.when(live(i))
            def _prologue(i: int = i) -> None:
                # predecessors i-depth are pre-history (index < 0):
                # stated so the semaphore-reuse invariant reads the same
                # on every start; ListSink filters them out
                sink.dma_start(self.K_CHAN, i, (self.K_CHAN, i - depth))
                sink.dma_start(self.V_CHAN, i, (self.V_CHAN, i - depth))
        for i in range(P):
            @sink.when(live(i))
            def _live_tile(i: int = i) -> None:
                sink.dma_wait(self.K_CHAN, i)
                sink.dma_wait(self.V_CHAN, i)
                if i + depth < P:
                    @sink.when(live(i + depth))
                    def _launch(i: int = i) -> None:
                        sink.dma_start(self.K_CHAN, i + depth,
                                       (self.K_CHAN, i))
                        sink.dma_start(self.V_CHAN, i + depth,
                                       (self.V_CHAN, i))
                sink.local("attend_tile", i)

            @sink.when(negate(live(i)))
            def _dead_tile(i: int = i) -> None:
                sink.local("dead_fill", i)
        sink.local("softmax")
        sink.local("pv")


def paged_attend_op_stream(n_pages: int, n_live: int,
                           depth: int = 2) -> List[Op]:
    """The checker's view of one (request, kv-head) grid cell's gather
    schedule: ``n_live`` of ``n_pages`` table slots hold visible
    positions.  Consumed by `verify.mc.build_gather` (the exhaustive
    ``gather`` envelope family); tests/test_paged_attend.py pins it
    against the kernel's own emission."""
    assert 0 <= n_live <= n_pages, (n_live, n_pages)
    sink = ListSink()
    PagedAttendEmitter(n_pages, depth).stream(sink, lambda i: i < n_live)
    return sink.ops


def check_gather_coverage(ops: Sequence[Op], n_pages: int,
                          n_live: int) -> List[str]:
    """The gather family's coverage/exclusivity obligations, on top of
    the generic per-node DMA discipline (`check_dma_discipline`): every
    live page's K and V are transferred exactly once and waited before
    its attend (each live (page, offset) read exactly once — no
    overlap, no hole), every dead slot is dead-filled exactly once and
    transfers NOTHING (the saved allocated-extent bytes are real), and
    the epilogue reduces the tiles exactly once.  Returns violation
    messages (empty = clean)."""
    out: List[str] = []
    starts: Dict[Tuple[str, int], int] = {}
    waited_at: Dict[Tuple[str, int], int] = {}
    attends: List[int] = []
    dead: List[int] = []
    tail: List[str] = []
    chans = (PagedAttendEmitter.K_CHAN, PagedAttendEmitter.V_CHAN)
    for pos, op in enumerate(ops):
        if op[0] == "dma_start":
            key = (op[1], op[2])
            starts[key] = starts.get(key, 0) + 1
        elif op[0] == "dma_wait":
            waited_at.setdefault((op[1], op[2]), pos)
        elif op[0] == "local":
            name, args = op[1], op[2]
            if name == "attend_tile":
                i = args[0]
                attends.append(i)
                for chan in chans:
                    if waited_at.get((chan, i)) is None:
                        out.append(
                            f"op {pos}: attend of page {i} before its "
                            f"{chan} DMA was waited — reads an unlanded "
                            "tile")
            elif name == "dead_fill":
                dead.append(args[0])
            else:
                tail.append(name)
    if attends != list(range(n_live)):
        out.append(f"live coverage broken: attends={attends}, want "
                   f"pages 0..{n_live - 1} each exactly once, in order")
    if dead != list(range(n_live, n_pages)):
        out.append(f"dead slots mishandled: dead_fill={dead}, want "
                   f"{list(range(n_live, n_pages))}")
    for (chan, i), c in sorted(starts.items()):
        if i >= n_live:
            out.append(f"dead page {i} transferred on {chan} — the "
                       "allocated-extent bytes the schedule exists to "
                       "save")
        elif c != 1:
            out.append(f"{chan}[{i}] transferred {c} times — "
                       "overlapping reads of one (page, offset) span")
    for i in range(n_live):
        for chan in chans:
            if (chan, i) not in starts:
                out.append(f"live page {i} never transferred on {chan} "
                           "— a hole in the gathered span")
    if tail != ["softmax", "pv"]:
        out.append("epilogue must reduce the landed tiles exactly "
                   f"once: got {tail}, want ['softmax', 'pv']")
    return out


# ---------------------------------------------------------------------------
# the hierarchical two-hop program (consumed by ops.ring_hier AND the
# checker — phases, perms and conservation message ids, one definition)
# ---------------------------------------------------------------------------

def intra_perm(n: int, ni: int) -> List[Tuple[int, int]]:
    """Next-neighbor inside each group of ni consecutive ranks — THE
    intra-subring permutation (`ops.ring_hier._intra_perm` delegates
    here; the checker derives per-node src/dst from the same list)."""
    return [(g * ni + j, g * ni + (j + 1) % ni)
            for g in range(n // ni) for j in range(ni)]


def inter_perm(n: int, ni: int) -> List[Tuple[int, int]]:
    """Next-group, same intra position: the inter rings (THE
    definition, as `intra_perm`)."""
    ng = n // ni
    return [(g * ni + j, ((g + 1) % ng) * ni + j)
            for g in range(ng) for j in range(ni)]


class HierPhase(NamedTuple):
    """One phase of the hierarchical schedule: ``hops`` ring hops over
    ``perm``, each hop carrying ``slices`` wire messages.  ``msg(s, k)``
    is hop s / slice k's id in the owning conservation carry — the SAME
    arithmetic `ops.ring_hier` feeds `integrity.hop_weight` (traced hop
    indices welcome), so the checksum weights the lowering uses and the
    weights M2 checks cannot diverge."""

    kind: str                  # rs_intra | rs_inter | ag_inter | ag_intra
    hops: int
    slices: int                # wire messages per hop (s_inter on rs_inter)
    base: int                  # carry message id of (hop 0, slice 0)
    perm: Tuple[Tuple[int, int], ...]

    def msg(self, s: Any, k: Any = 0) -> Any:
        return self.base + s * self.slices + k


class HierProgram(NamedTuple):
    """The full two-hop schedule of `ops.ring_hier` over n = ni * ng
    devices.  The RS phases share one conservation carry ("rs": intra
    hop s is message s, inter hop s slice k is (ni-1) + s*s_inter + k);
    the AG phases share another ("ag": inter hop s is message s, intra
    hop s is (ng-1) + s) — exactly the counters `hier_reduce_scatter` /
    `hier_all_gather` consume."""

    n: int
    ni: int
    ng: int
    s_inter: int
    rs_intra: HierPhase
    rs_inter: HierPhase
    ag_inter: HierPhase
    ag_intra: HierPhase


def hier_program(n: int, ni: int, s_inter: int = 1) -> HierProgram:
    """Build THE hierarchical phase program (validates the declared
    factorization, as `ops.ring_hier.check_factorization`)."""
    if ni < 1 or n % ni:
        raise ValueError(f"intra size {ni} does not factor n={n}")
    ng = n // ni
    pa = tuple(intra_perm(n, ni))
    pb = tuple(inter_perm(n, ni))
    return HierProgram(
        n=n, ni=ni, ng=ng, s_inter=s_inter,
        rs_intra=HierPhase("rs_intra", ni - 1, 1, 0, pa),
        rs_inter=HierPhase("rs_inter", ng - 1, s_inter, ni - 1, pb),
        ag_inter=HierPhase("ag_inter", ng - 1, 1, 0, pb),
        ag_intra=HierPhase("ag_intra", ni - 1, 1, ng - 1, pa))


def _perm_neighbors(perm: Sequence[Tuple[int, int]],
                    d: int) -> Tuple[int, int]:
    """(dst, src) of node d under a permutation list."""
    dst = next(b for a, b in perm if a == d)
    src = next(a for a, b in perm if b == d)
    return dst, src


def hier_op_stream(n: int, ni: int, s_inter: int = 1,
                   include_ag: bool = True,
                   integrity: bool = False) -> List[List[Op]]:
    """Per-node op streams of the hierarchical schedule, derived from
    `hier_program` (the same phases/perms/message-ids `ops.ring_hier`
    lowers — no second definition).

    RS: (ni-1) raw intra subring hops -> program-order handoff -> (ng-1)
    inter codec hops, each sliced into ``s_inter`` double-buffered
    payloads (`ops.ring._send`'s scan: send slice k, encode k+1, recv
    k).  AG (``include_ag``): the phases in reverse — (ng-1) inter
    gather hops (encode once, forward verbatim: one payload per hop)
    then (ni-1) raw intra gather hops.  ``integrity`` adds the paired
    chk ops per wire message (pre-send / post-recv, the `ops.ring._send`
    placement) with the program's carry ("rs"/"ag") message ids."""
    prog = hier_program(n, ni, s_inter)
    streams: List[List[Op]] = []
    for d in range(n):
        sink = ListSink()

        def ring_hop(phase: HierPhase, s: int, carry: str,
                     decode: bool = False, accumulate: bool = False,
                     sliced: bool = False) -> None:
            dst, src = _perm_neighbors(phase.perm, d)
            if sliced:
                sink.local("encode", phase.kind, s, 0)
            for k in range(phase.slices):
                if integrity:
                    sink.chk_emit(phase.msg(s, k), carry=carry)
                tag = ((phase.kind, s, k) if sliced else (phase.kind, s))
                sink.ops.append(("send_to", dst, tag))
                if sliced and k + 1 < phase.slices:
                    sink.local("encode", phase.kind, s, k + 1)
                sink.ops.append(("recv_from", src, tag))
                if integrity:
                    sink.chk_arrive(phase.msg(s, k), carry=carry)
                if sliced and decode:
                    sink.local("decode", phase.kind, s, k)
            if accumulate:
                sink.local("accumulate", phase.kind, s)

        for s in range(prog.rs_intra.hops):       # phase A: raw intra RS
            ring_hop(prog.rs_intra, s, "rs", accumulate=True)
        sink.local("handoff", "intra->inter")
        for s in range(prog.rs_inter.hops):       # phase B: sliced codec
            ring_hop(prog.rs_inter, s, "rs", decode=True, sliced=True)
        if include_ag:
            for s in range(prog.ag_inter.hops):   # B': inter all-gather
                ring_hop(prog.ag_inter, s, "ag")
            for s in range(prog.ag_intra.hops):   # A': raw intra gather
                ring_hop(prog.ag_intra, s, "ag")
        streams.append(sink.ops)
    return streams


# ---------------------------------------------------------------------------
# op-stream extraction: reshard transfer program
# ---------------------------------------------------------------------------

class Seg(NamedTuple):
    """One intersection-table segment (mirrors parallel.reshard.Transfer
    as plain Python; tests pin the equivalence)."""

    src: int
    dst: int
    src_off: int
    dst_off: int
    length: int


def reshard_segments(live: int, chunk_src: int,
                     chunk_tgt: int) -> Tuple[Seg, ...]:
    """Source->target shard intersections of a [live] flat vector: cut
    [0, live) at every chunk boundary of either layout.  The plain
    twin of `parallel.reshard.intersection_table` — the segments
    PARTITION the live range (asserted)."""
    assert live > 0 and chunk_src > 0 and chunk_tgt > 0
    cuts = {0, live}
    cuts.update(range(chunk_src, live, chunk_src))
    cuts.update(range(chunk_tgt, live, chunk_tgt))
    edges = sorted(cuts)
    table = []
    for a, b in zip(edges, edges[1:]):
        src, dst = a // chunk_src, a // chunk_tgt
        table.append(Seg(src=src, dst=dst, src_off=a - src * chunk_src,
                         dst_off=a - dst * chunk_tgt, length=b - a))
    assert sum(t.length for t in table) == live
    return tuple(table)


def reshard_owners(n_src: int, n_tgt: int) -> Tuple[int, ...]:
    """EF-residual old-device -> new-owner map — THE definition
    (`parallel.reshard.residual_owners` delegates here): contiguous
    groups, every old residual has exactly one new home (mass is
    conserved), fresh devices beyond the assignment start at zero."""
    assert n_src > 0 and n_tgt > 0
    return tuple(i * n_tgt // n_src for i in range(n_src))


def union_layout(live: int, n_src: int, padded_src: int, n_tgt: int,
                 padded_tgt: int) -> Tuple[int, int, int, int]:
    """(chunk_src, chunk_tgt, n_union, seed_len) — THE union-mesh layout
    arithmetic of a mesh-shape change (`parallel.reshard.make_plan`
    consumes this; `verify.mc.reshard_layout` derives its grid cells
    from it).  Shrink: the union layout IS the source layout, no
    seeding; grow: the source re-lays onto n_union devices first with
    the smallest even chunking that holds the live elements."""
    assert padded_src % n_src == 0, (padded_src, n_src)
    assert padded_tgt % n_tgt == 0, (padded_tgt, n_tgt)
    n_union = max(n_src, n_tgt)
    if n_tgt <= n_src:
        chunk_src, seed_len = padded_src // n_src, padded_src
    else:
        chunk_src = -(-live // n_union)
        seed_len = n_union * chunk_src
    return chunk_src, padded_tgt // n_tgt, n_union, seed_len


class SegMove(NamedTuple):
    """One intersection segment as a transfer-program action: a
    ``"xfer"`` crosses the wire (single-pair send/recv, conservation
    message ``msg``), a ``"copy"`` stays resident (never checksummed)."""

    kind: str                  # "xfer" | "copy"
    seg_index: int
    src: int
    dst: int
    src_off: int
    dst_off: int
    length: int
    msg: int


class ResidMove(NamedTuple):
    """One EF-residual ownership move (``"keep"`` stays resident)."""

    kind: str                  # "xfer" | "keep"
    src: int
    dst: int
    msg: int


def reshard_msg_bases(n_segs: int,
                      n_flat_leaves: int) -> Tuple[Tuple[int, ...], int]:
    """(per-leaf message bases, residual base) of the single
    program-wide conservation counter: leaf li's segments are messages
    [li*n_segs, (li+1)*n_segs), the residual moves follow — every
    message in the transfer gets a DISTINCT odd weight (a product of
    two odd per-axis weights would collide across leaves: the
    class M2 freezes)."""
    return (tuple(li * n_segs for li in range(n_flat_leaves)),
            n_flat_leaves * n_segs)


def reshard_leaf_actions(table: Sequence[Any],
                         base: int = 0) -> List[SegMove]:
    """One flat leaf's transfer actions in table order — THE program
    `parallel.reshard._move_chunk` executes (message ids included) and
    the checker expands."""
    return [SegMove("copy" if t.src == t.dst else "xfer", ti,
                    t.src, t.dst, t.src_off, t.dst_off, t.length,
                    base + ti)
            for ti, t in enumerate(table)]


def reshard_residual_actions(owners: Sequence[int],
                             base: int = 0) -> List[ResidMove]:
    """The EF-residual moves in ascending-source order (the golden
    twin's sum order) — THE program `parallel.reshard._move_residual`
    executes."""
    return [ResidMove("keep" if i == owner else "xfer", i, owner,
                      base + i)
            for i, owner in enumerate(owners)]


def reshard_op_stream(live: int, chunk_src: int, chunk_tgt: int,
                      n_union: int,
                      residual_owners_map: Optional[Sequence[int]] = None,
                      n_flat_leaves: int = 1,
                      integrity: bool = False) -> List[List[Op]]:
    """Per-node op streams of the lowered reshard program
    (`parallel.reshard.lower_apply`), derived from the SAME action
    lists the lowering consumes: per leaf, the intersection segments in
    table order — an exact-length single-pair send/recv when the owner
    changes, a resident copy when it does not — then the EF-residual
    ownership moves in ascending-source order.  ``integrity`` adds the
    paired chk ops with the program-wide message counter
    (`reshard_msg_bases`)."""
    segs = reshard_segments(live, chunk_src, chunk_tgt)
    bases, resid_base = reshard_msg_bases(len(segs), n_flat_leaves)
    sinks = [ListSink() for _ in range(n_union)]

    def xfer(src: int, dst: int, tag: Op, msg: int) -> None:
        assert src < n_union and dst < n_union, (tag, n_union)
        if integrity:
            sinks[src].chk_emit(msg)
        sinks[src].ops.append(("send_to", dst, tag))
        sinks[dst].ops.append(("recv_from", src, tag))
        if integrity:
            sinks[dst].chk_arrive(msg)

    for li in range(n_flat_leaves):
        for act in reshard_leaf_actions(segs, bases[li]):
            if act.kind == "copy":
                if act.src < n_union:
                    sinks[act.src].local("copy", "seg", li, act.seg_index)
                continue
            xfer(act.src, act.dst, ("seg", li, act.seg_index), act.msg)
    if residual_owners_map is not None:
        for ra in reshard_residual_actions(residual_owners_map,
                                           resid_base):
            if ra.kind == "keep":
                sinks[ra.src].local("resid_keep", "resid", ra.src)
                continue
            xfer(ra.src, ra.dst, ("resid", ra.src), ra.msg)
    return [s.ops for s in sinks]


# ---------------------------------------------------------------------------
# the streaming all-gather: schedule + emitter (consumed by
# ops.ring_pallas._ag_stream_kernel AND the checker)
# ---------------------------------------------------------------------------

def ag_schedule(n: int, S: int, n_slots: int) -> Tuple[
        List[int], List[int], List[int], List[int], Set[int], List[int]]:
    """Explicit interleaved emission schedule for the streaming gather —
    THE definition (`ops.ring_pallas._ag_schedule` is this function;
    the kernel consumes it directly and via its SMEM copy).

    Every node runs the SAME emission sequence E (the reference's
    SEND_LOCAL/FORWARD beat multiplexing, hw/all_reduce.sv:891-1086),
    built by simulating one node: per arrival step m, emit own slice m+1
    (while the own phase lasts) and forward arrival m onward unless its
    content is at the last hop.  Because arrivals ARE the upstream's
    emissions in E order, wire slots and semaphores cycle by EMISSION
    index j (mod n_slots on BOTH ends), and a node's m-th arrival has the
    content of E[m] one hop deeper.  Simple closed forms exist only for
    n >= 4 or S <= 2 (for n == 3, S >= 3 the terminal arrivals interleave
    non-contiguously and punch holes in any arithmetic j assignment), so
    the schedule is built explicitly — it is static per (n, S).

    Two properties are asserted here per (n, S) because the kernel's
    safety rests on them:

      P1  m_e(m) < m: arrival m's emission is issued at a consume step
          STRICTLY before step m on the identical upstream program — so
          in the interpreter's lockstep-primitive model the data has
          landed before consume(m) decodes it, and on hardware wait_recv
          can always be satisfied.
      P2  j - m_e(j) <= S: no emission runs more than S ahead of its
          consume step (the own phase emits two frames per step for S-1
          steps, which is the worst case).  With n_slots >= S + 1, the
          overwrite of wire slot j % n_slots (emission j) therefore comes
          after the decode of arrival j - n_slots in program order
          (interpreter safety), and the credit window never dead-ends
          (hardware): emission j's credit waits on downstream consume
          j - n_slots <= m_e(j) - 1, a strictly earlier step, so every
          cross-node dependency edge points from (step m, node) to
          (step < m, neighbor) and the dependency graph is acyclic for
          ARBITRARY S and n.  n_slots = S + 2 adds one slot of margin.

    The static sweep is not the only evidence: the full wait/credit
    protocol over this schedule (`AgStreamEmitter`) is explored
    exhaustively by the model checker over the standard envelope, with
    asynchronous landings.

    Returns (content[m], fwd_j[m], own_at[m], own_j[k], own_js,
    tail_own_js):
      content[m]   (chunk_depth_hops - 1) * S + slice of arrival m
      fwd_j[m]     emission index of arrival m's onward forward, -1 if
                   terminal (content at depth n-2)
      own_at[m]    own slice emitted AFTER consuming arrival m (-1 none)
      own_j[k]     emission index of own slice k
      own_js       set(own_j) — membership drives the pre-wait rule
      tail_own_js  own emissions never followed by a same-slot emission
                   (their send semaphores drain at kernel exit)
    """
    total = (n - 1) * S
    own_j = [0] * S
    content = [0] * total
    fwd_j = [-1] * total
    own_at = [-1] * total
    step_at = {0: -1}                   # emission index -> consume step
    j = 0

    def emit_own(k: int) -> None:
        nonlocal j
        own_j[k] = j
        j += 1

    emit_own(0)
    # arrival m's content: my arrival stream is the upstream's emission
    # stream; its k-th own is my depth-0 content (chunk idx-1, slice k),
    # and its forward of ITS arrival m' is my (content[m'] + one hop)
    emissions: List[Tuple[str, int]] = [("own", 0)]     # E, in order

    for m in range(total):
        kind, val = emissions[m]
        content[m] = val if kind == "own" else content[val] + S
        # EXECUTED order within a step: the forward fires inside
        # consume(m), the next own slice after it — emission indices
        # MUST follow that order or the credit pairing slips.  The
        # original transcription assigned own(m+1) the smaller index
        # while the kernel sends fwd(m) first; graftmc's first
        # exhaustive run over this route found the resulting
        # one-credit under-wait as a recv-slot overwrite at
        # (n=5, S=5) — the bug class the static P1/P2 sweep is blind
        # to, and the reason this schedule is now model-checked.
        if content[m] < (n - 2) * S:    # not yet at the last hop
            fwd_j[m] = j
            step_at[j] = m
            j += 1
            emissions.append(("fwd", m))
        if m + 1 < S:
            own_at[m] = m + 1
            step_at[j] = m
            emit_own(m + 1)
            emissions.append(("own", m + 1))
    assert j == total and len(emissions) == total, (j, len(emissions))
    assert sorted(content) == list(range(total))
    assert all(step_at[m] < m for m in range(total)), (n, S)        # P1
    assert all(jj - st <= S for jj, st in step_at.items()), (n, S)  # P2
    # P3 (the invariant the graftmc run added): emission indices follow
    # the EXECUTED per-step order (fwd(m) before own(m+1)), so credit
    # waits happen in ascending j and "emission j waits on downstream
    # consume j - n_slots" holds count-exactly.
    assert all(fwd_j[m] < own_j[own_at[m]] for m in range(total)
               if fwd_j[m] >= 0 and own_at[m] >= 0), (n, S)

    # single-wait bookkeeping for send semaphores: a forward's send is
    # waited at its own consume step; an own send is waited by the NEXT
    # same-slot emission's pre-wait iff that emission exists AND the
    # preceding same-slot emission was an own (forwards self-wait)
    own_js = set(own_j)
    tail_own_js = [oj for oj in own_j
                   if oj + n_slots >= total]   # no same-slot successor
    return content, fwd_j, own_at, own_j, own_js, tail_own_js


def ag_n_slots(n: int, S: int) -> int:
    """THE slot-window rule of the streaming gather: covers the own
    phase's maximum emission lead (== S, P2) with one slot of margin
    (`_ag_stream_call` consumes this)."""
    return min((n - 1) * S, S + 2)


class AgSchedule:
    """Python-table accessor over `ag_schedule` — the checker's and the
    unrolled kernel path's schedule view.  The rolled kernel path
    substitutes an SMEM-reading twin with the same four methods
    (`ops.ring_pallas._SmemAgSchedule`), built from THIS object's
    tables, so there is one schedule and two reading styles."""

    def __init__(self, n: int, S: int, n_slots: int) -> None:
        (self.content_t, self.fwd_j_t, self.own_at_t, self.own_j_t,
         self.own_js, self.tail_own_js) = ag_schedule(n, S, n_slots)

    def content(self, m: int) -> int:
        return self.content_t[m]

    def fwd_j(self, m: int) -> int:
        return self.fwd_j_t[m]

    def own_at(self, m: int) -> int:
        return self.own_at_t[m]

    def own_j(self, k: int) -> int:
        return self.own_j_t[k]

    def is_own_j(self, j: int) -> bool:
        return j >= 0 and j in self.own_js


class AgStreamEmitter:
    """THE HBM-streaming interleaved-emission all-gather program — the
    exact wait/signal/transfer order `_ag_stream_kernel` executes
    (every node runs the identical program; wire slots and semaphores
    cycle by emission index j % n_slots on BOTH ends).  The kernel
    consumes this emitter through its `_KernelSink` with either
    schedule accessor; the checker consumes it through `ListSink`
    (`ag_op_stream`).

    Per arrival m: 1-lag writeback wait, wire wait, the onward forward
    (emission fwd_j(m): pre-wait if the previous same-slot emission was
    an un-waited own send, credit past the window, send), decode into
    the st window, the forward's own send-drain wait, credit signal,
    writeback start — then the next own-slice emission if this step
    schedules one (ld window, pre-wait, encode, own-store window,
    credit, send).  ``lockstep=True`` swaps decode ahead of the forward
    (the interpreter's primitive-lockstep ordering; hardware keeps
    forward-then-decode for overlap — both orders are checked)."""

    def __init__(self, n: int, S: int,
                 n_slots: Optional[int] = None) -> None:
        self.n = n
        self.S = S
        self.total = (n - 1) * S
        self.n_slots = ag_n_slots(n, S) if n_slots is None else n_slots
        self.sched = AgSchedule(n, S, self.n_slots)

    def send_own(self, sink: OpSink, k: Any, acc: Any) -> None:
        j = acc.own_j(k)
        sink.dma_start("ld", k, ("ld", k - 2))
        @sink.when(acc.is_own_j(j - self.n_slots))
        def _pre_wait() -> None:      # previous same-slot emission was an
            sink.wait_send(j - self.n_slots)   # own send (unwaited) AND
                                      # its frame lives in this buffer
                                      # slot: drain before overwriting
        sink.dma_wait("ld", k)
        sink.encode(j, src=k)
        @sink.when(k >= 2)
        def _own_slot() -> None:      # own-store VMEM window reuse
            sink.dma_wait("ownwb", k - 2)
        sink.local("own_store", k)    # the replica stores its own wire
        sink.dma_start("ownwb", k, ("ownwb", k - 2))      # bytes
        @sink.when(j >= self.n_slots)
        def _credit() -> None:
            sink.credit_wait()
        sink.send(j)

    def consume(self, sink: OpSink, m: Any, acc: Any,
                lockstep: bool = False) -> None:
        @sink.when(m >= 1)
        def _wb_prev() -> None:       # 1-lag single wait: st slot reuse
            sink.dma_wait("wb", m - 1)      # at m covers wb(m-2)
        sink.wait_recv(m)
        jf = acc.fwd_j(m)
        fwd = jf >= 0                 # -1 when arrival m is terminal

        def start_forward() -> None:
            @sink.when(acc.is_own_j(jf - self.n_slots))
            def _pre_wait() -> None:
                sink.wait_send(jf - self.n_slots)
            @sink.when(jf >= self.n_slots)
            def _credit() -> None:
                sink.credit_wait()
            sink.send(jf, src=m)      # forward straight out of the
                                      # arrival's recv slot

        if lockstep:
            # interpreter primitive-lockstep ordering: all reads first,
            # then emissions (see the kernel docstring); hardware keeps
            # forward-then-decode for overlap
            sink.decode(m)
            sink.when(fwd)(start_forward)
        else:
            sink.when(fwd)(start_forward)
            sink.decode(m)
        @sink.when(fwd)
        def _fwd_done() -> None:      # recv slot is upstream's next
            sink.wait_send(jf)        # target: drain my forward first
        sink.credit_signal()
        sink.dma_start("wb", m, ("wb", m - 2))

    def prologue(self, sink: OpSink, acc: Any) -> None:
        sink.barrier()
        self.send_own(sink, 0, acc)

    def step(self, sink: OpSink, m: Any, acc: Any,
             lockstep: bool = False) -> None:
        self.consume(sink, m, acc, lockstep=lockstep)
        k = acc.own_at(m)             # next own-slice emission, if this
        @sink.when(k >= 0)            # arrival step schedules one
        def _own() -> None:
            self.send_own(sink, k, acc)

    def epilogue(self, sink: OpSink) -> None:
        sink.dma_wait("wb", self.total - 1)
        sink.dma_wait("ownwb", self.S - 1)
        if self.S >= 2:
            sink.dma_wait("ownwb", self.S - 2)
        for jk in self.sched.tail_own_js:     # own sends with no
            sink.wait_send(jk)                # same-slot successor
        sink.credit_drain(min(self.total, self.n_slots))

    def stream(self, lockstep: bool = False) -> Tuple[List[Op], int]:
        sink = ListSink()
        self.prologue(sink, self.sched)
        for m in range(self.total):
            self.step(sink, m, self.sched, lockstep=lockstep)
        self.epilogue(sink)
        return sink.ops, self.n_slots


def ag_op_stream(n: int, S: int, n_slots: Optional[int] = None,
                 lockstep: bool = False) -> Tuple[List[Op], int]:
    """The checked view of `AgStreamEmitter` (one emitter, two
    consumers).  ``n_slots`` overrides the protocol window (the
    anti-vacuity mutants shrink it); the default is `ag_n_slots`."""
    return AgStreamEmitter(n, S, n_slots=n_slots).stream(
        lockstep=lockstep)


# ---------------------------------------------------------------------------
# the KV-handoff pair program (consumed by serve.handoff AND the checker)
# ---------------------------------------------------------------------------

class HandoffMove(NamedTuple):
    """One gathered page block crossing the pair: pool index in
    layer-major K-then-V order (== its odd-multiplier index in
    `ops.integrity.gathered_page_checksums`, so a block-order change is
    a weight change M2 sees)."""

    pool: int
    msg: int


def handoff_program(n_layers: int) -> List[HandoffMove]:
    """THE block order of one KV migration — `serve.handoff.lower_apply`
    iterates exactly this list to drive its gather/ppermute/scatter
    trio per block, and the ledger-compare weights are the same ``msg``
    indices."""
    return [HandoffMove(i, i) for i in range(2 * n_layers)]


def handoff_op_stream(n_layers: int,
                      integrity: bool = False) -> List[List[Op]]:
    """Per-node op streams of the KV-handoff pair program, derived from
    `handoff_program`: the source gathers and sends each page block in
    block order; the destination receives and scatters each.  With
    ``integrity`` the per-block ledger compare rides as paired chk ops
    (carry "page", weight = the block's gathered_page_checksums odd
    multiplier) and the replicated verdict psum as a symmetric vote
    exchange — the destination's vote depends on every landed block
    (it is computed from the scattered pages), the source's only on its
    ledger."""
    src, dst = ListSink(), ListSink()
    for mv in handoff_program(n_layers):
        if integrity:
            src.chk_emit(mv.msg, carry="page")
        src.local("gather", mv.pool)
        src.ops.append(("send_to", 1, ("pool", mv.pool)))
        dst.ops.append(("recv_from", 0, ("pool", mv.pool)))
        if integrity:
            dst.chk_arrive(mv.msg, carry="page")
        dst.local("scatter", mv.pool)
    if integrity:
        # the conservation/verdict psum: each side contributes its vote
        # and consumes the peer's — the destination's vote is data-
        # dependent on every scattered block above (program order)
        src.ops.append(("send_to", 1, ("vote", 0)))
        src.ops.append(("recv_from", 1, ("vote", 1)))
        dst.ops.append(("send_to", 0, ("vote", 1)))
        dst.ops.append(("recv_from", 0, ("vote", 0)))
    return [src.ops, dst.ops]


# ---------------------------------------------------------------------------
# M2: the static checksum-weight conservation pass
# ---------------------------------------------------------------------------

def check_weight_conservation(streams: Sequence[Any]) -> List[str]:
    """M2 — the static pass over a checked program's ``chk_emit`` /
    ``chk_arrive`` ops (the weight-collision bug class, frozen as a
    tool): per conservation carry,

      - every emission message has arrival partners, 1:1 by count, and
        every partner carries the SAME weight (a send/recv weighted
        differently can never telescope to zero — the verdict would
        trip on clean wires, or worse, stay green on corrupt ones);
      - every weight is ODD (odd = invertible mod 2^32: single-word
        corruption can never vanish from the weighted sum);
      - weights are program-distinct: two DIFFERENT messages sharing a
        weight alias in the conservation sum — a swap of their payloads
        cancels exactly (the collision class).

    ``streams``: a single op list (RingModel — every node runs it) or a
    per-node list of op lists (PairModel).  Returns violation messages
    (empty = clean); a program with no chk ops is trivially clean —
    COVERAGE is J12's job, soundness of the weights is M2's."""
    if streams and streams[0] and isinstance(streams[0][0], str):
        node_streams: Sequence[Sequence[Op]] = [streams]  # single program
    else:
        node_streams = streams
    emits: Dict[Tuple[str, Any], List[int]] = {}
    arrives: Dict[Tuple[str, Any], List[int]] = {}
    out: List[str] = []
    for ops in node_streams:
        for op in ops:
            if op[0] not in ("chk_emit", "chk_arrive"):
                continue
            _, carry, msg, w = op
            (emits if op[0] == "chk_emit" else arrives).setdefault(
                (carry, msg), []).append(w)
            if w % 2 == 0:
                out.append(f"M2: message {carry}/{msg} has EVEN weight "
                           f"{w} — a single-word corruption at an even "
                           "weight can vanish mod 2^32")
    for key in sorted(set(emits) | set(arrives), key=str):
        es, ar = emits.get(key, []), arrives.get(key, [])
        carry, msg = key
        if len(es) != len(ar):
            out.append(f"M2: message {carry}/{msg} has {len(es)} "
                       f"emission(s) but {len(ar)} arrival(s) — every "
                       "emission needs exactly one arrival partner")
        ws = set(es) | set(ar)
        if len(ws) > 1:
            out.append(f"M2: message {carry}/{msg} weighted "
                       f"inconsistently across emit/arrive: {sorted(ws)}")
    by_carry: Dict[str, Dict[int, Set[Any]]] = {}
    for (carry, msg), ws in list(emits.items()) + list(arrives.items()):
        for w in ws:
            by_carry.setdefault(carry, {}).setdefault(w, set()).add(msg)
    for carry, wmap in sorted(by_carry.items()):
        for w, msgs in sorted(wmap.items()):
            if len(msgs) > 1:
                out.append(
                    f"M2: weight collision in carry {carry!r}: messages "
                    f"{sorted(msgs, key=str)} all weighted {w} — their "
                    "corruptions alias in the conservation sum (the "
                    "per-axis weight-product class)")
    return out


# ---------------------------------------------------------------------------
# execution model 1: the ring credit-window protocol
# ---------------------------------------------------------------------------

class RingState:
    """Mutable interleaving state of a RingModel run.  Cloned only at
    branch points; the counterexample trace is a shared linked list so
    clones are O(state), not O(history)."""

    __slots__ = ("pc", "arrived", "slots", "credits", "flight",
                 "inflight_slots", "trace")

    def __init__(self, n: int, n_slots: int) -> None:
        self.pc = [0] * n
        self.arrived = [False] * n
        self.slots = [[-1] * n_slots for _ in range(n)]
        self.credits = [0] * n
        self.flight: Set[Tuple[int, int]] = set()
        # (dst, wire slot) -> number of in-flight transfers targeting it
        self.inflight_slots: Dict[Tuple[int, int], int] = {}
        self.trace: Optional[Tuple[Any, Any]] = None

    def clone(self) -> "RingState":
        st = RingState.__new__(RingState)
        st.pc = list(self.pc)
        st.arrived = list(self.arrived)
        st.slots = [list(s) for s in self.slots]
        st.credits = list(self.credits)
        st.flight = set(self.flight)
        st.inflight_slots = dict(self.inflight_slots)
        st.trace = self.trace
        return st

    def key(self) -> Tuple[Any, ...]:
        return (tuple(self.pc), tuple(self.arrived),
                tuple(map(tuple, self.slots)), tuple(self.credits),
                frozenset(self.flight))


class RingModel:
    """Small-step semantics of the ring credit-window protocol: n nodes
    running the IDENTICAL op stream, wire slots cycling mod n_slots,
    blocking semaphores, asynchronous landings.  Violations raised as
    ProtocolError; message wording is stable API (the fuzz backend's
    callers match on it)."""

    route = "ring"

    def __init__(self, n: int, ops: Sequence[Op], n_slots: int,
                 meta: Optional[Dict[str, Any]] = None) -> None:
        self.n = n
        self.ops = list(ops)
        self.n_slots = n_slots
        self.meta = dict(meta or {})
        self.total_sends = sum(1 for op in self.ops if op[0] == "send")
        self.credit_bound = min(self.total_sends, n_slots) \
            if self.total_sends else n_slots
        # strict_terminal adds the at-exit checks (no undecoded frame
        # left in a window, no leaked credits) on top of the legacy
        # simulator semantics; simulate_rs_protocol turns it off to
        # keep its published failure wording exact
        self.strict_terminal = True
        self.send_pos: Dict[int, int] = {
            op[1]: i for i, op in enumerate(self.ops) if op[0] == "send"}
        # emissions whose decode is NOT preceded by its wait_recv in
        # program order: landing q then commutes with NOTHING — the
        # decode-before-landing interleaving is realizable and must be
        # branched on, never resolved by an eager landing (in a correct
        # stream every decode is guarded and this set is empty; a
        # mutated stream that drops a wait_recv lands here — the POR
        # soundness hole a single-op-drop mutation sweep shows)
        first_wait: Dict[int, int] = {}
        self.unguarded_decodes: Set[int] = set()
        for i, op in enumerate(self.ops):
            if op[0] == "wait_recv" and op[1] not in first_wait:
                first_wait[op[1]] = i
            elif op[0] == "decode" and op[1] not in self.unguarded_decodes:
                if first_wait.get(op[1]) is None:
                    self.unguarded_decodes.add(op[1])

    # -- helpers -----------------------------------------------------------

    def _ctx(self) -> str:
        return " ".join(f"{k}={v}" for k, v in self.meta.items())

    def init_state(self) -> RingState:
        return RingState(self.n, self.n_slots)

    def node_count(self) -> int:
        return self.n

    def _landed(self, st: RingState, i: int, q: int) -> bool:
        pos = self.send_pos.get(q)
        return pos is not None and st.pc[i] > pos and (i, q) not in st.flight

    def _runnable(self, st: RingState, i: int) -> bool:
        if st.pc[i] >= len(self.ops):
            return False
        op = self.ops[st.pc[i]]
        kind = op[0]
        if kind == "barrier":
            return (not st.arrived[i]) or (st.arrived[(i - 1) % self.n]
                                           and st.arrived[(i + 1) % self.n])
        if kind == "wait_send":
            return self._landed(st, i, op[1])
        if kind == "credit_wait":
            return st.credits[i] >= 1
        if kind == "wait_recv":
            return st.slots[i][op[1] % self.n_slots] == op[1]
        if kind == "credit_drain":
            return st.credits[i] >= op[1]
        return True       # send / decode / credit_signal / dma / local

    def enabled(self, st: RingState) -> List[Action]:
        acts: List[Action] = [("node", i) for i in range(self.n)
                              if self._runnable(st, i)]
        acts.extend(("wire", s, q) for (s, q) in st.flight)
        return acts

    # -- transition --------------------------------------------------------

    def apply(self, st: RingState, act: Action) -> None:
        if act[0] == "wire":
            _, src, q = act
            dst = (src + 1) % self.n
            slot = q % self.n_slots
            st.trace = (("wire", src, q, dst, slot), st.trace)
            if st.slots[dst][slot] != -1:
                raise ProtocolError(
                    "recv_overwrite",
                    f"recv-slot overwrite: emission {q} landed on "
                    f"undecoded frame {st.slots[dst][slot]} in node "
                    f"{dst}'s slot {slot} ({self._ctx()})")
            st.slots[dst][slot] = q
            st.flight.discard((src, q))
            k = (dst, slot)
            c = st.inflight_slots.get(k, 0) - 1
            if c:
                st.inflight_slots[k] = c
            else:
                st.inflight_slots.pop(k, None)
            return
        i = act[1]
        op = self.ops[st.pc[i]]
        kind = op[0]
        st.trace = (("node", i, op), st.trace)
        if kind == "barrier":
            st.arrived[i] = True          # signal phase
            if not (st.arrived[(i - 1) % self.n]
                    and st.arrived[(i + 1) % self.n]):
                return                    # signaled; wait phase blocks
        elif kind == "send":
            q = op[1]
            slot = q % self.n_slots
            if any(s == i and t % self.n_slots == slot
                   for (s, t) in st.flight):
                raise ProtocolError(
                    "send_overwrite",
                    f"send-slot overwrite: emission {q} encoded over an "
                    f"in-flight frame in slot {slot} ({self._ctx()})")
            st.flight.add((i, q))
            k = ((i + 1) % self.n, slot)
            st.inflight_slots[k] = st.inflight_slots.get(k, 0) + 1
        elif kind == "decode":
            g = op[1]
            slot = g % self.n_slots
            got = st.slots[i][slot]
            if got != g:
                raise ProtocolError(
                    "ordering",
                    f"ordering corruption: decode of emission {g} found "
                    f"{'empty slot' if got == -1 else got} "
                    f"({self._ctx()})")
            st.slots[i][slot] = -1
        elif kind == "credit_signal":
            left = (i - 1) % self.n
            st.credits[left] += 1
            if st.credits[left] > self.credit_bound:
                raise ProtocolError(
                    "credit",
                    f"credit overflow: node {left} holds "
                    f"{st.credits[left]} credits for a {self.credit_bound}"
                    f"-slot window ({self._ctx()})")
        elif kind == "credit_wait":
            st.credits[i] -= 1
        elif kind == "credit_drain":
            st.credits[i] -= op[1]
        # wait_send / wait_recv / dma_* / encode / update / local:
        # guard already checked in _runnable; pc advance only
        st.pc[i] += 1

    # -- termination -------------------------------------------------------

    def finished(self, st: RingState) -> bool:
        return (not st.flight
                and all(p >= len(self.ops) for p in st.pc))

    def check_terminal(self, st: RingState) -> None:
        if not self.strict_terminal:
            return
        for i in range(self.n):
            for slot, got in enumerate(st.slots[i]):
                if got != -1:
                    raise ProtocolError(
                        "termination",
                        f"undecoded frame {got} left in node {i}'s slot "
                        f"{slot} at termination ({self._ctx()})")
        for i, c in enumerate(st.credits):
            if c != 0:
                raise ProtocolError(
                    "credit",
                    f"credit leak: node {i} terminates holding {c} "
                    f"credits ({self._ctx()})")

    def deadlock_message(self, st: RingState) -> str:
        nxt = [self.ops[p] if p < len(self.ops) else None for p in st.pc]
        return (f"protocol deadlock: {self._ctx()} pc={st.pc} next={nxt} "
                f"credits={st.credits} in_flight={sorted(st.flight)}")

    # -- partial-order reduction -------------------------------------------

    def pick_action(self, st: RingState,
                    acts: Sequence[Action]) -> Optional[Action]:
        """Singleton persistent set: an action that commutes with every
        other enabled action (and cannot race a future one — in-flight
        landings stay enabled until executed, so every latent conflict
        has an enabled witness).  An action whose violation condition is
        already live is returned too: the schedule freedom that makes it
        fire exists, so exploring it first IS the counterexample.
        Returns None when only mutually-dependent actions remain (full
        branch)."""
        for act in acts:
            if act[0] == "wire":
                _, src, q = act
                dst = (src + 1) % self.n
                slot = q % self.n_slots
                if st.slots[dst][slot] != -1:
                    return act            # violation live: explore it
                if q in self.unguarded_decodes:
                    continue              # decode(q) may run BEFORE this
                                          # landing (no wait_recv guard):
                                          # both orders must be explored
                if st.inflight_slots.get((dst, slot), 0) > 1:
                    continue              # racing same-slot landing
                if self._slot_sensitive(st, dst, slot):
                    continue              # dst decode of this slot pending
                if self._send_pending(st, src, slot):
                    continue              # src send-overwrite race
                return act
            i = act[1]
            op = self.ops[st.pc[i]]
            kind = op[0]
            if kind == "send":
                slot = op[1] % self.n_slots
                if any(s == i and t % self.n_slots == slot
                       for (s, t) in st.flight):
                    return act            # violation live: explore it
                return act
            if kind in ("decode", "wait_recv"):
                slot = op[1] % self.n_slots
                if st.inflight_slots.get((i, slot), 0) > 0:
                    continue              # landing may race this slot
                return act
            if kind == "credit_signal":
                left = (i - 1) % self.n
                if st.credits[left] >= self.credit_bound:
                    return act            # overflow live: explore it
                return act
            # barrier / credit_wait / credit_drain / wait_send / dma /
            # encode / update / local: commute with everything enabled
            return act
        return None

    def _slot_sensitive(self, st: RingState, dst: int, slot: int) -> bool:
        # only an ENABLED partner can conflict: decode is always
        # enabled, but a wait_recv blocked on this slot is not a
        # partner — the landing merely enables it (they commute)
        if st.pc[dst] >= len(self.ops):
            return False
        op = self.ops[st.pc[dst]]
        return op[0] == "decode" and op[1] % self.n_slots == slot

    def _send_pending(self, st: RingState, src: int, slot: int) -> bool:
        if st.pc[src] >= len(self.ops):
            return False
        op = self.ops[st.pc[src]]
        return op[0] == "send" and op[1] % self.n_slots == slot


# ---------------------------------------------------------------------------
# execution model 2: tag-matched pair transfers (the XLA ppermute hop)
# ---------------------------------------------------------------------------

class PairState:
    """Mutable interleaving state of a PairModel run."""

    __slots__ = ("pc", "flight", "landed", "trace")

    def __init__(self, n: int) -> None:
        self.pc = [0] * n
        self.flight: Set[Tuple[int, int, Any]] = set()
        self.landed: Set[Tuple[int, int, Any]] = set()
        self.trace: Optional[Tuple[Any, Any]] = None

    def clone(self) -> "PairState":
        st = PairState.__new__(PairState)
        st.pc = list(self.pc)
        st.flight = set(self.flight)
        st.landed = set(self.landed)
        st.trace = self.trace
        return st

    def key(self) -> Tuple[Any, ...]:
        return (tuple(self.pc), frozenset(self.flight),
                frozenset(self.landed))


class PairModel:
    """Small-step semantics of directed tag-matched transfers: a send
    never blocks (the payload is in flight until its landing event), a
    recv blocks until its exact (src, tag) payload has landed and then
    consumes it.  Models the lowered single-pair ppermute programs
    (reshard) and the subring hop chains (hier), where the failure modes
    are mismatched program orders (deadlock) and orphaned payloads
    (ordering)."""

    route = "pair"

    def __init__(self, streams: Sequence[Sequence[Op]],
                 meta: Optional[Dict[str, Any]] = None) -> None:
        self.streams = [list(s) for s in streams]
        self.n = len(self.streams)
        self.meta = dict(meta or {})

    def _ctx(self) -> str:
        return " ".join(f"{k}={v}" for k, v in self.meta.items())

    def init_state(self) -> PairState:
        return PairState(self.n)

    def node_count(self) -> int:
        return self.n

    def _runnable(self, st: PairState, i: int) -> bool:
        if st.pc[i] >= len(self.streams[i]):
            return False
        op = self.streams[i][st.pc[i]]
        if op[0] == "recv_from":
            return (op[1], i, op[2]) in st.landed
        return True

    def enabled(self, st: PairState) -> List[Action]:
        acts: List[Action] = [("node", i) for i in range(self.n)
                              if self._runnable(st, i)]
        acts.extend(("wire",) + t for t in st.flight)
        return acts

    def apply(self, st: PairState, act: Action) -> None:
        if act[0] == "wire":
            t = (act[1], act[2], act[3])
            st.trace = (("wire",) + t, st.trace)
            st.flight.discard(t)
            st.landed.add(t)
            return
        i = act[1]
        op = self.streams[i][st.pc[i]]
        st.trace = (("node", i, op), st.trace)
        if op[0] == "send_to":
            t = (i, op[1], op[2])
            if t in st.flight or t in st.landed:
                raise ProtocolError(
                    "send_overwrite",
                    f"duplicate emission: payload {op[2]!r} {i}->{op[1]} "
                    f"sent while a previous copy is outstanding "
                    f"({self._ctx()})")
            st.flight.add(t)
        elif op[0] == "recv_from":
            st.landed.discard((op[1], i, op[2]))
        st.pc[i] += 1

    def finished(self, st: PairState) -> bool:
        return (not st.flight
                and all(st.pc[i] >= len(self.streams[i])
                        for i in range(self.n)))

    def check_terminal(self, st: PairState) -> None:
        if st.landed:
            orphan = sorted(st.landed)[0]
            raise ProtocolError(
                "termination",
                f"orphan payload (ordering corruption): {orphan[2]!r} "
                f"{orphan[0]}->{orphan[1]} landed but never consumed "
                f"({self._ctx()}; {len(st.landed)} total)")

    def deadlock_message(self, st: PairState) -> str:
        nxt = [self.streams[i][p] if p < len(self.streams[i]) else None
               for i, p in enumerate(st.pc)]
        return (f"protocol deadlock: {self._ctx()} pc={st.pc} next={nxt} "
                f"in_flight={sorted(st.flight)}")

    def pick_action(self, st: PairState,
                    acts: Sequence[Action]) -> Optional[Action]:
        # every action commutes with every other: tags are unique per
        # payload, sends never block, landings only enable — so the
        # first enabled action is always a singleton persistent set
        return acts[0] if acts else None


# ---------------------------------------------------------------------------
# execution model 3: single-node async-DMA programs (the paged gather)
# ---------------------------------------------------------------------------


class GatherState:
    """Mutable interleaving state of a GatherModel run — one program
    counter plus the two async-DMA populations (issued-not-landed,
    landed-not-waited)."""

    __slots__ = ("pc", "flight", "landed", "trace")

    def __init__(self) -> None:
        self.pc = 0
        self.flight: Set[Tuple[str, int]] = set()
        self.landed: Set[Tuple[str, int]] = set()
        self.trace: Optional[Tuple[Any, Any]] = None

    def clone(self) -> "GatherState":
        st = GatherState.__new__(GatherState)
        st.pc = self.pc
        st.flight = set(self.flight)
        st.landed = set(self.landed)
        st.trace = self.trace
        return st

    def key(self) -> Tuple[Any, ...]:
        return (self.pc, frozenset(self.flight), frozenset(self.landed))


class GatherModel:
    """Small-step semantics of a single-node async-DMA program (the
    paged gather-attend schedule): ``dma_start`` issues a transfer whose
    completion is an ASYNCHRONOUS hardware event (a ``land`` action at
    an arbitrary later scheduler step); ``dma_wait`` blocks until that
    page's transfer has landed, then consumes its semaphore.  The
    dynamic failure mode this model owns is semaphore-slot aliasing —
    the semaphores cycle mod ``depth``, so a start whose slot still
    holds an unconsumed (in-flight or landed-but-unwaited) transfer
    would let the EARLIER completion satisfy the LATER wait: an
    overlapping-slot read serving attend data that never landed.  The
    static obligations (exact live-page coverage, per-node DMA
    discipline) run first in `verify.mc._static_violations`."""

    route = "gather"

    def __init__(self, ops: Sequence[Op], depth: int,
                 meta: Optional[Dict[str, Any]] = None) -> None:
        self.ops = list(ops)
        self.depth = depth
        self.meta = dict(meta or {})

    def _ctx(self) -> str:
        return " ".join(f"{k}={v}" for k, v in self.meta.items())

    def init_state(self) -> GatherState:
        return GatherState()

    def node_count(self) -> int:
        return 1

    def _runnable(self, st: GatherState) -> bool:
        if st.pc >= len(self.ops):
            return False
        op = self.ops[st.pc]
        if op[0] == "dma_wait":
            return (op[1], op[2]) in st.landed
        return True

    def enabled(self, st: GatherState) -> List[Action]:
        acts: List[Action] = [("node", 0)] if self._runnable(st) else []
        acts.extend(("land", chan, i) for (chan, i) in sorted(st.flight))
        return acts

    def apply(self, st: GatherState, act: Action) -> None:
        if act[0] == "land":
            _, chan, i = act
            st.trace = (act, st.trace)
            st.flight.discard((chan, i))
            st.landed.add((chan, i))
            return
        op = self.ops[st.pc]
        st.trace = (("node", 0, op), st.trace)
        if op[0] == "dma_start":
            _, chan, i, _conf = op
            slot = i % self.depth
            clash = sorted((c, j) for (c, j) in (st.flight | st.landed)
                           if c == chan and j % self.depth == slot)
            if clash:
                raise ProtocolError(
                    "dma",
                    f"overlapping-slot read: {chan}[{i}] starts into "
                    f"semaphore slot {slot} while {clash[0][0]}"
                    f"[{clash[0][1]}] is unconsumed there — its landing "
                    f"would satisfy the wrong wait ({self._ctx()})")
            st.flight.add((chan, i))
        elif op[0] == "dma_wait":
            st.landed.discard((op[1], op[2]))
        st.pc += 1

    def finished(self, st: GatherState) -> bool:
        return (st.pc >= len(self.ops) and not st.flight
                and not st.landed)

    def check_terminal(self, st: GatherState) -> None:
        # drain is part of `finished`; a started-never-waited stream can
        # never terminate (its landed entry persists) and surfaces as
        # the static exit-drain violation / a dynamic deadlock instead
        return

    def deadlock_message(self, st: GatherState) -> str:
        nxt = self.ops[st.pc] if st.pc < len(self.ops) else None
        return (f"protocol deadlock: {self._ctx()} pc={st.pc} next={nxt} "
                f"in_flight={sorted(st.flight)} "
                f"landed={sorted(st.landed)}")

    def pick_action(self, st: GatherState,
                    acts: Sequence[Action]) -> Optional[Action]:
        # a landing only moves a transfer flight -> landed: the
        # start-clash predicate reads the UNION of the two sets, so
        # landings commute with every node step and with each other,
        # and node steps are the only pc mutators.  The first enabled
        # action is therefore always a singleton persistent set —
        # violations included: a clashing start raises on apply in
        # EVERY interleaving (the predicate is interleaving-invariant),
        # so no schedule freedom is needed to witness it.
        return acts[0] if acts else None


# ---------------------------------------------------------------------------
# the serving control-plane emitter (graftsched, verify.sched)
# ---------------------------------------------------------------------------

# request lifecycle vocabulary, the strings runtime.requests carries,
# redeclared here so the rules (and the model built on them) import no
# torch and no numpy; tests/test_torch_sched_model.py pins the equality
SCHED_WAITING = "waiting"
SCHED_PREFILL = "prefill"
SCHED_DECODE = "decode"
SCHED_FINISHED = "finished"


class SchedEmitter:
    """One definition of each scheduling rule (see module docstring)."""

    # -- batcher: commitment-aware watermark admission ----------------------

    @staticmethod
    def replay_target(n_tokens: int) -> int:
        """Positions a (re)admission must prefill before decode resumes:
        prompt + generated minus the newest token, whose K/V the resuming
        decode step writes itself (== ``Request.n_tokens``)."""
        return n_tokens

    @staticmethod
    def admission_need(replay_len: int) -> int:
        """Positions the free-page watermark must cover to admit: the
        replay plus one decode step, so admission never thrashes."""
        return replay_len + 1

    @staticmethod
    def committed_target(state: str, replay_len: int,
                         n_tokens: int) -> int:
        """Positions a live request will claim without a new admission
        decision: its replay + first decode while prefilling, its next
        position while decoding."""
        return (replay_len + 1 if state == SCHED_PREFILL
                else n_tokens + 1)

    @staticmethod
    def committed_outstanding(entries: Sequence[Tuple[int, int]]) -> int:
        """Pages promised but not yet allocated (allocation is lazy), over
        (target_pages, held_pages) pairs of every live request."""
        return sum(max(0, target - held) for target, held in entries)

    @staticmethod
    def admit_ok(free: int, committed: int, need: int) -> bool:
        """The watermark: admit only while the uncommitted free pages
        cover the candidate's own need."""
        return free - committed >= need

    @staticmethod
    def pick_victim(admit_seqs: Sequence[int]) -> Optional[int]:
        """LIFO eviction: the newest-admitted candidate.  The oldest
        request then always progresses, so any workload whose single worst
        request fits the pool terminates."""
        if not admit_seqs:
            return None
        return max(range(len(admit_seqs)), key=lambda i: admit_seqs[i])

    @staticmethod
    def pick_oldest(admit_seqs: Sequence[int]) -> Optional[int]:
        """Oldest-admitted candidate — the prefill-chunk order."""
        if not admit_seqs:
            return None
        return min(range(len(admit_seqs)), key=lambda i: admit_seqs[i])

    @staticmethod
    def decode_order(admit_seqs: Sequence[int]) -> List[int]:
        """Decode-batch service order: oldest first."""
        return sorted(range(len(admit_seqs)), key=lambda i: admit_seqs[i])

    @staticmethod
    def prefill_chunk_len(chunk: int, replay_len: int, start: int) -> int:
        """True (unpadded) token count of this tick's prefill chunk."""
        return min(chunk, replay_len - start)

    # -- fleet: routing + membership ----------------------------------------

    @staticmethod
    def route_least_loaded(loads: Sequence[Tuple[int, int]]
                           ) -> Optional[int]:
        """Least-loaded routing with stable ties: index of the minimum
        (load, replica_idx) pair."""
        if not loads:
            return None
        return min(range(len(loads)), key=lambda i: loads[i])

    @staticmethod
    def pick_kill_victim(loads: Sequence[Tuple[int, int]]
                         ) -> Optional[int]:
        """Chaos kill target: the most loaded candidate, ties to the
        lowest replica idx."""
        if not loads:
            return None
        return max(range(len(loads)),
                   key=lambda i: (loads[i][0], -loads[i][1]))

    @staticmethod
    def migration_action(state: str, has_pages: bool,
                         migratable: bool) -> str:
        """Per request on a replica kill: 'migrate' live KV when the pool
        is still addressable, 'reroute' a pageless request, 'replay'
        otherwise."""
        if (migratable and state in (SCHED_DECODE, SCHED_PREFILL)
                and has_pages):
            return "migrate"
        if not has_pages:
            return "reroute"
        return "replay"

    # -- autoscaler: CUSUM detection + action gates -------------------------

    @staticmethod
    def load_residual(queue_depth: float, target_per_decode: float,
                      n_decode: int) -> float:
        """Relative queue-depth excess over what the decode pool should
        absorb."""
        return queue_depth / (target_per_decode * n_decode) - 1.0

    @staticmethod
    def cusum_step(pos: float, neg: float, cooldown: int, resid: float,
                   drift: float, threshold: float, cooldown_steps: int
                   ) -> Tuple[float, float, int,
                              Optional[Tuple[str, float]]]:
        """One two-sided CUSUM update with hysteresis; a trip resets both
        sides and arms the cooldown."""
        if cooldown > 0:
            return pos, neg, cooldown - 1, None
        r = float(resid)
        pos = max(0.0, pos + r - drift)
        neg = max(0.0, neg + (-r) - drift)
        if pos >= threshold:
            trip = ("slow", pos)
        elif neg >= threshold:
            trip = ("fast", neg)
        else:
            return pos, neg, 0, None
        return 0.0, 0.0, cooldown_steps, trip

    @staticmethod
    def scale_up_fallback(n_prefill_pure: int, rebalance_idx: int) -> str:
        """With no spare device, a 'slow' trip rebalances a surplus
        pure-prefill replica (never the last one), else is suppressed."""
        return ("rebalance"
                if n_prefill_pure >= 2 and rebalance_idx >= 0
                else "suppress")

    @staticmethod
    def scale_down_ok(n_decode_pure: int, min_decode: int,
                      queue_depth: float, scale_in_idx: int) -> bool:
        """A 'fast' trip drains a pure decode replica only above the
        floor, with an empty queue, and with a valid target."""
        return (n_decode_pure > min_decode and queue_depth == 0
                and scale_in_idx >= 0)

    @staticmethod
    def shed_action(hold: bool, free_frac: float, lo: float,
                    hi: float) -> Optional[str]:
        """The admission shed valve's hysteresis band on the free-page
        fraction."""
        if not hold and free_frac < lo:
            return "shed_on"
        if hold and free_frac > hi:
            return "shed_off"
        return None


SCHED_RULES = SchedEmitter()
