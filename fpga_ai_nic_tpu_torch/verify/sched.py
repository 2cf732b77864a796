"""The exhaustive control-plane model of the serving plane: the port of
the JAX package's ``verify/sched.py`` (docs/MODELCHECK.md "The
control-plane family").

The wire families (flat/streaming/ag/hier/reshard/handoff/gather) model
PROTOCOLS: op streams with asynchronous landings.  The serving control
plane — `serve.scheduler.ContinuousBatcher`, `serve.fleet.ServeFleet`,
`serve.autoscale.Autoscaler` — is the same shape of artifact one level
up: a bounded concurrent state machine whose bug classes (admit-thrash,
page leaks, evict/readmit livelock, scaler flapping) were each caught by
EXAMPLE during development, never exhaustively.  This module closes that
gap the emitter way: a small-step model whose every policy decision is a
call into the ONE-definition `opstream.SchedEmitter` rules the real hot
paths also consume, explored exhaustively by `verify.mc.check` over the
(R x P x K x fault) envelope.

The model (one `apply` per micro-phase of a fleet tick, mirroring
`ServeFleet.tick`'s exact order):

  boundary      the only genuine nondeterminism besides handoff faults:
                in a "kill" cell a replica preemption may land at ANY
                tick boundary (before routing — the same
                `state_buffers_alive` gate the real chaos site has), or
                not at all.  Exhaustive over fault timing.
  route         arrivals -> least-loaded prefill replica (held while
                the shed valve is closed; deferred, never dropped).
  drain         completed prefills hand off to decode replicas.  The
                handoff is split begin/land so a mid-handoff state (dst
                pages reserved, src pages still resident) is a real
                explored state; in a "handoff-fail" cell the land may
                fail (bounded by the fault budget) and the request
                degrades to the replay tier.  A full decode fleet PARKS
                the request (backpressure, not replay).
  engine        one replica's engine tick: watermark admission, decode
                page claims (oldest first), then the prefill chunk —
                whose page demand may evict the newest selected
                decoder, exactly `ServeEngine._tick`'s order.
  decode_drain  evictions on a decode replica replay through a prefill
                worker (front of queue).
  scaler        `Autoscaler.observe_tick`: the CUSUM step, scale/
                rebalance/shed gates, then the liveness bookkeeping.

Checked invariants (ProtocolError kinds):

  conservation  free + promised + resident == pool per ALIVE replica at
                EVERY state — mid-handoff (the in-flight reservation
                counts at the destination) and post-kill included;
                free >= 0.  Pages on a dead replica die with its pool.
  watermark     at every admission EVENT the sum of committed targets
                on that replica must fit the pool ("over-commit").
                Scoped to admissions because a kill-path migration may
                legally over-commit a survivor transiently — the
                eviction tier absorbs it; admission never may.
  liveness      every submitted request reaches FINISHED on every path
                (checked terminally + via the tick bound).
  livelock      a strictly-increasing progress measure: total generated
                tokens must grow within ``STALL_LIMIT`` consecutive
                ticks while any request is unfinished (the evict/
                readmit livelock class), plus a hard per-cell tick
                bound.
  flap          no opposite-direction scale actions within the cooldown
                window (the hysteresis invariant).

Anti-vacuity mutants (``mutate=``): "leak_evict" (eviction returns one
page short -> conservation), "drop_watermark" (admission skips the
watermark -> over-commit), "no_evict" (a dry pool never evicts ->
livelock), "drop_cooldown" (the detector's hysteresis — re-arm
cooldown AND drift slack — disabled -> flap).  Two ride as ``--fixture`` models of
``python -m fpga_ai_nic_tpu_torch.verify``; the full mutation sweep is
pinned POR-vs-naive by tests/test_torch_sched_model.py.

Soundness boundary: page_size is 1 (pages == positions, `pages_for` is
the identity) and prompt_len is 1 — page granularity is an exact linear
rescale the allocator fuzz covers, not a scheduling behavior.  All
nondeterminism is fault TIMING; every deterministic segment is a
singleton persistent set (`pick_action`), so POR explores exactly the
fault-timing tree and the naive DFS must agree cell-for-cell.

No torch/numpy import anywhere — plain-Python state exploration, same as
the rest of the package.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

from .opstream import (SCHED_DECODE, SCHED_FINISHED, SCHED_PREFILL,
                       SCHED_RULES, SCHED_WAITING, Action, ProtocolError)

__all__ = ["SchedConfig", "SchedState", "SchedModel", "build_sched",
           "sched_cells", "SCHED_FAULTS", "SCHED_MUTANTS",
           "SCHED_VIOLATION_KINDS"]

SCHED_FAULTS: Tuple[str, ...] = ("none", "kill", "handoff-fail")

# the anti-vacuity mutation surface (SchedModel(mutate=...)) and the
# invariant each one must trip — tests/test_torch_sched_model.py sweeps these
SCHED_MUTANTS: Dict[str, str] = {
    "leak_evict": "conservation",
    "drop_watermark": "watermark",
    "no_evict": "livelock",
    "drop_cooldown": "flap",
}

SCHED_VIOLATION_KINDS: Tuple[str, ...] = (
    "conservation", "watermark", "liveness", "livelock", "flap")

# request record layout (plain lists: cheap clone + hashable key)
R_STATE, R_REP, R_HELD, R_REPLAY, R_DONE, R_GEN, R_SEQ = range(7)
# replica record layout
P_ALIVE, P_ROLE, P_FREE, P_WAIT = range(4)

STALL_LIMIT = 10


class SchedConfig:
    """One envelope cell's constants.  The detector constants are the
    REAL rules at model scale: drift/threshold shrunk so trips are
    reachable inside a handful of ticks (the rule functions themselves
    are the shared `SCHED_RULES` — only the operating point moves)."""

    def __init__(self, n_reqs: int, pages: int, n_replicas: int,
                 fault: str) -> None:
        assert fault in SCHED_FAULTS, fault
        self.n_reqs = n_reqs
        self.pages = pages               # usable pages per replica pool
        self.n_replicas = n_replicas
        self.fault = fault
        self.prompt_len = 1
        # worst-case footprint prompt + max_new must fit one pool — the
        # `validate_shape` precondition the liveness claim leans on
        self.max_new = 1 if pages == 2 else (2 if pages == 3 else 3)
        self.slots = 2                   # decode slots per replica
        self.prefill_chunk = 1
        self.spares = 1                  # spare devices for scale-out
        # autoscaler operating point (see class docstring)
        self.target_per_decode = 1.0
        self.drift = 0.5
        self.threshold = 1.0
        # = the no-flap window; clean runs cannot flap because after
        # any trip the detector sleeps cooldown ticks, so an opposite
        # trip lands at earliest T + cooldown + 1 — OUTSIDE the window
        self.cooldown_ticks = 3
        self.min_decode = 1
        self.shed_lo = 0.10
        self.shed_hi = 0.30

    def roles(self) -> List[str]:
        if self.n_replicas == 1:
            return ["both"]
        return ["prefill"] + ["decode"] * (self.n_replicas - 1)


class SchedState:
    """The full control-plane state: requests, per-replica ledgers, the
    in-flight handoff reservation, detector statistics and the liveness
    bookkeeping.  ``trace`` is the reversed action list (shared-tail
    cons cells, the `RingState` idiom)."""

    __slots__ = ("phase", "intake", "reqs", "reps", "inflight", "tried",
                 "pos", "neg", "cooldown", "hold", "spares",
                 "fault_left", "tick", "last_dir", "last_tick", "stall",
                 "last_tokens", "seq", "trace")

    def __init__(self, cfg: SchedConfig) -> None:
        self.phase: Tuple[Any, ...] = ("boundary",)
        self.intake: List[int] = list(range(cfg.n_reqs))
        self.reqs: List[List[Any]] = [
            [SCHED_WAITING, -1, 0, cfg.prompt_len, 0, 0, -1]
            for _ in range(cfg.n_reqs)]
        self.reps: List[List[Any]] = [
            [1, role, cfg.pages, []] for role in cfg.roles()]
        self.inflight: Optional[Tuple[int, int, int]] = None
        self.tried: List[int] = []       # drain attempts this tick
        self.pos = 0.0
        self.neg = 0.0
        self.cooldown = 0
        self.hold = False
        self.spares = cfg.spares
        self.fault_left = 0 if cfg.fault == "none" else 1
        self.tick = 0
        self.last_dir = ""               # last scale action direction
        self.last_tick = -1
        self.stall = 0
        self.last_tokens = 0
        self.seq = 0                     # admission-order counter
        self.trace: Optional[Tuple[Any, Any]] = None

    def clone(self) -> "SchedState":
        st = SchedState.__new__(SchedState)
        st.phase = self.phase
        st.intake = list(self.intake)
        st.reqs = [list(r) for r in self.reqs]
        st.reps = [[r[P_ALIVE], r[P_ROLE], r[P_FREE], list(r[P_WAIT])]
                   for r in self.reps]
        st.inflight = self.inflight
        st.tried = list(self.tried)
        st.pos = self.pos
        st.neg = self.neg
        st.cooldown = self.cooldown
        st.hold = self.hold
        st.spares = self.spares
        st.fault_left = self.fault_left
        st.tick = self.tick
        st.last_dir = self.last_dir
        st.last_tick = self.last_tick
        st.stall = self.stall
        st.last_tokens = self.last_tokens
        st.seq = self.seq
        st.trace = self.trace
        return st

    def key(self) -> Tuple[Any, ...]:
        return (self.phase, tuple(self.intake),
                tuple(tuple(r) for r in self.reqs),
                tuple((r[P_ALIVE], r[P_ROLE], r[P_FREE],
                       tuple(r[P_WAIT])) for r in self.reps),
                self.inflight, tuple(self.tried), self.pos, self.neg,
                self.cooldown, self.hold, self.spares, self.fault_left,
                self.tick, self.last_dir, self.last_tick, self.stall,
                self.last_tokens, self.seq)


class SchedModel:
    """Small-step model conforming to the `verify.mc.check` contract.
    Every policy decision is a `SCHED_RULES` call — the model never
    re-derives a rule the serving plane ships."""

    route = "sched"

    def __init__(self, cfg: SchedConfig, meta: Dict[str, Any],
                 mutate: Optional[str] = None) -> None:
        assert mutate is None or mutate in SCHED_MUTANTS, mutate
        self.cfg = cfg
        self.meta = dict(meta)
        self.mutate = mutate
        # generous liveness bound: a clean run terminates well inside
        # it on every fault timing; exceeding it IS the livelock verdict
        self.max_ticks = (16 + 8 * cfg.n_reqs * cfg.max_new
                          + 6 * cfg.n_replicas)

    # -- mc.check contract ---------------------------------------------------

    def node_count(self) -> int:
        return self.cfg.n_replicas + self.cfg.spares

    def init_state(self) -> SchedState:
        return SchedState(self.cfg)

    def finished(self, st: SchedState) -> bool:
        return all(q[R_STATE] == SCHED_FINISHED for q in st.reqs)

    def check_terminal(self, st: SchedState) -> None:
        for rid, q in enumerate(st.reqs):
            if q[R_STATE] != SCHED_FINISHED:
                raise ProtocolError(
                    "liveness",
                    f"request {rid} never finished (state "
                    f"{q[R_STATE]!r}, {q[R_GEN]}/{self.cfg.max_new} "
                    "tokens) — an admitted request must terminate")
        for k, rep in enumerate(st.reps):
            if rep[P_ALIVE] and rep[P_FREE] != self.cfg.pages:
                raise ProtocolError(
                    "conservation",
                    f"replica {k} pool not fully free at termination: "
                    f"{rep[P_FREE]}/{self.cfg.pages} — pages leaked")

    def deadlock_message(self, st: SchedState) -> str:
        return (f"control-plane deadlock at phase {st.phase} tick "
                f"{st.tick} ({self._ctx()})")

    def enabled(self, st: SchedState) -> List[Action]:
        ph = st.phase[0]
        # quiescence IS termination (the run_random contract: no enabled
        # action + finished() -> clean exit); mid-tick phases still step
        # so the trailing scaler/conservation checks run
        if ph == "boundary" and self.finished(st):
            return []
        if ph == "boundary":
            acts: List[Action] = [("tick",)]
            if (self.cfg.fault == "kill" and st.fault_left
                    and self._n_alive(st) > 1):
                acts.append(("kill",))
            return acts
        if ph == "land":
            acts = [("land_ok",)]
            if self.cfg.fault == "handoff-fail" and st.fault_left:
                acts.append(("land_fail",))
            return acts
        return [("step",)]

    def pick_action(self, st: SchedState,
                    acts: Sequence[Action]) -> Optional[Action]:
        # every phase is deterministic except the two genuine fault
        # races (kill timing, handoff landing): a lone enabled action is
        # its own persistent set — no other action exists to commute
        # with — so POR replays exactly the fault-timing tree and the
        # naive DFS must agree (pinned by tests/test_torch_sched_model.py)
        return acts[0] if len(acts) == 1 else None

    def apply(self, st: SchedState, act: Action) -> None:
        ph = st.phase[0]
        actor = st.phase[1] if ph == "engine" else 0
        st.trace = ((("node", actor, (ph,) + act + (st.tick,)),
                     st.trace))
        if ph == "boundary":
            if st.tick > self.max_ticks:
                raise ProtocolError(
                    "livelock",
                    f"tick bound {self.max_ticks} exceeded with "
                    "unfinished requests — the progress measure is not "
                    f"decreasing ({self._ctx()})")
            if act == ("kill",):
                st.fault_left -= 1
                self._kill(st, self._chaos_victim(st))
            st.phase = ("route",)
        elif ph == "route":
            self._route_arrivals(st)
        elif ph == "drain":
            self._drain_step(st)
        elif ph == "land":
            self._land(st, act)
        elif ph == "engine":
            self._engine_tick(st, st.phase[1])
        elif ph == "decode_drain":
            self._decode_drain(st)
        else:
            assert ph == "scaler", ph
            self._scaler(st)
        self._check_conservation(st)

    # -- shared helpers ------------------------------------------------------

    def _ctx(self) -> str:
        return ", ".join(f"{k}={v}" for k, v in self.meta.items())

    def _n_alive(self, st: SchedState) -> int:
        return sum(1 for r in st.reps if r[P_ALIVE])

    def _n_tokens(self, q: List[Any]) -> int:
        g = q[R_GEN]
        return self.cfg.prompt_len + (g - 1 if g else 0)

    def _target(self, q: List[Any]) -> int:
        return SCHED_RULES.committed_target(
            q[R_STATE], q[R_REPLAY], self._n_tokens(q))

    def _on(self, st: SchedState, k: int) -> List[int]:
        """Live (slot-holding) request ids on replica k."""
        return [rid for rid, q in enumerate(st.reqs)
                if q[R_REP] == k
                and q[R_STATE] in (SCHED_PREFILL, SCHED_DECODE)]

    def _load(self, st: SchedState, k: int) -> int:
        return len(self._on(st, k)) + len(st.reps[k][P_WAIT])

    def _alive_idx(self, st: SchedState,
                   role: Optional[str] = None) -> List[int]:
        out = [k for k, r in enumerate(st.reps) if r[P_ALIVE]]
        if role is not None:
            out = [k for k in out
                   if st.reps[k][P_ROLE] in (role, "both")]
        return out

    def _route_to_prefill(self, st: SchedState, rid: int,
                          front: bool) -> None:
        cands = self._alive_idx(st, "prefill")
        pos = SCHED_RULES.route_least_loaded(
            [(self._load(st, k), k) for k in cands])
        assert pos is not None, "no prefill-capable replica alive"
        wait = st.reps[cands[pos]][P_WAIT]
        if front:
            wait.insert(0, rid)
        else:
            wait.append(rid)

    def _replay_fallback(self, st: SchedState, rid: int) -> None:
        """The degraded tier: KV pages released (or lost with a dead
        pool), generated tokens kept, front-of-line re-prefill."""
        q = st.reqs[rid]
        k = q[R_REP]
        if k >= 0 and q[R_HELD]:
            st.reps[k][P_FREE] += q[R_HELD]
        q[R_HELD] = 0
        q[R_STATE] = SCHED_WAITING
        q[R_DONE] = 0
        q[R_REP] = -1
        q[R_REPLAY] = SCHED_RULES.replay_target(self._n_tokens(q))
        self._route_to_prefill(st, rid, front=True)

    # -- per-phase transitions ----------------------------------------------

    def _route_arrivals(self, st: SchedState) -> None:
        if not st.hold:
            while st.intake:
                self._route_to_prefill(st, st.intake.pop(0), front=False)
        st.phase = ("drain",)

    def _drain_step(self, st: SchedState) -> None:
        """One prefill->decode handoff attempt per apply (so the
        mid-handoff state is explorable); parks mark ``tried`` and the
        scan resumes next apply.  No candidate left -> engine phase."""
        for k in self._alive_idx(st):
            if st.reps[k][P_ROLE] != "prefill":
                continue                 # 'both' decodes locally
            done = sorted(
                (st.reqs[rid][R_SEQ], rid) for rid in self._on(st, k)
                if st.reqs[rid][R_STATE] == SCHED_DECODE)
            for _, rid in done:
                if rid in st.tried:
                    continue
                st.tried.append(rid)
                n = st.reqs[rid][R_HELD]
                dsts = [d for d in self._alive_idx(st, "decode")
                        if len(self._on(st, d)) < self.cfg.slots
                        and st.reps[d][P_FREE] >= n]
                pos = SCHED_RULES.route_least_loaded(
                    [(self._load(st, d), d) for d in dsts])
                if pos is None:
                    return               # parked: retry next tick
                if n == 0:
                    self._replay_fallback(st, rid)
                    return
                dst = dsts[pos]
                st.reps[dst][P_FREE] -= n       # dst reservation
                st.inflight = (rid, dst, n)
                st.phase = ("land",)
                return
        st.phase = ("engine", 0)

    def _land(self, st: SchedState, act: Action) -> None:
        assert st.inflight is not None
        rid, dst, n = st.inflight
        q = st.reqs[rid]
        if act == ("land_ok",):
            # src pages free, the dst reservation becomes resident; the
            # adopt bumps admit_seq (the real `ContinuousBatcher.adopt`)
            st.reps[q[R_REP]][P_FREE] += q[R_HELD]
            q[R_REP] = dst
            q[R_HELD] = n
            st.seq += 1
            q[R_SEQ] = st.seq
        else:
            # injected handoff fault: the reservation unwinds and the
            # request degrades to the replay tier (tokens kept)
            st.fault_left -= 1
            st.reps[dst][P_FREE] += n
            self._replay_fallback(st, rid)
        st.inflight = None
        st.phase = ("drain",)

    def _engine_tick(self, st: SchedState, k: int) -> None:
        rep = st.reps[k]
        if rep[P_ALIVE]:
            role = rep[P_ROLE]
            if role != "decode":
                self._admit(st, k)
            # decode page claims FIRST, then the prefill chunk — whose
            # demand may evict the newest selected decoder (the batch
            # is re-filtered below): ServeEngine._tick's exact order
            dec: List[int] = []
            if role != "prefill":
                cands = [rid for rid in self._on(st, k)
                         if st.reqs[rid][R_STATE] == SCHED_DECODE]
                for pos in SCHED_RULES.decode_order(
                        [st.reqs[rid][R_SEQ] for rid in cands]):
                    rid = cands[pos]
                    if st.reqs[rid][R_STATE] != SCHED_DECODE:
                        continue         # evicted by an older sibling
                    if self._ensure(st, k, rid,
                                    self._n_tokens(st.reqs[rid]) + 1):
                        dec.append(rid)
            pre: Optional[Tuple[int, int]] = None
            if role != "decode":
                cands = [rid for rid in self._on(st, k)
                         if st.reqs[rid][R_STATE] == SCHED_PREFILL]
                pos = SCHED_RULES.pick_oldest(
                    [st.reqs[rid][R_SEQ] for rid in cands])
                if pos is not None:
                    rid = cands[pos]
                    q = st.reqs[rid]
                    n_true = SCHED_RULES.prefill_chunk_len(
                        self.cfg.prefill_chunk, q[R_REPLAY], q[R_DONE])
                    if self._ensure(st, k, rid, q[R_DONE] + n_true):
                        pre = (rid, n_true)
            if pre is not None:
                rid, n_true = pre
                q = st.reqs[rid]
                q[R_DONE] += n_true
                if q[R_DONE] >= q[R_REPLAY]:
                    q[R_STATE] = SCHED_DECODE
                    if q[R_GEN] == 0:
                        # a fresh prefill's sample IS the first token
                        self._token(st, rid)
            for rid in dec:
                if st.reqs[rid][R_STATE] != SCHED_DECODE:
                    continue             # evicted by the prefill claim
                self._token(st, rid)
        nxt = st.phase[1] + 1
        st.phase = (("engine", nxt) if nxt < len(st.reps)
                    else ("decode_drain",))

    def _admit(self, st: SchedState, k: int) -> None:
        rep = st.reps[k]
        while rep[P_WAIT]:
            live = self._on(st, k)
            if len(live) >= self.cfg.slots:
                break
            rid = rep[P_WAIT][0]
            q = st.reqs[rid]
            need = SCHED_RULES.admission_need(q[R_REPLAY])
            committed = SCHED_RULES.committed_outstanding(
                [(self._target(st.reqs[r]), st.reqs[r][R_HELD])
                 for r in live])
            if (self.mutate != "drop_watermark"
                    and not SCHED_RULES.admit_ok(rep[P_FREE], committed,
                                                 need)):
                break
            rep[P_WAIT].pop(0)
            q[R_STATE] = SCHED_PREFILL
            q[R_REP] = k
            st.seq += 1
            q[R_SEQ] = st.seq
            # the INDEPENDENT watermark-safety invariant, algebraically
            # equivalent to admit_ok on a non-over-committed pool (see
            # docs/MODELCHECK.md): checked at the admission event itself
            total = sum(self._target(st.reqs[r])
                        for r in self._on(st, k))
            if total > self.cfg.pages:
                raise ProtocolError(
                    "watermark",
                    f"admission over-commit on replica {k}: committed "
                    f"targets sum to {total} pages > pool "
                    f"{self.cfg.pages} after admitting request {rid} "
                    f"({self._ctx()})")

    def _ensure(self, st: SchedState, k: int, rid: int,
                n_positions: int) -> bool:
        """Grow rid's page set to n_positions, LIFO-evicting while the
        pool is dry.  False: no evictable victim (cannot proceed)."""
        q = st.reqs[rid]
        rep = st.reps[k]
        while q[R_HELD] < n_positions:
            if rep[P_FREE] > 0:
                rep[P_FREE] -= 1
                q[R_HELD] += 1
                continue
            if self.mutate == "no_evict":
                return False
            victims = [r for r in self._on(st, k)
                       if r != rid and st.reqs[r][R_HELD] > 0]
            pos = SCHED_RULES.pick_victim(
                [st.reqs[r][R_SEQ] for r in victims])
            if pos is None:
                return False
            self._evict(st, k, victims[pos])
        return True

    def _evict(self, st: SchedState, k: int, vid: int) -> None:
        v = st.reqs[vid]
        back = v[R_HELD] - (1 if self.mutate == "leak_evict" else 0)
        st.reps[k][P_FREE] += back
        v[R_HELD] = 0
        v[R_STATE] = SCHED_WAITING
        v[R_DONE] = 0
        v[R_REP] = -1
        v[R_REPLAY] = SCHED_RULES.replay_target(self._n_tokens(v))
        st.reps[k][P_WAIT].insert(0, vid)   # evicted work has priority

    def _token(self, st: SchedState, rid: int) -> None:
        q = st.reqs[rid]
        q[R_GEN] += 1
        if q[R_GEN] >= self.cfg.max_new:
            k = q[R_REP]
            st.reps[k][P_FREE] += q[R_HELD]
            q[R_HELD] = 0
            q[R_REP] = -1
            q[R_STATE] = SCHED_FINISHED

    def _decode_drain(self, st: SchedState) -> None:
        for k in self._alive_idx(st):
            if st.reps[k][P_ROLE] != "decode":
                continue
            while st.reps[k][P_WAIT]:
                self._replay_fallback(st, st.reps[k][P_WAIT].pop(0))
        st.phase = ("scaler",)

    def _signals(self, st: SchedState) -> Dict[str, Any]:
        alive = self._alive_idx(st)
        queue = (sum(len(st.reps[k][P_WAIT]) for k in alive)
                 + len(st.intake))
        pure_p = [k for k in alive if st.reps[k][P_ROLE] == "prefill"]
        pure_d = [k for k in alive if st.reps[k][P_ROLE] == "decode"]
        rb = SCHED_RULES.route_least_loaded(
            [(self._load(st, k), k) for k in pure_p])
        si = SCHED_RULES.route_least_loaded(
            [(self._load(st, k), k) for k in pure_d])
        free = sum(st.reps[k][P_FREE] for k in alive)
        return {
            "queue_depth": float(queue),
            "n_decode": len(self._alive_idx(st, "decode")),
            "n_prefill_pure": len(pure_p),
            "n_decode_pure": len(pure_d),
            "rebalance_idx": pure_p[rb] if rb is not None else -1,
            "scale_in_idx": pure_d[si] if si is not None else -1,
            "free_frac": free / (max(1, len(alive)) * self.cfg.pages),
        }

    def _flap_check(self, st: SchedState, direction: str) -> None:
        if (st.last_dir and direction != st.last_dir
                and st.tick - st.last_tick <= self.cfg.cooldown_ticks):
            raise ProtocolError(
                "flap",
                f"opposite-direction scale actions inside the cooldown "
                f"window: {st.last_dir}@tick{st.last_tick} then "
                f"{direction}@tick{st.tick} (cooldown "
                f"{self.cfg.cooldown_ticks}) ({self._ctx()})")
        st.last_dir = direction
        st.last_tick = st.tick

    def _scaler(self, st: SchedState) -> None:
        cfg = self.cfg
        sig = self._signals(st)
        resid = SCHED_RULES.load_residual(
            sig["queue_depth"], cfg.target_per_decode,
            max(1, sig["n_decode"]))
        # the hysteresis-regression mutant disables BOTH halves of the
        # detector's damping (the re-arm cooldown and the drift slack)
        hyst_off = self.mutate == "drop_cooldown"
        st.pos, st.neg, st.cooldown, trip = SCHED_RULES.cusum_step(
            st.pos, st.neg, st.cooldown, resid,
            0.0 if hyst_off else cfg.drift, cfg.threshold,
            0 if hyst_off else cfg.cooldown_ticks)
        if trip is not None and trip[0] == "slow":
            if st.spares > 0:
                st.spares -= 1
                st.reps.append([1, "decode", cfg.pages, []])
                self._flap_check(st, "out")
            elif SCHED_RULES.scale_up_fallback(
                    sig["n_prefill_pure"],
                    sig["rebalance_idx"]) == "rebalance":
                st.reps[sig["rebalance_idx"]][P_ROLE] = "both"
                self._flap_check(st, "out")
        elif trip is not None:
            if SCHED_RULES.scale_down_ok(
                    sig["n_decode_pure"], cfg.min_decode,
                    sig["queue_depth"], sig["scale_in_idx"]):
                self._flap_check(st, "in")
                self._kill(st, sig["scale_in_idx"])
        shed = SCHED_RULES.shed_action(st.hold, sig["free_frac"],
                                       cfg.shed_lo, cfg.shed_hi)
        if shed == "shed_on":
            st.hold = True
        elif shed == "shed_off":
            st.hold = False
        # liveness bookkeeping: the progress measure is total generated
        # tokens — it must grow within STALL_LIMIT ticks while any
        # request is unfinished (the evict/readmit livelock class)
        total = sum(q[R_GEN] for q in st.reqs)
        unfinished = any(q[R_STATE] != SCHED_FINISHED for q in st.reqs)
        if unfinished and total == st.last_tokens:
            st.stall += 1
            if st.stall >= STALL_LIMIT:
                raise ProtocolError(
                    "livelock",
                    f"no token progress for {STALL_LIMIT} consecutive "
                    "ticks with unfinished requests — evict/readmit "
                    f"livelock ({self._ctx()})")
        else:
            st.stall = 0
        st.last_tokens = total
        st.tick += 1
        st.tried = []
        st.phase = ("boundary",)

    # -- membership change ---------------------------------------------------

    def _chaos_victim(self, st: SchedState) -> int:
        cands = (self._alive_idx(st, "decode")
                 or self._alive_idx(st))
        pos = SCHED_RULES.pick_kill_victim(
            [(self._load(st, k), k) for k in cands])
        assert pos is not None
        return cands[pos]

    def _kill(self, st: SchedState, victim: int) -> None:
        """`ServeFleet.kill_replica`: dead first, promote a survivor if
        a role was lost, then per live request (admission order) the
        migrate/reroute/replay trichotomy; the waiting queue reroutes.
        Pages on the dead pool die with it (excluded from conservation
        the moment alive drops)."""
        st.reps[victim][P_ALIVE] = 0
        self._promote_if_role_lost(st)
        live = sorted((st.reqs[rid][R_SEQ], rid)
                      for rid in self._on(st, victim))
        for _, rid in live:
            q = st.reqs[rid]
            act = SCHED_RULES.migration_action(
                q[R_STATE], q[R_HELD] > 0, True)
            if act == "migrate":
                n = q[R_HELD]
                role = ("decode" if q[R_STATE] == SCHED_DECODE
                        else "prefill")
                dsts = [d for d in self._alive_idx(st, role)
                        if len(self._on(st, d)) < self.cfg.slots
                        and st.reps[d][P_FREE] >= n]
                pos = SCHED_RULES.route_least_loaded(
                    [(self._load(st, d), d) for d in dsts])
                if pos is None:
                    self._replay_fallback(st, rid)
                    continue
                # the kill-path handoff is atomic here: the fault
                # budget is spent on the kill itself, so no handoff
                # fault can race it (one injection per run, like the
                # chaos plans the benches drive)
                dst = dsts[pos]
                st.reps[dst][P_FREE] -= n
                q[R_REP] = dst
                st.seq += 1
                q[R_SEQ] = st.seq
            elif act == "reroute":
                # admitted but no KV written: zero work lost, NOT a
                # replay — but the requeue resets the replay target
                # exactly like the real enqueue does
                q[R_STATE] = SCHED_WAITING
                q[R_DONE] = 0
                q[R_REP] = -1
                q[R_REPLAY] = SCHED_RULES.replay_target(
                    self._n_tokens(q))
                self._route_to_prefill(st, rid, front=True)
            else:
                self._replay_fallback(st, rid)
        while st.reps[victim][P_WAIT]:
            self._route_to_prefill(
                st, st.reps[victim][P_WAIT].pop(0), front=False)

    def _promote_if_role_lost(self, st: SchedState) -> None:
        for role in ("prefill", "decode"):
            if not self._alive_idx(st, role):
                cands = self._alive_idx(st)
                pos = SCHED_RULES.route_least_loaded(
                    [(self._load(st, k), k) for k in cands])
                assert pos is not None
                st.reps[cands[pos]][P_ROLE] = "both"

    # -- invariants ----------------------------------------------------------

    def shape_violations(self) -> List[str]:
        """The static pre-pass (`validate_shape`'s model analogue): the
        worst-case single-request footprint must fit one pool, or the
        liveness claim is forfeit before any exploration."""
        worst = self.cfg.prompt_len + self.cfg.max_new
        if worst > self.cfg.pages:
            return [f"worst-case footprint {worst} pages > pool "
                    f"{self.cfg.pages} — a lone request cannot finish"]
        return []

    def _check_conservation(self, st: SchedState) -> None:
        for k, rep in enumerate(st.reps):
            if not rep[P_ALIVE]:
                continue
            resident = sum(q[R_HELD] for q in st.reqs
                           if q[R_REP] == k)
            reserve = (st.inflight[2]
                       if st.inflight is not None
                       and st.inflight[1] == k else 0)
            free = rep[P_FREE]
            if free < 0 or free + resident + reserve != self.cfg.pages:
                promised = SCHED_RULES.committed_outstanding(
                    [(self._target(st.reqs[r]), st.reqs[r][R_HELD])
                     for r in self._on(st, k)])
                raise ProtocolError(
                    "conservation",
                    f"page ledger broken on replica {k}: uncommitted "
                    f"{free - promised} + promised {promised} + "
                    f"resident {resident} + in-flight {reserve} != "
                    f"pool {self.cfg.pages} — a page leaked or was "
                    f"double-freed ({self._ctx()})")


# ---------------------------------------------------------------------------
# envelope
# ---------------------------------------------------------------------------

def build_sched(n_reqs: int, pages: int, n_replicas: int, fault: str,
                mutate: Optional[str] = None) -> SchedModel:
    cfg = SchedConfig(n_reqs, pages, n_replicas, fault)
    meta: Dict[str, Any] = {"route": "sched", "R": n_reqs, "P": pages,
                            "K": n_replicas, "fault": fault}
    if mutate is not None:
        meta["mutation"] = mutate
    return SchedModel(cfg, meta, mutate=mutate)


def sched_cells() -> List[Tuple[int, int, int, str]]:
    """The exhaustive control-plane envelope: requests <= 4, pages <= 6,
    replicas <= 3, one fault injection from {none, kill, handoff-fail}
    — 180 cells (>= 150, the acceptance floor)."""
    return [(r, p, k, fault)
            for r in (1, 2, 3, 4)
            for p in (2, 3, 4, 5, 6)
            for k in (1, 2, 3)
            for fault in SCHED_FAULTS]
