"""Elastic serving fleet — disaggregated prefill/decode replicas with live
KV migration; the port of the JAX package's ``serve/fleet.py``.

When a replica is preempted or drained, its in-flight requests' KV pages
migrate to survivors over the handoff (``serve.handoff``), so the fleet
loses no prefill work.  On the same machinery the fleet splits roles:

  prefill replicas  run only the chunked prefill step; a completed
                    prefill's KV pages hand off to a decode replica
                    (prefill -> KV handoff -> decode);
  decode replicas   run only the decode step; they receive work only
                    through ``ContinuousBatcher.adopt`` (pages already
                    resident: no replay).

Replicas are slots: ``devices`` lists one torch device a replica, and
entries may repeat, so several replicas share one card (the default: the
card once a replica, no spare).  Entries past ``n_replicas`` are spare
slots that ``add_replica`` (the autoscaler's scale-out) claims.  Replicas
on one device share one copy of the weights (``ServeEngine`` moves the
tree with ``.to``, which returns the tensor itself when it is already
there); each has its own pool.  The JAX package puts each replica on its
own device and builds every engine without a tp mesh, and so does this
fleet.

Scheduling is deterministic (least-loaded, stable ties), so a seeded fleet
run replays exactly; a replica-kill run's streams are byte-identical to
the fault-free run's, because each request's chunk schedule is
position-aligned and ``forward_paged`` does not depend on page
assignment.

Failure story (chaos sites, ``runtime.chaos``):

  fleet.membership  a preemption here is a replica kill.  The victim's
                    pool is still alive (the signal arrives at the tick
                    boundary, before any step), so every live request
                    migrates: decode requests to decode survivors,
                    mid-prefill requests (partial KV kept, prefill
                    resumes at ``prefill_done``) and waiting requests to
                    prefill survivors.  MTTR = detection -> fleet
                    serviceable.
  serve.handoff     a fault inside a migration degrades that one request
                    to the replay tier (generated tokens kept, re-prefill
                    on a survivor), counted in ``fleet_replays``, never
                    lost.

If a role loses its last replica, a survivor is promoted to
``role="both"``: the fleet degrades to the single-engine plane instead of
wedging.  The engines' own ticks run without chaos, as in the JAX package.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..device import DeviceLike, resolve_device
from ..models.llama import LlamaConfig, Params
from ..obs.metrics import RequestSpans
from ..obs.slo import SloAggregator
from ..runtime import chaos as chaos_lib
from ..runtime.requests import DECODE, FINISHED, Request
from ..utils.observability import Profiler
# one definition of every routing, kill and migration decision, held
# equal to the JAX package's SCHED_RULES
from .sched_rules import SCHED_RULES as _RULES
from . import handoff as handoff_lib
from .engine import ServeEngine
from .paged import ServeConfig

__all__ = ["FleetConfig", "ServeFleet", "Replica"]


@dataclass(frozen=True)
class FleetConfig:
    """Fleet topology: how many replicas hold which role.  Every replica
    shares one (LlamaConfig, ServeConfig) pair — the handoff plan's
    geometry precondition."""

    n_prefill: int = 1
    n_decode: int = 2

    def __post_init__(self) -> None:
        if self.n_prefill < 1 or self.n_decode < 1:
            raise ValueError("need >= 1 prefill and >= 1 decode replica")

    @property
    def n_replicas(self) -> int:
        return self.n_prefill + self.n_decode


@dataclass
class Replica:
    """One fleet member: an engine on its device slot."""

    idx: int
    engine: ServeEngine
    device: Any
    alive: bool = True

    @property
    def role(self) -> str:
        return self.engine.role

    def load(self) -> int:
        b = self.engine.batcher
        return len(b.live) + len(b.waiting)


class ServeFleet:
    """The fleet scheduler: routes requests prefill -> KV-handoff ->
    decode and rebalances on membership change.  Single-threaded drive
    loop (one tick drives every alive replica once); the thread-safe
    seams stay in `runtime.requests`."""

    def __init__(self, params: Params, cfg: LlamaConfig,
                 scfg: ServeConfig, fcfg: Optional[FleetConfig] = None, *,
                 profiler: Optional[Profiler] = None,
                 chaos: Optional[chaos_lib.FaultPlan] = None,
                 dtype: Optional[str] = None,
                 devices: Optional[Sequence[DeviceLike]] = None) -> None:
        self.cfg = cfg
        self.scfg = scfg
        self.fcfg = fcfg or FleetConfig()
        self.dtype = dtype
        self.profiler = profiler or Profiler()
        # fleet-level chaos only: engine ticks stay chaos-free here (the
        # single-engine serve.step battery covers that surface) so a
        # fleet fault plan's step counter tracks FLEET ticks
        self.chaos = chaos
        if chaos is not None and chaos.events is None:
            chaos.events = self.profiler.events
        # the FULL slot list is retained: slots beyond n_replicas are
        # spares the autoscaler's scale-out claims via `add_replica`
        # (default: the card once a replica, no spare)
        devices = [resolve_device(d) for d in (
            devices if devices is not None
            else ["cuda"] * self.fcfg.n_replicas)]
        if len(devices) < self.fcfg.n_replicas:
            raise ValueError(
                f"fleet needs {self.fcfg.n_replicas} devices, have "
                f"{len(devices)}")
        self._params = params
        self._spare_devices: List[Any] = devices[self.fcfg.n_replicas:]
        self.replicas: List[Replica] = []
        for i in range(self.fcfg.n_replicas):
            role = "prefill" if i < self.fcfg.n_prefill else "decode"
            eng = ServeEngine(params, cfg, scfg, profiler=self.profiler,
                              dtype=dtype, device=devices[i],
                              replica_id=i, role=role)
            self.replicas.append(Replica(idx=i, engine=eng,
                                         device=devices[i]))
        self.requests: List[Request] = []       # fleet submission order
        self._arrivals: List[Request] = []
        self._uid = 0
        self._t0 = time.perf_counter()
        self.ticks = 0
        self._wall_s = 0.0
        # live SLO observatory: windowed tick-domain latency series +
        # per-tick pressure gauges, mirrored onto the event stream
        self.slo = SloAggregator(events=self.profiler.events)
        # the autoscaler's admission valve: True defers arrival routing
        # (requests stay queued host-side — deferred, never dropped)
        self.hold_admissions = False
        self.grows = 0
        self.role_changes = 0
        self.handoffs = 0
        self.handoff_wire_bytes = 0
        self.handoff_host_bytes = 0
        self.fleet_replays = 0                   # replay-tier fallbacks
        self.kills = 0
        # exact-tier handoff verification (scfg.page_integrity): a
        # tripped landed-page checksum retries once before degrading to
        # replay — bounded-retry-then-replay, counted honestly
        self.handoff_retries = 1
        self.handoff_integrity_trips = 0

    # -- membership ----------------------------------------------------------

    def _alive(self, role: Optional[str] = None) -> List[Replica]:
        out = [r for r in self.replicas if r.alive]
        if role is not None:
            out = [r for r in out if r.role in (role, "both")]
        return out

    # -- intake --------------------------------------------------------------

    def submit(self, prompt: np.ndarray, max_new: int, *,
               eos_id: Optional[int] = None,
               not_before_s: float = 0.0,
               tenant: Optional[str] = None) -> Request:
        """Validate against the shared static budget, then queue for the
        fleet router (arrival shaping as in `runtime.requests`).  The
        submit is also tick-stamped: the SLO observatory's latency
        series live in the fleet-tick domain, where a seeded run is
        machine-independent."""
        p = np.asarray(prompt, np.int32).reshape(-1)
        self.replicas[0].engine.batcher.validate_shape(int(p.shape[0]),
                                                       int(max_new))
        self._uid += 1
        req = Request(uid=self._uid, prompt=p, max_new=int(max_new),
                      eos_id=eos_id, not_before_s=float(not_before_s),
                      t_submit=time.perf_counter(), tenant=tenant,
                      submit_tick=self.ticks)
        self._arrivals.append(req)
        self.requests.append(req)
        attrs: Dict[str, Any] = {"uid": req.uid,
                                 "prompt_len": req.prompt_len,
                                 "max_new": req.max_new}
        if tenant is not None:
            attrs["tenant"] = tenant
        self.profiler.events.instant("fleet.submit", **attrs)
        return req

    def _pop_arrived(self) -> List[Request]:
        now = time.perf_counter() - self._t0
        out = [r for r in self._arrivals if r.not_before_s <= now]
        self._arrivals = [r for r in self._arrivals
                          if r.not_before_s > now]
        return out

    def _route_to_prefill(self, req: Request, *, front: bool = False
                          ) -> None:
        """Deterministic least-loaded routing with stable ties (list
        order) — what makes a seeded fleet run replay exactly."""
        cands = self._alive("prefill")
        pos = _RULES.route_least_loaded([(r.load(), r.idx)
                                         for r in cands])
        assert pos is not None, "no prefill-capable replica alive"
        cands[pos].engine.batcher.enqueue(req, front=front)

    # -- KV handoff ----------------------------------------------------------

    def _pick_decode_target(self, n_pages: int) -> Optional[Replica]:
        cands = [r for r in self._alive("decode")
                 if r.engine.batcher.free_slots > 0
                 and r.engine.alloc.free >= n_pages]
        pos = _RULES.route_least_loaded([(r.load(), r.idx)
                                         for r in cands])
        return None if pos is None else cands[pos]

    def _handoff(self, src: Replica, dst: Replica, req: Request, *,
                 state: str) -> None:
        """Migrate one request's KV pages src -> dst (``apply_handoff``); on
        success the request continues on dst with ZERO replay.  Raises on
        an injected handoff fault BEFORE any state moved (the caller
        degrades that request to replay).

        With ``scfg.page_integrity`` the landed page blocks are
        re-checksummed bit-exactly against the source ledger's write-time
        entries, so migrated KV has write-time -> land-time coverage.
        A tripped verdict gets ONE bounded retry (a transient wire fault
        must not cost replay); a second trip raises
        ``WireIntegrityError`` and the caller degrades the request to
        the replay tier — degraded, never lost, never silently wrong."""
        if self.chaos is not None:
            self.chaos.fire("serve.handoff")     # may sleep or raise
        src_eng, dst_eng = src.engine, dst.engine
        src_pages = src_eng.batcher.pages_of(req)
        n = len(src_pages)
        assert n >= 1, "handoff of a pageless request"
        dst_pages = dst_eng.alloc.alloc(n)
        assert dst_pages is not None, "target picked without capacity"
        plan = handoff_lib.plan_for(self.cfg, self.scfg, n,
                                    dtype=self.dtype)
        integrity = bool(self.scfg.page_integrity)
        expect = src_eng.ledger_entries(src_pages) if integrity else None
        with self.profiler.events.span(
                "fleet.handoff", lane="serve", uid=req.uid, src=src.idx,
                dst=dst.idx, pages=n, wire_bytes=plan.wire_bytes(),
                integrity=integrity):
            ok = True
            for attempt in range(self.handoff_retries + 1):
                res = handoff_lib.apply_handoff(
                    plan, src_eng.pool, dst_eng.pool, src_pages,
                    dst_pages, expect=expect)
                if integrity:
                    new_src, new_dst, ok, landed = res
                    # ALWAYS record what actually landed — a rejected
                    # page stays free-and-dirty and dirty pages must be
                    # ledger-consistent (engine.record_landed_pages)
                    src_eng.pool, dst_eng.pool = new_src, new_dst
                    dst_eng.record_landed_pages(dst_pages, landed)
                    if ok:
                        break
                    self.handoff_integrity_trips += 1
                    self.profiler.events.instant(
                        "fleet.handoff_trip", uid=req.uid, src=src.idx,
                        dst=dst.idx, attempt=attempt)
                else:
                    new_src, new_dst = res
                    src_eng.pool, dst_eng.pool = new_src, new_dst
                    break
        if not ok:
            dst_eng.alloc.free_pages(dst_pages)
            raise chaos_lib.WireIntegrityError(
                f"KV handoff {src.idx}->{dst.idx} for request {req.uid} "
                f"failed its landed-page checksums "
                f"{self.handoff_retries + 1}x — degrading this request "
                "to the replay tier (KV discarded, tokens kept)")
        src_eng.batcher.release(req)
        slot = dst_eng.batcher.adopt(req, dst_pages, state=state)
        assert slot is not None, "target lost its free slot mid-handoff"
        src_eng.stats.record_handoff_out()
        dst_eng.stats.record_handoff_in()
        self.handoffs += 1
        self.handoff_wire_bytes += plan.wire_bytes()
        self.handoff_host_bytes += plan.host_bytes(
            req.prompt_len + len(req.generated))

    def _replay_fallback(self, src: Replica, req: Request) -> None:
        """The degraded tier: release the request's pages (KV lost) and
        requeue it front-of-line on a prefill survivor with its
        generated tokens kept — replay-from-prompt for THIS request
        only, counted honestly."""
        if req.slot >= 0:
            src.engine.batcher.release(req)
        self.fleet_replays += 1
        self.profiler.events.instant("fleet.replay", uid=req.uid,
                                     src=src.idx)
        self._route_to_prefill(req, front=True)

    def _migrate_or_replay(self, src: Replica, req: Request, *,
                           state: str, park_ok: bool = False) -> None:
        """``park_ok`` distinguishes the two callers: the per-tick
        prefill->decode drain may PARK a request on its (healthy)
        prefill worker when the decode fleet is transiently full — the
        handoff simply retries next tick, no prefill work is thrown
        away (backpressure, not replay).  The kill path cannot park
        (the source replica is dying) and degrades to replay instead."""
        role = "decode" if state == DECODE else "prefill"
        n = len(src.engine.batcher.pages_of(req))
        if role == "decode":
            dst = self._pick_decode_target(n)
        else:
            cands = [r for r in self._alive("prefill") if r is not src
                     and r.engine.batcher.free_slots > 0
                     and r.engine.alloc.free >= n]
            pos = _RULES.route_least_loaded([(r.load(), r.idx)
                                             for r in cands])
            dst = None if pos is None else cands[pos]
        if dst is None and park_ok:
            return                       # retry next tick; pages stay
        if dst is None or n == 0:
            self._replay_fallback(src, req)
            return
        try:
            self._handoff(src, dst, req, state=state)
        except (chaos_lib.InjectedFault,
                chaos_lib.WireIntegrityError) as err:
            kind = ("wire-corruption"
                    if isinstance(err, chaos_lib.WireIntegrityError)
                    else err.kind)
            ev = self.profiler.recovery.record_fault(
                kind, step=self.ticks, site="serve.handoff",
                error=repr(err))
            t0 = time.perf_counter()
            self._replay_fallback(src, req)
            self.profiler.recovery.record_recovery(
                time.perf_counter() - t0, event=ev)

    # -- membership change (the replica-kill tier) ---------------------------

    def _pick_victim(self) -> Optional[Replica]:
        """Deterministic kill target: the loaded-most decode replica
        (maximum blast radius — 'kill a replica mid-decode'), stable
        ties by index; any alive replica when no decode is left."""
        if len(self._alive()) <= 1:
            return None
        cands = self._alive("decode") or self._alive()
        pos = _RULES.pick_kill_victim([(r.load(), r.idx)
                                       for r in cands])
        return None if pos is None else cands[pos]

    def kill_replica(self, idx: int) -> None:
        """Planned scale-down / drain of one replica: migrate everything
        it holds to survivors, then remove it from membership.  The
        chaos preemption at ``fleet.membership`` routes here."""
        victim = self.replicas[idx]
        assert victim.alive, f"replica {idx} already dead"
        assert len(self._alive()) > 1, "cannot kill the last replica"
        ev = self.profiler.recovery.record_fault(
            "replica_kill", step=self.ticks, site="fleet.membership",
            error=f"replica {idx} preempted")
        t0 = time.perf_counter()
        victim.alive = False            # no further routing to it
        self.kills += 1
        self._promote_if_role_lost()
        eng = victim.engine
        migratable = chaos_lib.state_buffers_alive(eng.pool)
        live = sorted(eng.batcher.live, key=lambda r: r.admit_seq)
        for req in live:
            act = _RULES.migration_action(
                req.state, bool(eng.batcher.pages_of(req)), migratable)
            if act == "migrate":
                self._migrate_or_replay(victim, req, state=req.state)
            elif act == "reroute":
                # admitted but no KV written yet: re-routing loses zero
                # work — NOT a replay
                eng.batcher.release(req)
                self._route_to_prefill(req, front=True)
            else:
                self._replay_fallback(victim, req)
        while eng.batcher.waiting:
            self._route_to_prefill(eng.batcher.waiting.pop(0))
        self.profiler.recovery.record_recovery(
            time.perf_counter() - t0, event=ev)
        self.profiler.events.instant(
            "fleet.membership", tick=self.ticks, victim=idx,
            survivors=[r.idx for r in self._alive()],
            migrated=sum(1 for _ in live))

    def _promote_if_role_lost(self) -> None:
        """A role with zero survivors promotes the least-loaded survivor
        to role='both' — the fleet degrades to the single-engine plane
        instead of wedging."""
        for role in ("prefill", "decode"):
            if not self._alive(role):
                cands = self._alive()
                pos = _RULES.route_least_loaded([(r.load(), r.idx)
                                                 for r in cands])
                assert pos is not None, "no survivor to promote"
                survivor = cands[pos]
                survivor.engine.role = "both"
                self.profiler.events.instant(
                    "fleet.promote", replica=survivor.idx,
                    lost_role=role)

    # -- membership growth + role rebalance (the autoscaler's levers) --------

    @property
    def spare_devices(self) -> int:
        return len(self._spare_devices)

    def add_replica(self, role: str = "decode") -> Optional[Replica]:
        """Scale-out: a spare slot joins the fleet as a fresh replica (its
        own pool; the weights shared with replicas on the same device).
        Returns None when no spare is left (the caller falls back to
        rebalance)."""
        if not self._spare_devices:
            return None
        device = self._spare_devices.pop(0)
        idx = len(self.replicas)
        eng = ServeEngine(self._params, self.cfg, self.scfg,
                          profiler=self.profiler, dtype=self.dtype,
                          device=device, replica_id=idx, role=role)
        rep = Replica(idx=idx, engine=eng, device=device)
        self.replicas.append(rep)
        self.grows += 1
        self.profiler.events.instant(
            "fleet.membership", tick=self.ticks, joined=idx, role=role,
            survivors=[r.idx for r in self._alive()])
        return rep

    def set_role(self, idx: int, role: str) -> None:
        """Role rebalance (e.g. a surplus prefill worker promoted to
        role='both' when the decode pool is the bottleneck and no spare
        slot remains)."""
        rep = self.replicas[idx]
        assert rep.alive, f"replica {idx} is dead"
        if rep.engine.role == role:
            return
        old = rep.engine.role
        rep.engine.role = role
        self.role_changes += 1
        self.profiler.events.instant("fleet.rebalance", tick=self.ticks,
                                     replica=idx, from_role=old,
                                     to_role=role)

    def load_signals(self) -> Dict[str, float]:
        """The autoscaler's per-tick signal read — every value is a
        deterministic function of the tick-domain schedule (no wall
        clocks), so a seeded run produces the same signal sequence, and
        the same decision sequence, on any machine."""
        alive = self._alive()
        waiting = sum(len(r.engine.batcher.waiting) for r in alive)
        queue_depth = waiting + len(self._arrivals)
        usable = max(1, len(alive)) * self.scfg.usable_pages
        free = sum(r.engine.alloc.free for r in alive)
        in_use = sum(r.engine.alloc.in_use for r in alive)
        live = sum(len(r.engine.batcher.live) for r in alive)
        pure_prefill = [r for r in alive if r.role == "prefill"]
        pure_decode = [r for r in alive if r.role == "decode"]
        rb = _RULES.route_least_loaded([(r.load(), r.idx)
                                        for r in pure_prefill])
        si = _RULES.route_least_loaded([(r.load(), r.idx)
                                        for r in pure_decode])
        rebalance = None if rb is None else pure_prefill[rb]
        scale_in = None if si is None else pure_decode[si]
        return {
            "queue_depth": float(queue_depth),
            "live": float(live),
            "n_alive": float(len(alive)),
            "n_prefill": float(len(self._alive("prefill"))),
            "n_decode": float(len(self._alive("decode"))),
            "n_prefill_pure": float(len(pure_prefill)),
            "n_decode_pure": float(len(pure_decode)),
            "rebalance_idx": float(rebalance.idx
                                   if rebalance is not None else -1),
            "scale_in_idx": float(scale_in.idx
                                  if scale_in is not None else -1),
            "pages_in_use": float(in_use),
            "free_pages": float(free),
            "free_frac": float(free) / usable,
            "spare_devices": float(self.spare_devices),
        }

    # -- the drive loop ------------------------------------------------------

    def _observe_slo(self) -> None:
        """End-of-tick observatory feed: stamp tick-domain request
        milestones (admit / first token / done are detected by state,
        so the stamp lands on the tick the transition happened) and push
        the windows + pressure gauges.  O(n_requests) per tick — the
        fleet drive loop is host-side and n is bench-scale."""
        for r in self.requests:
            if r.admit_tick < 0 and not math.isnan(r.t_admit):
                r.admit_tick = self.ticks
                self.slo.observe("queue_wait",
                                 float(r.admit_tick - r.submit_tick))
            if r.first_tick < 0 and r.generated:
                r.first_tick = self.ticks
                self.slo.observe("ttft",
                                 float(r.first_tick - r.submit_tick))
            if r.done_tick < 0 and r.state == FINISHED:
                r.done_tick = self.ticks
                n = len(r.generated)
                self.slo.observe("tpot",
                                 (r.done_tick - r.first_tick) / (n - 1)
                                 if n > 1 else 0.0)
        sig = self.load_signals()
        self.slo.gauge("queue_depth", sig["queue_depth"])
        self.slo.gauge("pages_in_use", sig["pages_in_use"])
        self.slo.gauge("free_pages", sig["free_pages"])
        for rep in self._alive():
            self.slo.gauge("batch_occupancy",
                           len(rep.engine.batcher.live)
                           / self.scfg.max_reqs, replica=rep.idx)

    def tick(self) -> bool:
        """One fleet tick: membership chaos, routing, prefill->decode
        handoffs, one engine tick per alive replica, decode-side replay
        drain.  Returns False when nothing progressed (idle)."""
        if self.chaos is not None:
            self.chaos.begin_step(self.ticks)
            try:
                self.chaos.fire("fleet.membership")
            except chaos_lib.InjectedPreemption:
                victim = self._pick_victim()
                if victim is not None:
                    self.kill_replica(victim.idx)
            except chaos_lib.InjectedFault as err:
                # a transient membership-plane error: note and continue
                self.profiler.events.instant(
                    "fleet.membership_error", tick=self.ticks,
                    error=repr(err)[:120])
        if not self.hold_admissions:
            # the autoscaler's shed valve: while held, arrivals stay in
            # the host-side queue (deferred, never dropped) and the pool
            # drains toward the resume watermark
            for req in self._pop_arrived():
                self._route_to_prefill(req)
        # completed prefills hand off BEFORE the next engine tick, so a
        # prefill-role replica never decodes
        for rep in list(self._alive("prefill")):
            if rep.role == "both":
                continue                 # degraded mode decodes locally
            for req in [r for r in rep.engine.batcher.live
                        if r.state == DECODE]:
                self._migrate_or_replay(rep, req, state=DECODE,
                                        park_ok=True)
        progressed = False
        for rep in self._alive():
            progressed = rep.engine.tick() or progressed
        # an eviction on a decode replica lands in ITS waiting list but
        # must replay through a prefill worker
        for rep in self._alive():
            if rep.role != "decode":
                continue
            while rep.engine.batcher.waiting:
                req = rep.engine.batcher.waiting.pop(0)
                self._replay_fallback(rep, req)
        self._observe_slo()
        self.ticks += 1
        return progressed

    def run(self, *, max_ticks: int = 1_000_000) -> Dict[str, Any]:
        """Serve until every submitted request finishes; returns
        `summary()`."""
        t0 = time.perf_counter()
        while (self._arrivals
               or any(r.state != FINISHED for r in self.requests)):
            if self.ticks >= max_ticks:
                raise RuntimeError(
                    f"fleet loop exceeded max_ticks={max_ticks} with "
                    f"{sum(1 for r in self.requests if r.state != FINISHED)}"
                    " unfinished requests")
            if not self.tick():
                time.sleep(0.001)
        self._wall_s += time.perf_counter() - t0
        return self.summary()

    # -- introspection -------------------------------------------------------

    def request_summary(self) -> Dict[str, Any]:
        """Fleet-level latency percentiles computed from the request
        timestamps themselves (TTFT spans replica boundaries and the
        kill event — a migrated request's clock never resets)."""
        spans = RequestSpans()
        for r in self.requests:
            if r.state == FINISHED and not math.isnan(r.t_done):
                spans.record(r.uid, t_submit=r.t_submit,
                             t_admit=r.t_admit, t_first=r.t_first,
                             t_done=r.t_done, n_tokens=len(r.generated))
        return spans.summary()

    def obs_static_metrics(self) -> Dict[str, Any]:
        return {"fleet": {
            "n_prefill": self.fcfg.n_prefill,
            "n_decode": self.fcfg.n_decode,
            "n_replicas": self.fcfg.n_replicas,
        }}

    def summary(self) -> Dict[str, Any]:
        per_replica = []
        agg: Dict[str, int] = {}
        recompiles = 0
        for rep in self.replicas:
            s = rep.engine.stats.as_dict()
            for k, v in s.items():
                agg[k] = agg.get(k, 0) + v
            recompiles += rep.engine.recompiles_steady()
            per_replica.append({
                "replica": rep.idx, "role": rep.role,
                "alive": rep.alive, "ticks": rep.engine.ticks,
                "evictions": rep.engine.batcher.evictions,
                "pages_in_use_peak": rep.engine.alloc.peak_in_use,
                "prefill_calls": rep.engine.prefill_calls,
                "decode_calls": rep.engine.decode_calls,
                "trace_counts": rep.engine.trace_counts(), **s})
        rec = self.profiler.recovery.as_dict()
        wall = self._wall_s
        return {
            "ticks": self.ticks,
            "wall_s": round(wall, 4),
            "n_requests": len(self.requests),
            "completed": agg.get("completed", 0),
            "tokens_out": agg.get("tokens_out", 0),
            "throughput_tok_s": (round(agg.get("tokens_out", 0) / wall, 2)
                                 if wall > 0 else None),
            "handoffs": self.handoffs,
            "handoff_wire_bytes": self.handoff_wire_bytes,
            "handoff_host_bytes": self.handoff_host_bytes,
            "handoff_integrity_trips": self.handoff_integrity_trips,
            "page_trips": sum(r.engine.page_trips for r in self.replicas),
            "logit_trips": sum(r.engine.logit_trips
                               for r in self.replicas),
            "fleet_replays": self.fleet_replays,
            "kills": self.kills,
            "grows": self.grows,
            "role_changes": self.role_changes,
            "spare_devices": self.spare_devices,
            "serve_recoveries": agg.get("serve_recoveries", 0),
            "evictions": sum(r.engine.batcher.evictions
                             for r in self.replicas),
            "recompiles_steady": recompiles,
            "replicas": per_replica,
            "requests": self.request_summary(),
            "slo": self.slo.snapshot(),
            "recovery": {"faults": rec["faults"],
                         "recoveries": rec["recoveries"],
                         "mttr_mean_s": rec["mttr_mean_s"]},
            **self.obs_static_metrics(),
        }
