"""Closed-loop fleet autoscaler: windowed SLO metrics -> fleet actions; the
port of the JAX package's ``serve/autoscale.py`` (host Python).

The first real CONSUMER of the serving observatory (`obs.slo`): every
fleet tick the controller reads the live signals (queue depth, pool
pressure, windowed TTFT percentiles) and decides — with a detector,
not a bare threshold — whether the fleet should change shape.  Detection is the same two-sided CUSUM `tune.adapt.DriftDetector`
the drift observatory uses (sustained shifts accumulate, one-tick spikes
drain; hysteresis cooldown after every trip prevents flapping), applied
to LOAD instead of plan drift:

    residual = queue_depth / (target_queue_per_decode * n_decode) - 1

  "slow" trip (sustained overload)   scale OUT: a spare slot joins as
                                     a decode replica; with no spare
                                     left, REBALANCE: a surplus prefill
                                     replica is promoted to role="both"
                                     so it decodes too.
  "fast" trip (sustained idle)       scale IN: the least-loaded pure
                                     decode replica drains via
                                     ``kill_replica`` (live work
                                     migrates over the KV handoff —
                                     zero token loss by construction).

Admission shedding is a separate hysteresis band on the free-page
fraction (the pool watermark): below ``shed_free_frac_lo`` the fleet
HOLDS new admissions (arrivals queue host-side — deferred, never
dropped, zero token loss); above ``shed_free_frac_hi`` intake resumes.
The lo < hi gap is what keeps the valve from chattering at the
boundary.

Every gated-through action lands as a ``scale.decision`` instant on the
event stream carrying its full evidence window (tick, CUSUM statistic,
residual, queue depth, free-page fraction, windowed p99 TTFT), so the
Perfetto timeline shows WHY the fleet scaled — the `adapt.switch`
contract applied to serving.  Trips that gate NO action (no spare
device, at min_decode) emit ``scale.suppressed`` and are NOT counted as
decisions: the banked per-seed decision counts stay exact.

Everything here is tick-deterministic host Python: a seeded scenario
replays the same decision sequence on any machine, the JAX package's
included.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Protocol

from ..obs.slo import SloAggregator
# a module reference, not its name: tune.adapt imports serve.sched_rules,
# so whichever package is imported first finds the other mid-import
from ..tune import adapt as _adapt
# one definition of the residual, gate and valve rules, held equal to the
# JAX package's SCHED_RULES
from .sched_rules import SCHED_RULES as _RULES

__all__ = ["AutoscaleConfig", "ScaleDecision", "Autoscaler",
           "FleetActions"]


class FleetActions(Protocol):
    """The fleet surface the controller drives — `serve.fleet.ServeFleet`
    implements it; tests substitute a recording fake (the controller
    logic is pure host Python and must be testable without compiling a
    single engine)."""

    hold_admissions: bool

    def load_signals(self) -> Dict[str, float]: ...

    def add_replica(self, role: str = "decode") -> Optional[Any]: ...

    def kill_replica(self, idx: int) -> None: ...

    def set_role(self, idx: int, role: str) -> None: ...


@dataclasses.dataclass(frozen=True)
class AutoscaleConfig:
    """Controller knobs.  CUSUM defaults mirror `tune.adapt` (drift
    slack 0.75, threshold 3.0) with the cooldown in fleet ticks."""

    target_queue_per_decode: float = 2.0   # queued reqs a decode absorbs
    drift_rel: float = 0.75
    threshold: float = 3.0
    cooldown_ticks: int = 8
    min_decode: int = 1
    shed_free_frac_lo: float = 0.10        # hold admissions below
    shed_free_frac_hi: float = 0.30        # resume above (hysteresis)

    def __post_init__(self) -> None:
        if not 0.0 <= self.shed_free_frac_lo < self.shed_free_frac_hi:
            raise ValueError(
                "need 0 <= shed_free_frac_lo < shed_free_frac_hi "
                f"(got {self.shed_free_frac_lo}, {self.shed_free_frac_hi})")
        if self.min_decode < 1:
            raise ValueError("min_decode must be >= 1")


@dataclasses.dataclass(frozen=True)
class ScaleDecision:
    """One gated-through fleet action plus its evidence window — exactly
    what the ``scale.decision`` event (and the bench's ``slo`` row)
    records.  The `tune.adapt.SwitchDecision` pattern applied to
    serving."""

    action: str                 # scale_out | scale_in | rebalance |
    #                             shed_on | shed_off
    tick: int
    evidence: Dict[str, Any]


class Autoscaler:
    """The per-fleet controller: call ``observe_tick()`` once per fleet
    tick AFTER ``fleet.tick()`` (signals then reflect the tick's
    routing/admissions).  Single-threaded by contract, like the fleet
    drive loop itself."""

    def __init__(self, fleet: FleetActions, slo: SloAggregator, *,
                 cfg: Optional[AutoscaleConfig] = None,
                 events: Optional[Any] = None) -> None:
        self.fleet = fleet
        self.slo = slo
        self.cfg = cfg or AutoscaleConfig()
        self.events = events
        self.detector = _adapt.DriftDetector(
            drift_rel=self.cfg.drift_rel, threshold=self.cfg.threshold,
            cooldown_steps=self.cfg.cooldown_ticks)
        self.ticks = 0
        self.decisions: List[ScaleDecision] = []
        self.scale_outs = 0
        self.scale_ins = 0
        self.rebalances = 0
        self.sheds = 0              # shed_on events (holds opened)
        self.suppressed = 0         # trips that gated no action

    # -- decision plumbing --------------------------------------------------

    def _decide(self, action: str, evidence: Dict[str, Any]
                ) -> ScaleDecision:
        dec = ScaleDecision(action=action, tick=self.ticks,
                            evidence=dict(evidence))
        self.decisions.append(dec)
        if self.events is not None:
            self.events.instant("scale.decision", action=action,
                                tick=self.ticks, **dec.evidence)
        return dec

    def _suppress(self, evidence: Dict[str, Any]) -> None:
        # evidence already carries the trip direction (merged at trip
        # time), so the instant spreads it without duplication
        self.suppressed += 1
        if self.events is not None:
            self.events.instant("scale.suppressed", tick=self.ticks,
                                **evidence)

    # -- the per-tick loop closure ------------------------------------------

    def observe_tick(self) -> List[ScaleDecision]:
        """Read signals, update the detector, gate actions.  Returns the
        decisions taken THIS tick (usually none)."""
        cfg = self.cfg
        sig = self.fleet.load_signals()
        n_decode = max(1, int(sig["n_decode"]))
        queue_depth = float(sig["queue_depth"])
        residual = _RULES.load_residual(
            queue_depth, cfg.target_queue_per_decode, n_decode)
        p99 = self.slo.window_stat("ttft", "p99")
        evidence: Dict[str, Any] = {
            "residual": round(residual, 4),
            "queue_depth": queue_depth,
            "n_decode": n_decode,
            "free_frac": round(float(sig["free_frac"]), 4),
            "ttft_p99_window": p99,
            "window": self.slo.window,
        }
        out: List[ScaleDecision] = []
        trip = self.detector.update(residual)
        if trip is not None:
            direction, stat = trip
            evidence = {**evidence, "cusum_stat": round(stat, 4),
                        "direction": direction}
            if direction == "slow":
                out.extend(self._scale_up(evidence, sig))
            else:
                out.extend(self._scale_down(evidence, sig))
        out.extend(self._shed_valve(evidence, sig))
        self.ticks += 1
        return out

    def _scale_up(self, evidence: Dict[str, Any],
                  sig: Dict[str, float]) -> List[ScaleDecision]:
        if self.fleet.add_replica("decode") is not None:
            self.scale_outs += 1
            return [self._decide("scale_out", evidence)]
        # no spare device: rebalance a surplus prefill worker into the
        # decode pool instead (role="both" — it keeps prefilling)
        if _RULES.scale_up_fallback(
                int(sig["n_prefill_pure"]),
                int(sig["rebalance_idx"])) == "rebalance":
            self.fleet.set_role(int(sig["rebalance_idx"]), "both")
            self.rebalances += 1
            return [self._decide("rebalance", evidence)]
        self._suppress(evidence)
        return []

    def _scale_down(self, evidence: Dict[str, Any],
                    sig: Dict[str, float]) -> List[ScaleDecision]:
        idx = int(sig["scale_in_idx"])
        if _RULES.scale_down_ok(int(sig["n_decode_pure"]),
                                self.cfg.min_decode,
                                float(sig["queue_depth"]), idx):
            self.fleet.kill_replica(idx)
            self.scale_ins += 1
            return [self._decide("scale_in", evidence)]
        self._suppress(evidence)
        return []

    def _shed_valve(self, evidence: Dict[str, Any],
                    sig: Dict[str, float]) -> List[ScaleDecision]:
        free_frac = float(sig["free_frac"])
        shed = _RULES.shed_action(self.fleet.hold_admissions, free_frac,
                                  self.cfg.shed_free_frac_lo,
                                  self.cfg.shed_free_frac_hi)
        if shed == "shed_on":
            self.fleet.hold_admissions = True
            self.sheds += 1
            return [self._decide("shed_on", evidence)]
        if shed == "shed_off":
            self.fleet.hold_admissions = False
            return [self._decide("shed_off", evidence)]
        return []

    # -- introspection ------------------------------------------------------

    def summary(self) -> Dict[str, Any]:
        """Exact per-seed decision accounting — the bench's ``slo`` row
        feedstock (every value deterministic in the tick domain)."""
        return {
            "decisions": len(self.decisions),
            "scale_outs": self.scale_outs,
            "scale_ins": self.scale_ins,
            "rebalances": self.rebalances,
            "sheds": self.sheds,
            "suppressed": self.suppressed,
            "detector_trips": self.detector.trips,
            "first_scale_out_tick": next(
                (d.tick for d in self.decisions
                 if d.action == "scale_out"), -1),
        }
