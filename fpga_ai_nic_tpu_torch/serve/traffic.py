"""Deterministic, replayable serving workload generator — the port's copy
of the JAX package's ``serve/traffic.py`` (numpy only): the same seed
gives the same trace, bytes and ``fingerprint()``.

"Millions of users" is a traffic SHAPE — diurnal load cycles, bursts,
heavy-tailed prompt/output lengths, tenant mixes — not a bigger fixed
list.  This module generates that shape reproducibly: every draw comes
from a counter-based PRNG (a splitmix64-style hash of ``(seed, stream,
counter)``), so request i's attributes are a pure function of the seed
and i — no sequential RNG state, no numpy Generator whose draw ORDER
becomes part of the contract.  Same seed => byte-identical trace (the
determinism test pins the fingerprint); different seed => different
trace.  Replays are exact by construction, so a fleet run's tick-domain
SLO metrics are exact per scenario.

Arrivals are in the FLEET-TICK domain, not wall seconds: a drive loop
(``serve_fleet``) submits a request when ``fleet.ticks`` reaches its
``arrival_tick``, so queue depth, pool pressure and the autoscaler's
decision sequence are machine-independent (CPU and card runs see the
SAME offered load per tick; only wall-clock latencies differ).

Distributions (all inverse-CDF on counter-PRNG uniforms):

  inter-arrival   exponential with tick-varying rate: base rate shaped
                  by a diurnal cosine cycle and additive burst windows
                  (spike / thundering-herd scenarios compose from the
                  same two knobs).
  prompt/output   bounded Pareto (heavy tail, hard clamp) — most
                  requests short, a fat tail of long ones, never past
                  the engine's static budget.
  tenant          weighted categorical over the configured mix.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
from typing import Any, Dict, List, Tuple

import numpy as np

__all__ = ["TrafficConfig", "TrafficRequest", "Workload", "Burst",
           "generate", "steady_config", "spike_config", "diurnal_config",
           "thundering_herd_config"]

_MASK64 = (1 << 64) - 1

# stream ids: every attribute of request i draws from its own stream so
# adding a field can never shift another field's value (replayability
# survives schema growth)
_S_ARRIVAL, _S_PROMPT, _S_OUTPUT, _S_TENANT, _S_TOKEN = range(5)


def _mix64(x: int) -> int:
    """splitmix64 finalizer — the counter-PRNG core."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def _u64(seed: int, stream: int, *counters: int) -> int:
    x = _mix64(seed & _MASK64) ^ _mix64((stream + 1) * 0x9E3779B97F4A7C15)
    for c in counters:
        x = _mix64((x ^ (c & _MASK64)))
    return x


def _uniform(seed: int, stream: int, *counters: int) -> float:
    """[0, 1) with 53 random bits — enough for every inverse CDF here."""
    return (_u64(seed, stream, *counters) >> 11) * (1.0 / (1 << 53))


def _bounded_pareto(u: float, lo: int, hi: int, alpha: float) -> int:
    """Inverse CDF of a Pareto truncated to [lo, hi], floored to int —
    the heavy-tailed length draw."""
    assert 0 < lo <= hi and alpha > 0
    if lo == hi:
        return lo
    la, ha = float(lo) ** -alpha, float(hi + 1) ** -alpha
    x = (la - u * (la - ha)) ** (-1.0 / alpha)
    return max(lo, min(hi, int(x)))


@dataclasses.dataclass(frozen=True)
class Burst:
    """An additive arrival burst: ``factor``x the base rate over
    ``[start_tick, start_tick + width_ticks)`` — the spike primitive
    (thundering herd = one huge narrow burst at t0)."""

    start_tick: int
    width_ticks: int
    factor: float

    def rate_mult(self, tick: float) -> float:
        if self.start_tick <= tick < self.start_tick + self.width_ticks:
            return self.factor
        return 1.0


@dataclasses.dataclass(frozen=True)
class TrafficConfig:
    """One scenario's traffic shape.  Everything is in ticks; lengths
    must respect the serving budget (prompt_hi + output_hi <= the
    engine's max_seq) — `generate` asserts nothing here, the engine's
    ``validate_shape`` is the real gate."""

    n_requests: int
    seed: int
    base_interval_ticks: float = 4.0     # mean inter-arrival at rate 1x
    prompt_lo: int = 4
    prompt_hi: int = 16
    prompt_alpha: float = 1.2            # heavy tail exponent
    output_lo: int = 2
    output_hi: int = 8
    output_alpha: float = 1.5
    diurnal_period_ticks: int = 0        # 0 = no diurnal cycle
    diurnal_amplitude: float = 0.0       # in [0, 1): rate swings 1 +/- a
    bursts: Tuple[Burst, ...] = ()
    tenants: Tuple[Tuple[str, float], ...] = (("default", 1.0),)

    def rate_mult(self, tick: float) -> float:
        m = 1.0
        if self.diurnal_period_ticks > 0 and self.diurnal_amplitude > 0:
            phase = 2.0 * math.pi * tick / self.diurnal_period_ticks
            m *= 1.0 + self.diurnal_amplitude * math.sin(phase)
        for b in self.bursts:
            m *= b.rate_mult(tick)
        return max(m, 1e-6)


@dataclasses.dataclass(frozen=True)
class TrafficRequest:
    """One generated request — the replayable trace row."""

    uid: int
    arrival_tick: int
    prompt_len: int
    max_new: int
    tenant: str

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


class Workload:
    """A generated trace plus its provenance: the config, the canonical
    JSON trace, a content fingerprint (what the determinism test pins
    byte-for-byte), and on-demand prompt-token materialization from the
    same counter PRNG (request uid + position => token, independent of
    generation order)."""

    def __init__(self, cfg: TrafficConfig,
                 requests: List[TrafficRequest]) -> None:
        self.cfg = cfg
        self.requests = requests

    def __len__(self) -> int:
        return len(self.requests)

    def trace(self) -> List[Dict[str, Any]]:
        return [r.as_dict() for r in self.requests]

    def trace_bytes(self) -> bytes:
        """Canonical byte encoding of the trace — THE replay identity."""
        return json.dumps(self.trace(), sort_keys=True,
                          separators=(",", ":")).encode()

    def fingerprint(self) -> str:
        return hashlib.sha256(self.trace_bytes()).hexdigest()

    def prompt_tokens(self, uid: int, vocab: int) -> np.ndarray:
        """int32 [prompt_len] for request ``uid`` — tokens are a pure
        function of (seed, uid, position), so two runs (or two replicas
        replaying the trace) materialize identical prompts."""
        req = self.requests[uid - 1]
        assert req.uid == uid, "trace uids must be 1..n in order"
        return np.asarray(
            [_u64(self.cfg.seed, _S_TOKEN, uid, j) % vocab
             for j in range(req.prompt_len)], np.int32)

    def prompts(self, vocab: int) -> List[np.ndarray]:
        return [self.prompt_tokens(r.uid, vocab) for r in self.requests]

    def arrivals_by_tick(self) -> Dict[int, List[TrafficRequest]]:
        out: Dict[int, List[TrafficRequest]] = {}
        for r in self.requests:
            out.setdefault(r.arrival_tick, []).append(r)
        return out

    def summary(self) -> Dict[str, Any]:
        lens = [r.prompt_len for r in self.requests]
        outs = [r.max_new for r in self.requests]
        by_tenant: Dict[str, int] = {}
        for r in self.requests:
            by_tenant[r.tenant] = by_tenant.get(r.tenant, 0) + 1
        return {
            "n_requests": len(self.requests),
            "seed": self.cfg.seed,
            "fingerprint": self.fingerprint(),
            "first_tick": self.requests[0].arrival_tick
            if self.requests else None,
            "last_tick": self.requests[-1].arrival_tick
            if self.requests else None,
            "prompt_len_min": min(lens) if lens else None,
            "prompt_len_max": max(lens) if lens else None,
            "max_new_total": sum(outs),
            "tenants": by_tenant,
        }


def generate(cfg: TrafficConfig) -> Workload:
    """Materialize the trace.  Arrival times integrate an exponential
    inter-arrival process whose instantaneous rate is shaped by the
    diurnal cycle and burst windows (thinning-free: the mean gap is
    divided by the rate multiplier AT the current arrival's tick, which
    is deterministic and good enough for a bench scenario — this is a
    load generator, not a queueing-theory proof)."""
    assert cfg.n_requests >= 1
    # cumulative tenant weights for the inverse-CDF categorical draw
    total_w = sum(w for _, w in cfg.tenants)
    assert total_w > 0
    cum: List[Tuple[str, float]] = []
    acc = 0.0
    for name, w in cfg.tenants:
        acc += w / total_w
        cum.append((name, acc))

    out: List[TrafficRequest] = []
    t = 0.0
    for i in range(cfg.n_requests):
        u = _uniform(cfg.seed, _S_ARRIVAL, i)
        gap = -math.log(1.0 - u) * cfg.base_interval_ticks
        t += gap / cfg.rate_mult(t)
        up = _uniform(cfg.seed, _S_PROMPT, i)
        uo = _uniform(cfg.seed, _S_OUTPUT, i)
        ut = _uniform(cfg.seed, _S_TENANT, i)
        tenant = cum[-1][0]
        for name, edge in cum:
            if ut < edge:
                tenant = name
                break
        out.append(TrafficRequest(
            uid=i + 1,
            arrival_tick=int(t),
            prompt_len=_bounded_pareto(up, cfg.prompt_lo, cfg.prompt_hi,
                                       cfg.prompt_alpha),
            max_new=_bounded_pareto(uo, cfg.output_lo, cfg.output_hi,
                                    cfg.output_alpha),
            tenant=tenant))
    return Workload(cfg, out)


# ---------------------------------------------------------------------------
# scenario presets (the fleet bench's rows; tests pin their determinism)
# ---------------------------------------------------------------------------

_TENANT_MIX = (("interactive", 0.7), ("batch", 0.3))


def steady_config(n: int, seed: int, **over: Any) -> TrafficConfig:
    """Flat arrivals — the baseline every other scenario perturbs."""
    kw: Dict[str, Any] = dict(n_requests=n, seed=seed,
                              base_interval_ticks=3.0,
                              tenants=_TENANT_MIX)
    kw.update(over)
    return TrafficConfig(**kw)


def spike_config(n: int, seed: int, *, spike_tick: int = 12,
                 spike_width: int = 10, spike_factor: float = 8.0,
                 **over: Any) -> TrafficConfig:
    """Steady load with one sharp burst — the closed-loop autoscaler
    demo: the spike drives queue depth past the CUSUM threshold and the
    scale-out must restore windowed TTFT."""
    kw: Dict[str, Any] = dict(
        n_requests=n, seed=seed, base_interval_ticks=4.0,
        bursts=(Burst(spike_tick, spike_width, spike_factor),),
        tenants=_TENANT_MIX)
    kw.update(over)
    return TrafficConfig(**kw)


def diurnal_config(n: int, seed: int, *, period: int = 48,
                   amplitude: float = 0.8, **over: Any) -> TrafficConfig:
    """Sinusoidal day/night cycle — sustained swings, no step edges."""
    kw: Dict[str, Any] = dict(
        n_requests=n, seed=seed, base_interval_ticks=3.0,
        diurnal_period_ticks=period, diurnal_amplitude=amplitude,
        tenants=_TENANT_MIX)
    kw.update(over)
    return TrafficConfig(**kw)


def thundering_herd_config(n: int, seed: int, *, herd_width: int = 3,
                           **over: Any) -> TrafficConfig:
    """Everything arrives at once (a restart's reconnect stampede): one
    enormous burst at tick 0 — the admission-shedding scenario."""
    kw: Dict[str, Any] = dict(
        n_requests=n, seed=seed, base_interval_ticks=2.0,
        bursts=(Burst(0, herd_width, 50.0),),
        tenants=_TENANT_MIX)
    kw.update(over)
    return TrafficConfig(**kw)
