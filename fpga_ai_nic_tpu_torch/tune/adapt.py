"""The drift observatory and online plan adaptation — the port of the JAX
package's ``tune/adapt.py``, over the port's virtual ranks and
``DPTrainer``.

  live calibration   ``live_calibrate`` times the uncompressed ring
                     all-reduce (``ops.ring.ring_all_reduce``) and each
                     registered codec's encode and decode on the ranks the
                     job runs on (CUDA events on the card) and overlays
                     the rates at the ``live`` tier (``apply_live``;
                     dryrun when measured on the CPU).
  attribution        ``Attribution`` joins each step's measured wall time
                     with the active plan's modeled collective: the
                     warm-up median minus the modeled collective is the
                     compute baseline, and the excess after it is put on
                     the collective, the stage the candidates differ in;
                     streamed as ``tune.drift.*`` (``obs.metrics``
                     ``host_observe`` and an ``EventStream``).
  detection          ``DriftDetector``: two-sided CUSUM over the relative
                     residual with a post-trip cooldown
                     (``serve.sched_rules.SCHED_RULES.cusum_step``).
  adaptation         ``AdaptiveTrainer``: the bounded candidate set
                     (``tune_topk``), each a ``DPTrainer`` built and
                     stepped up front (``prewarm``); on a trip the
                     candidates are re-priced at the measured effective
                     link rate and the argmin installed at the next step
                     boundary.

Switch semantics (JAX's ``_migrate``): a candidate with the active plan's
codec and padded length takes the state untouched (bitwise); any other
gets the masters and moments re-fitted (``fused_update.repad_flat``,
value-exact), the replicas rebuilt from the masters by its own gather,
and the error-feedback residual zeroed.  JAX counts traces across a
switch; the eager port counts what a switch could add instead, the
kernel libraries loaded (``ops._build``) and the trainers constructed
after ``prewarm``: ``recompiles_across_switch`` must stay 0.  Since
``prewarm`` builds every trainer and steps every candidate, it is 0 by
construction here; it guards against a change that would build on a
switch, and the switching step's own time and allocator traffic are
what a measurement reads.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from .autotune import (TunedPlan, needs_autotune, payload_elems_of,
                       resolved_config, score_candidate, tune_topk)
from .calibration import Calibration, CodecRates, apply_live, \
    load_calibration
from ..obs.metrics import Ewma, host_observe
from ..serve.sched_rules import SCHED_RULES as _SCHED_RULES

__all__ = [
    "live_calibrate", "measure_ring_gbps", "Attribution", "DriftDetector",
    "AdaptiveController", "AdaptiveTrainer", "SwitchDecision",
]

_EPS_GBPS = 1e-4        # floor of the effective-rate estimate


# -- live calibration ----------------------------------------------------------

def _best_of(fn: Callable[[], Any], repeats: int,
             device: torch.device) -> float:
    """Best-of-N seconds of ``fn``: CUDA events around it on the card,
    the host clock on the CPU."""
    best = float("inf")
    for _ in range(max(1, repeats)):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            t = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            fn()
            t = time.perf_counter() - t0
        best = min(best, t)
    return best


def measure_ring_gbps(ranks: Any, *, payload_elems: int = 1 << 16,
                      repeats: int = 2) -> Tuple[float, float]:
    """(per-direction GB/s, seconds) of one uncompressed ring all-reduce
    (``ops.ring.ring_all_reduce``) of an [payload_elems] f32 payload over
    the ``ranks.n`` virtual ranks: the ring's own wire bytes a rank
    (``ring.wire_bytes_per_device``) over the best-of time."""
    from ..ops import ring as ring_ops
    n = ranks.n
    L = payload_elems + (-payload_elems) % max(n, 1)
    x = torch.ones((n, L), dtype=torch.float32, device=ranks.device)
    ring_ops.ring_all_reduce(x)             # first call outside the timing
    t = _best_of(lambda: ring_ops.ring_all_reduce(x), repeats, ranks.device)
    wire = ring_ops.wire_bytes_per_device(L, n, None)
    return (wire / t / 1e9 if t > 0 else 0.0), t


def _measure_codec_rates(payload_elems: int, repeats: int, dryrun: bool,
                         device: torch.device
                         ) -> Dict[str, Dict[str, CodecRates]]:
    """Each registered codec's encode and decode rates (its default
    options, as JAX's): raw f32 bytes over the best-of stage time, the
    same row for both payload classes."""
    from ..compress import available_codecs, get_codec
    out: Dict[str, Dict[str, CodecRates]] = {}
    for name in available_codecs():
        codec = get_codec(name)
        L = payload_elems + (-payload_elems) % codec.pad_elems
        x = torch.ones((L,), dtype=torch.float32, device=device)
        payload = codec.encode(x)
        codec.decode(payload, L, torch.float32)
        t_enc = _best_of(lambda: codec.encode(x), repeats, device)
        t_dec = _best_of(lambda: codec.decode(payload, L, torch.float32),
                         repeats, device)
        if t_enc <= 0 or t_dec <= 0:
            continue                    # never fabricate a rate
        raw = L * 4
        rates = CodecRates(raw / t_enc / 1e9, raw / t_dec / 1e9,
                           "live startup microbench", dryrun)
        out[name] = {"vmem": rates, "streaming": rates}
    return out


def live_calibrate(ranks: Any, *, base: Optional[Calibration] = None,
                   payload_elems: int = 1 << 16, repeats: int = 2,
                   measure_codecs: bool = True) -> Calibration:
    """The startup microbenches on ``ranks`` overlaid onto ``base`` (the
    banked calibration by default) at the live tier: sources ``live:
    ...``, ``*_live`` set, dryrun unless measured on the card."""
    base = base if base is not None else load_calibration()
    dev = ranks.device
    dryrun = dev.type != "cuda"
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu")
    gbps, _ = measure_ring_gbps(ranks, payload_elems=payload_elems,
                                repeats=repeats)
    codec_rates = (_measure_codec_rates(payload_elems, repeats, dryrun, dev)
                   if measure_codecs else None)
    return apply_live(
        base, inter_gbps=gbps if gbps > 0 else None,
        codec_rates=codec_rates, dryrun=dryrun,
        source=f"ring all-reduce microbench on {where} (n={ranks.n}, "
               f"{payload_elems} elems, best of {repeats})")


# -- attribution ---------------------------------------------------------------

class Attribution:
    """Measured step times joined with the active plan's modeled stages:
    the first ``warmup_steps`` set the baseline (their median),
    ``compute_s`` = baseline - modeled collective (at least 0), and each
    later step's excess over the baseline is put on the collective."""

    def __init__(self, modeled: Dict[str, float], *,
                 warmup_steps: int = 3, ewma_alpha: float = 0.25) -> None:
        assert warmup_steps >= 1, warmup_steps
        self.modeled = dict(modeled)
        self.warmup_steps = int(warmup_steps)
        self._alpha = ewma_alpha
        self.n_observed = 0
        self.rebase()

    def rebase(self, modeled: Optional[Dict[str, float]] = None) -> None:
        """Forget the baseline (after a switch: a new modeled collective
        and a new steady step time) and warm up again."""
        if modeled is not None:
            self.modeled = dict(modeled)
        self._warm: List[float] = []
        self.baseline_step_s: Optional[float] = None
        self.compute_s: Optional[float] = None
        self.resid_rel = Ewma(self._alpha)
        self.excess_s = Ewma(self._alpha)

    @property
    def warmed_up(self) -> bool:
        return self.baseline_step_s is not None

    def observe(self, step_s: float) -> Optional[Dict[str, float]]:
        """One measured step: the residual record, None while warming
        up."""
        self.n_observed += 1
        step_s = float(step_s)
        if self.baseline_step_s is None:
            self._warm.append(step_s)
            if len(self._warm) < self.warmup_steps:
                return None
            self.baseline_step_s = float(statistics.median(self._warm))
            self.compute_s = max(
                0.0, self.baseline_step_s - self.modeled["collective_s"])
            return None
        excess = step_s - self.baseline_step_s
        rel = excess / max(self.baseline_step_s, 1e-12)
        return {
            "step_s": step_s,
            "baseline_step_s": self.baseline_step_s,
            "compute_s": self.compute_s or 0.0,
            "modeled_collective_s": self.modeled["collective_s"],
            "modeled_stream_s": self.modeled.get("stream_s", 0.0),
            "modeled_overhead_s": self.modeled.get("overhead_s", 0.0),
            "collective_excess_s": excess,
            "measured_collective_s":
                max(0.0, self.modeled["collective_s"] + excess),
            "resid_rel": rel,
            "resid_rel_ewma": self.resid_rel.update(rel),
            "excess_s_ewma": self.excess_s.update(excess),
        }


# -- detection -----------------------------------------------------------------

class DriftDetector:
    """Two-sided CUSUM over the relative residual: a sustained shift
    accumulates past ``threshold`` and trips, a residual under
    ``drift_rel`` drains it; after a trip the detector rests for
    ``cooldown_steps``."""

    def __init__(self, *, drift_rel: float = 0.75, threshold: float = 3.0,
                 cooldown_steps: int = 8) -> None:
        assert drift_rel > 0 and threshold > 0
        self.drift_rel = float(drift_rel)
        self.threshold = float(threshold)
        self.cooldown_steps = int(cooldown_steps)
        self.pos = 0.0      # sustained slower-than-baseline drift
        self.neg = 0.0      # sustained faster-than-baseline drift
        self.cooldown = 0
        self.trips = 0

    def reset(self, *, cooldown: bool = True) -> None:
        self.pos = self.neg = 0.0
        if cooldown:
            self.cooldown = self.cooldown_steps

    def update(self, resid_rel: float) -> Optional[Tuple[str, float]]:
        """One residual -> None, or ("slow" | "fast", statistic) on a
        trip."""
        self.pos, self.neg, self.cooldown, trip = _SCHED_RULES.cusum_step(
            self.pos, self.neg, self.cooldown, float(resid_rel),
            self.drift_rel, self.threshold, self.cooldown_steps)
        if trip is not None:
            self.trips += 1
        return trip


@dataclasses.dataclass(frozen=True)
class SwitchDecision:
    """A pending step-boundary switch and its evidence."""
    target: int
    evidence: Dict[str, Any]


# -- the controller ------------------------------------------------------------

class AdaptiveController:
    """Measured step times through ``Attribution``, the residual through
    ``DriftDetector``; on a trip the candidates re-priced at the
    effective link rate W_eff = W modeled / (modeled + excess) (with the
    baseline's compute fixed, a sustained excess e means the collective
    takes modeled + e) and the argmin armed as the next switch."""

    def __init__(self, plans: List[TunedPlan], calibration: Calibration,
                 *, payload_elems: int, n: int, slice_elems: int = 8192,
                 warmup_steps: int = 3, ewma_alpha: float = 0.25,
                 drift_rel: float = 0.75, cusum_threshold: float = 3.0,
                 cooldown_steps: int = 8,
                 events: Optional[Any] = None) -> None:
        assert plans, "empty candidate set"
        self.plans = list(plans)
        self.calibration = calibration
        self.payload_elems = int(payload_elems)
        self.n = int(n)
        self.slice_elems = int(slice_elems)
        self.active = 0
        self.events = events
        self.attribution = Attribution(
            self._modeled(0), warmup_steps=warmup_steps,
            ewma_alpha=ewma_alpha)
        self.detector = DriftDetector(
            drift_rel=drift_rel, threshold=cusum_threshold,
            cooldown_steps=cooldown_steps)
        self._pending: Optional[SwitchDecision] = None
        self.last_record: Optional[Dict[str, float]] = None

    def _modeled(self, idx: int) -> Dict[str, float]:
        s = score_candidate(self.payload_elems, self.n,
                            self.plans[idx].candidate, self.calibration,
                            self.slice_elems)
        return {"collective_s": s["collective_s"],
                "stream_s": s["stream_s"], "overhead_s": s["overhead_s"]}

    def observe(self, step_s: float, *, step: int,
                t0_perf_ns: Optional[int] = None) -> None:
        """One measured step (after its outputs exist): streams the
        residual and may arm a switch for the next boundary."""
        rec = self.attribution.observe(step_s)
        self.last_record = rec
        if rec is None:
            return
        trip = self.detector.update(rec["resid_rel"])
        # a trip reports its crossing value (the detector has reset)
        cusum_pos, cusum_neg = self.detector.pos, self.detector.neg
        if trip is not None:
            if trip[0] == "slow":
                cusum_pos = trip[1]
            else:
                cusum_neg = trip[1]
        self._emit(rec, step, t0_perf_ns, cusum_pos, cusum_neg)
        if trip is None or self._pending is not None:
            return
        direction, stat = trip
        eff = self.effective_inter_gbps(rec["excess_s_ewma"])
        self._pending = SwitchDecision(self.retarget(eff), {
            "direction": direction,
            "cusum_stat": round(stat, 4),
            "resid_rel_ewma": round(rec["resid_rel_ewma"], 4),
            "collective_excess_s_ewma": round(rec["excess_s_ewma"], 6),
            "effective_inter_gbps": round(eff, 6),
            "calibrated_inter_gbps": round(self.calibration.inter_gbps, 6),
            "detected_step": int(step),
        })

    def _emit(self, rec: Dict[str, float], step: int,
              t0_perf_ns: Optional[int], cusum_pos: float,
              cusum_neg: float) -> None:
        drift = {
            "tune.drift.resid_rel": rec["resid_rel"],
            "tune.drift.resid_rel_ewma": rec["resid_rel_ewma"],
            "tune.drift.collective_excess_s": rec["collective_excess_s"],
            "tune.drift.measured_collective_s":
                rec["measured_collective_s"],
            "tune.drift.modeled_collective_s":
                rec["modeled_collective_s"],
            "tune.drift.cusum_pos": cusum_pos,
            "tune.drift.cusum_neg": cusum_neg,
        }
        host_observe(drift)
        ev = self.events
        if ev is None:
            return
        for name, v in drift.items():
            ev.counter(name, float(v))
        # the attribution lane: the measured step, the compute baseline,
        # the modeled collective and its excess, from the step's start
        t0 = (t0_perf_ns if t0_perf_ns is not None
              else time.perf_counter_ns() - int(rec["step_s"] * 1e9))
        common = {"lane": "attribution", "step": int(step),
                  "plan": self.active}
        ev.emit("span", "attr.step_measured", t_ns=t0,
                dur_ns=int(rec["step_s"] * 1e9),
                attrs=dict(common, stage="measured step",
                           resid_rel=round(rec["resid_rel"], 4)))
        ev.emit("span", "attr.compute_baseline", t_ns=t0,
                dur_ns=int(rec["compute_s"] * 1e9),
                attrs=dict(common, stage="compute (baseline)"))
        ev.emit("span", "attr.collective_modeled",
                t_ns=t0 + int(rec["compute_s"] * 1e9),
                dur_ns=int(rec["modeled_collective_s"] * 1e9),
                attrs=dict(common, stage="collective (modeled)"))
        excess = max(0.0, rec["collective_excess_s"])
        if excess > 0:
            ev.emit("span", "attr.collective_excess",
                    t_ns=t0 + int((rec["compute_s"]
                                   + rec["modeled_collective_s"]) * 1e9),
                    dur_ns=int(excess * 1e9),
                    attrs=dict(common, stage="collective (excess)"))

    def effective_inter_gbps(self, excess_s: float) -> float:
        modeled = self.attribution.modeled["collective_s"]
        denom = max(modeled + max(excess_s, 0.0), 1e-12)
        return max(self.calibration.inter_gbps * modeled / denom,
                   _EPS_GBPS)

    def retarget(self, effective_inter_gbps: float) -> int:
        """The argmin over the candidate set (never the whole grid: only
        built candidates are admissible) at the effective link rate."""
        calib = dataclasses.replace(self.calibration,
                                    inter_gbps=float(effective_inter_gbps))
        best, best_s = 0, float("inf")
        for i, p in enumerate(self.plans):
            s = score_candidate(self.payload_elems, self.n, p.candidate,
                                calib, self.slice_elems)["exposed_s"]
            if s < best_s:
                best, best_s = i, s
        return best

    def inject_shift(self, effective_inter_gbps: float,
                     step: int = -1) -> None:
        """Arm the switch the detector would arm at this effective rate,
        bypassing the timing path (the tests' and the card phase's
        seam)."""
        self._pending = SwitchDecision(self.retarget(effective_inter_gbps), {
            "direction": "injected",
            "effective_inter_gbps": round(float(effective_inter_gbps), 6),
            "detected_step": int(step),
        })

    def take_pending(self) -> Optional[SwitchDecision]:
        dec, self._pending = self._pending, None
        return dec

    def note_switch(self, target: int) -> None:
        """Install ``target``: rebase the attribution on its modeled stages
        and rest the detector."""
        self.active = int(target)
        self.attribution.rebase(self._modeled(self.active))
        self.detector.reset(cooldown=True)


# -- the adaptive trainer ------------------------------------------------------

class AdaptiveTrainer:
    """The top-k tuned plans over one set of virtual ranks, each a
    ``DPTrainer``, every one stepped once before the steady state
    (``prewarm``); the controller picks the one that runs, switching at
    step boundaries.  Needs ``cfg.collective.codec == "auto"`` and
    ``cfg.adapt.enabled``.  ``calibration`` and ``plans`` inject the
    rates and the candidate set (the tests' seam)."""

    def __init__(self, loss_fn: Callable, ranks: Any, cfg: Any, *,
                 events: Optional[Any] = None,
                 calibration: Optional[Calibration] = None,
                 plans: Optional[List[TunedPlan]] = None) -> None:
        if not cfg.adapt.enabled:
            raise ValueError("AdaptiveTrainer needs cfg.adapt.enabled=True "
                             "(use DPTrainer for a static plan)")
        if not needs_autotune(cfg.collective):
            raise ValueError(
                "AdaptiveTrainer needs collective.codec='auto': the "
                "candidate set is the autotuner grid")
        self.loss_fn = loss_fn
        self.ranks = ranks
        self.cfg = cfg
        self.n = ranks.n
        self.events = events
        self._calib_override = calibration
        self._plans_override = plans
        self.plans: List[TunedPlan] = []
        self.trainers: List[Any] = []
        self.controller: Optional[AdaptiveController] = None
        self.calibration: Optional[Calibration] = None
        self._params_like = None
        self._prewarmed = False
        self._trace_baseline = 0
        self._step_i = 0
        self.trainers_built = 0
        self.switches = 0
        self.switch_events: List[Dict[str, Any]] = []

    @property
    def active(self) -> int:
        assert self.controller is not None, "call init_state first"
        return self.controller.active

    @property
    def trainer(self) -> Any:
        """The active DPTrainer."""
        return self.trainers[self.active]

    def _resolve(self, params: Any) -> None:
        from ..parallel.train import DPTrainer
        acfg = self.cfg.adapt
        calib = self._calib_override
        if calib is None:
            calib = load_calibration()
            if acfg.live_calibration:
                calib = live_calibrate(self.ranks, base=calib)
        self.calibration = calib
        total = payload_elems_of(params)
        coll = self.cfg.collective
        plans = self._plans_override
        if plans is None:
            # depth pinned to 1, as in autotune.resolve_collective
            plans = tune_topk(total, self.n, acfg.n_candidates,
                              intra_size=coll.intra_size,
                              topology="hier" if coll.topology == "hier"
                              else None, calibration=calib,
                              slice_elems=coll.slice_elems, depths=(1,))
        self.plans = list(plans)
        self.trainers = []
        for plan in self.plans:
            cfg_i = dataclasses.replace(
                self.cfg, collective=resolved_config(coll, plan.candidate))
            self.trainers.append(DPTrainer(self.loss_fn, self.ranks, cfg_i))
            self.trainers_built += 1
        self.controller = AdaptiveController(
            self.plans, calib, payload_elems=total, n=self.n,
            slice_elems=coll.slice_elems,
            warmup_steps=acfg.warmup_steps, ewma_alpha=acfg.ewma_alpha,
            drift_rel=acfg.drift_rel,
            cusum_threshold=acfg.cusum_threshold,
            cooldown_steps=acfg.cooldown_steps, events=self.events)

    def init_state(self, params: Any) -> Any:
        self._resolve(params)
        self._params_like = params
        for tr in self.trainers:
            tr._ensure_meta(params)
        return self.trainers[0].init_state(params)

    def _ghost_params(self) -> Any:
        from ..ops.fused_update import tree_map
        return tree_map(torch.zeros_like, self._params_like)

    def prewarm(self, batch: Any) -> None:
        """Step every candidate once, the others from a state that came
        through the migration a switch takes (and back), so that a later
        switch loads no kernel library and builds no trainer; the count
        after this is the baseline of ``recompiles_across_switch``."""
        assert self.controller is not None, "call init_state first"
        src = self.trainers[self.active]
        ghost = src.init_state(self._ghost_params())
        ghost, _ = src.step(ghost, batch)
        src.params_from_master(ghost.w_own)
        for i, tr in enumerate(self.trainers):
            if i == self.active:
                continue
            mstate, _ = tr.step(self._migrate(ghost, self.active, i), batch)
            tr.params_from_master(mstate.w_own)
            ghost, _ = src.step(self._migrate(mstate, i, self.active),
                                batch)
        self._sync()
        self._prewarmed = True
        self._trace_baseline = self.total_traces

    @property
    def total_traces(self) -> int:
        """What a switch could add in the eager port: the kernel
        libraries loaded and the trainers built."""
        from ..ops import _build
        return len(_build._LIBS) + self.trainers_built

    @property
    def recompiles_across_switch(self) -> int:
        """Libraries loaded and trainers built since ``prewarm`` (0 is the
        contract, and 0 by construction once ``prewarm`` has run)."""
        if not self._prewarmed:
            return 0
        return self.total_traces - self._trace_baseline

    def _migrate(self, state: Any, src_i: int, tgt_i: int) -> Any:
        """The state from candidate ``src_i``'s layout onto ``tgt_i``'s:
        untouched with the same codec and padded length; otherwise the
        masters and moments re-fitted (value-exact), the replicas
        gathered by the target from the masters, the residual zeroed."""
        from ..ops import fused_update
        src, tgt = self.trainers[src_i], self.trainers[tgt_i]
        if (src.cfg.collective.codec == tgt.cfg.collective.codec
                and src._meta.padded_len == tgt._meta.padded_len):
            return state

        def refit(v: torch.Tensor) -> torch.Tensor:
            return fused_update.repad_flat(v.reshape(-1), tgt._meta
                                           ).reshape(self.n, -1)
        w_own = refit(state.w_own)
        opt_state = {k: refit(v) for k, v in state.opt_state.items()}
        return tgt._gather(w_own, opt_state, state.step,
                           tgt._init_codec_state())

    def _plan_label(self, i: int) -> str:
        c = self.plans[i].candidate
        return f"{i}:{c.codec or 'none'}/{c.topology}/b{c.bucket_elems}"

    def _apply_switch(self, state: Any, dec: SwitchDecision) -> Any:
        frm, to = self.active, dec.target
        state = self._migrate(state, frm, to)
        self.controller.note_switch(to)
        self.switches += 1
        event = {
            "step": self._step_i,
            "from_plan": self._plan_label(frm),
            "to_plan": self._plan_label(to),
            "from": self.plans[frm].describe(),
            "to": self.plans[to].describe(),
            "evidence": dict(dec.evidence),
            "bitwise": (self.plans[frm].candidate.codec
                        == self.plans[to].candidate.codec),
        }
        self.switch_events.append(event)
        if self.events is not None:
            self.events.instant(
                "adapt.switch", lane="attribution", stage="switch",
                step=self._step_i, from_plan=event["from_plan"],
                to_plan=event["to_plan"], **dec.evidence)
        host_observe({"adapt.switches": float(self.switches)})
        return state

    def _sync(self) -> None:
        if self.ranks.device.type == "cuda":
            torch.cuda.synchronize(self.ranks.device)

    def step(self, state: Any, batch: Any) -> Tuple[Any, Any]:
        assert self.controller is not None, "call init_state first"
        if not self._prewarmed:
            self.prewarm(batch)
        dec = self.controller.take_pending()
        if dec is not None and dec.target != self.active:
            state = self._apply_switch(state, dec)
        elif dec is not None:
            # a shift whose re-priced argmin is the active plan: the new
            # regime becomes the baseline
            self.controller.note_switch(dec.target)
        self._sync()
        t0_ns = time.perf_counter_ns()
        state, out = self.trainers[self.active].step(state, batch)
        self._sync()
        step_s = (time.perf_counter_ns() - t0_ns) / 1e9
        self.controller.observe(step_s, step=self._step_i, t0_perf_ns=t0_ns)
        self._step_i += 1
        return state, out

    def shard_batch(self, batch: Any) -> Any:
        return self.trainers[self.active].shard_batch(batch)

    def trace_counts(self) -> Dict[str, int]:
        """Each candidate's label with the trainers built for it (1)."""
        return {self._plan_label(i): 1 for i in range(len(self.trainers))}

    def obs_static_metrics(self) -> Dict[str, Any]:
        """The active trainer's statics and the adaptation plane's own:
        the candidates, the calibration's provenance, the switches."""
        d = self.trainer.obs_static_metrics()
        d["adapt"] = {
            "n_candidates": len(self.plans),
            "active": self.active,
            "candidates": [p.describe() for p in self.plans],
            "calibration": (self.calibration.describe()
                            if self.calibration else None),
            "switches": self.switches,
            "recompiles_across_switch": self.recompiles_across_switch,
        }
        return d
