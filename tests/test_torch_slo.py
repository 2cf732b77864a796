"""The port's SLO observatory (``obs/slo.py``), traffic generator
(``serve/traffic.py``) and autoscaler (``serve/autoscale.py``) against the
JAX package's, on the CPU.

- ``SloWindow`` / ``SloAggregator`` snapshots equal JAX's on the same
  observations and gauges; an unknown series raises; the gauges are
  mirrored as ``slo.<name>`` events; a threaded hammer loses no count in
  either.
- Traffic: the trace bytes, fingerprint, summary and ``prompt_tokens``
  equal JAX's for the four scenario configs at two seeds.
- The autoscaler's decisions (action, tick, evidence), suppressions and
  shed valve equal JAX's on the same signal sequences (a recording fake
  fleet, as JAX's tests use).
- The closed loop (JAX's ``tests/test_slo.py`` cell): seeded herd traffic
  on a 1-prefill, 1-decode fleet with one spare slot gives JAX's decision
  sequence, SLO snapshot and streams, scales out, loses no token.
"""

import dataclasses
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import jax

from fpga_ai_nic_tpu.models import llama as jax_llama
from fpga_ai_nic_tpu.obs import slo as jax_slo
from fpga_ai_nic_tpu.obs.events import EventStream as JaxEventStream
from fpga_ai_nic_tpu.serve import AutoscaleConfig as JaxAutoscaleConfig
from fpga_ai_nic_tpu.serve import Autoscaler as JaxAutoscaler
from fpga_ai_nic_tpu.serve import FleetConfig as JaxFleetConfig
from fpga_ai_nic_tpu.serve import ServeConfig as JaxServeConfig
from fpga_ai_nic_tpu.serve import ServeFleet as JaxServeFleet
from fpga_ai_nic_tpu.serve import traffic as jax_traffic
from fpga_ai_nic_tpu_torch import serve_fleet
from fpga_ai_nic_tpu_torch.models import llama
from fpga_ai_nic_tpu_torch.obs import slo
from fpga_ai_nic_tpu_torch.obs.events import EventStream
from fpga_ai_nic_tpu_torch.serve import (AutoscaleConfig, Autoscaler,
                                         FleetConfig, ServeConfig,
                                         ServeFleet, traffic)

CFG = llama.LlamaConfig.tiny()
JCFG = jax_llama.LlamaConfig.tiny()
SEED = 17


# -- the windowed aggregator -------------------------------------------------

SERIES_CASES = {
    "evicting": [float(i) for i in range(20)],
    "one": [3.5],
    "empty": [],
    "ties": [2.0, 2.0, 1.0, 7.0, 2.0, 9.5, 0.25],
}


@pytest.mark.parametrize("case", sorted(SERIES_CASES))
def test_window_snapshot_equals_jax(case):
    ours, theirs = slo.SloWindow(8), jax_slo.SloWindow(8)
    for v in SERIES_CASES[case]:
        ours.push(v)
        theirs.push(v)
    assert ours.snapshot() == theirs.snapshot()
    assert ours.evicted == theirs.evicted


def _feed(mod, events):
    agg = mod.SloAggregator(events, window=4)
    for i, v in enumerate((1.0, 2.0, 3.0, 10.0, 4.5)):
        agg.observe("ttft", v)
        agg.observe("queue_wait", v / 2)
        agg.gauge("queue_depth", 5.0 - i)
        agg.gauge("batch_occupancy", i / 4, replica=i % 2)
    return agg


def test_aggregator_equals_jax():
    ours = _feed(slo, EventStream())
    theirs = _feed(jax_slo, JaxEventStream())
    assert ours.snapshot() == theirs.snapshot()
    assert ours.window_stat("ttft", "p99") == theirs.window_stat(
        "ttft", "p99") == 10.0
    assert ours.window_stat("tpot", "p99") is None
    assert ours.gauge_value("queue_depth", peak=True) == 5.0
    assert ours.gauge_value("batch_occupancy.r1") == 0.75
    names = [(e["name"], e.get("value"), e.get("attrs"))
             for e in ours.events.snapshot()]
    assert names == [(e["name"], e.get("value"), e.get("attrs"))
                     for e in theirs.events.snapshot()]
    assert ("slo.queue_depth", 5.0, None) in names
    with pytest.raises(KeyError, match="unknown SLO series"):
        ours.observe("nope", 1.0)


def _hammer(mod, n_threads=8, per_thread=500):
    agg = mod.SloAggregator(window=64)
    barrier = threading.Barrier(n_threads + 1)
    stop = threading.Event()
    bad = []

    def hammer(tid):
        barrier.wait()
        for i in range(per_thread):
            for s in mod.DEFAULT_SERIES:
                agg.observe(s, float(tid * per_thread + i))
            agg.gauge("queue_depth", float(i), replica=tid)

    def reader():
        barrier.wait()
        while not stop.is_set():
            snap = agg.snapshot()
            bad.extend(s for s in mod.DEFAULT_SERIES
                       if snap["windows"][s]["count"] > 64)

    threads = [threading.Thread(target=hammer, args=(t,))
               for t in range(n_threads)]
    rd = threading.Thread(target=reader)
    for t in threads + [rd]:
        t.start()
    for t in threads:
        t.join(timeout=60)
    stop.set()
    rd.join(timeout=60)
    assert not any(t.is_alive() for t in threads + [rd]) and not bad
    snap = agg.snapshot()
    return ({s: (w["total"], w["count"]) for s, w in snap["windows"].items()},
            snap["observations"],
            {k: g["peak"] for k, g in snap["gauges"].items()})


def test_threaded_hammer_exact_counts_equal_jax():
    ours, theirs = _hammer(slo), _hammer(jax_slo)
    assert ours == theirs
    assert ours[0]["ttft"] == (4000, 64) and ours[1] == 3 * 4000


# -- the traffic generator ---------------------------------------------------

SCENARIO_CONFIGS = ("steady_config", "spike_config", "diurnal_config",
                    "thundering_herd_config")


@pytest.mark.parametrize("seed", [SEED, 3])
@pytest.mark.parametrize("config", SCENARIO_CONFIGS)
def test_traffic_equals_jax(config, seed):
    ours = traffic.generate(getattr(traffic, config)(16, seed))
    theirs = jax_traffic.generate(getattr(jax_traffic, config)(16, seed))
    assert ours.trace_bytes() == theirs.trace_bytes()
    assert ours.fingerprint() == theirs.fingerprint()
    assert ours.summary() == theirs.summary()
    for uid in (1, 7, 16):
        np.testing.assert_array_equal(ours.prompt_tokens(uid, CFG.vocab),
                                      theirs.prompt_tokens(uid, CFG.vocab))
    assert ours.fingerprint() != traffic.generate(
        getattr(traffic, config)(16, seed + 1)).fingerprint()


def test_traffic_streams_are_independent():
    base = traffic.steady_config(16, SEED)
    fat = dataclasses.replace(base, output_alpha=0.8, output_hi=64)
    wa, wb = traffic.generate(base), traffic.generate(fat)
    assert ([r.arrival_tick for r in wa.requests]
            == [r.arrival_tick for r in wb.requests])
    assert ([r.max_new for r in wa.requests]
            != [r.max_new for r in wb.requests])
    assert all(r.arrival_tick <= 3 for r in traffic.generate(
        traffic.thundering_herd_config(12, SEED)).requests)


# -- the controller on signal sequences ----------------------------------------

class _FakeFleet:
    """Recording fleet surface: the controller's decisions without an
    engine (JAX's ``tests/test_slo.py`` fake)."""

    def __init__(self, sig, spares=1):
        self.sig = dict(sig)
        self.spares = spares
        self.hold_admissions = False
        self.calls = []

    def load_signals(self):
        return dict(self.sig)

    def add_replica(self, role="decode"):
        if self.spares <= 0:
            return None
        self.spares -= 1
        self.calls.append(("add", role))
        self.sig["n_decode"] += 1
        self.sig["n_decode_pure"] += 1
        return object()

    def kill_replica(self, idx):
        self.calls.append(("kill", idx))
        self.sig["n_decode"] -= 1
        self.sig["n_decode_pure"] -= 1

    def set_role(self, idx, role):
        self.calls.append(("role", idx, role))


BASE_SIG = {"queue_depth": 0.0, "live": 0.0, "n_alive": 2.0,
            "n_prefill": 1.0, "n_decode": 1.0, "n_prefill_pure": 1.0,
            "n_decode_pure": 1.0, "rebalance_idx": -1.0,
            "scale_in_idx": 1.0, "pages_in_use": 0.0, "free_pages": 24.0,
            "free_frac": 0.9, "spare_devices": 1.0}
OVERLOAD = {"queue_depth": 20.0}
# name -> (signal overrides, spares, ticks, free_frac a tick or None)
SIGNAL_CASES = {
    "overload_scales_out": (OVERLOAD, 1, 6, None),
    "no_spare_rebalances": (dict(OVERLOAD, n_prefill_pure=2.0,
                                 rebalance_idx=0.0), 0, 6, None),
    "trip_at_bound_suppressed": (OVERLOAD, 0, 6, None),
    "idle_scales_in_once": ({"n_decode": 2.0, "n_decode_pure": 2.0}, 1, 40,
                            None),
    "shed_valve": ({}, 1, 5, (0.05, 0.2, 0.5, 0.08, 0.31)),
    "ramp": ({"queue_depth": 3.0}, 2, 30, None),
}


def _control(mod_cfg, mod_scaler, mod_slo, case):
    over, spares, ticks, fracs = SIGNAL_CASES[case]
    fleet = _FakeFleet(dict(BASE_SIG, **over), spares)
    agg = mod_slo.SloAggregator()
    sc = mod_scaler(fleet, agg, cfg=mod_cfg())
    for t in range(ticks):
        if fracs is not None:
            fleet.sig["free_frac"] = fracs[t]
        if case == "ramp":
            fleet.sig["queue_depth"] = float(3 * t % 17)
            agg.observe("ttft", float(t % 5))
        sc.observe_tick()
    return ([(d.action, d.tick, d.evidence) for d in sc.decisions],
            sc.summary(), fleet.calls, fleet.hold_admissions)


@pytest.mark.parametrize("case", sorted(SIGNAL_CASES))
def test_autoscaler_decisions_equal_jax(case):
    ours = _control(AutoscaleConfig, Autoscaler, slo, case)
    theirs = _control(JaxAutoscaleConfig, JaxAutoscaler, jax_slo, case)
    assert ours == theirs
    if case == "overload_scales_out":
        assert ours[2] == [("add", "decode")] and ours[1]["decisions"] == 1
    if case == "shed_valve":
        assert [d[0] for d in ours[0]] == ["shed_on", "shed_off",
                                           "shed_on", "shed_off"]


def test_autoscale_config_validation():
    with pytest.raises(ValueError):
        AutoscaleConfig(shed_free_frac_lo=0.5, shed_free_frac_hi=0.2)
    with pytest.raises(ValueError):
        AutoscaleConfig(min_decode=0)


# -- the closed loop ---------------------------------------------------------

LOOP_SHAPE = dict(max_reqs=4, page_size=8, n_pages=28, max_pages_per_seq=8,
                  prefill_chunk=8)


def _jax_drive(fleet, wl, scaler, max_ticks=300):
    """JAX's ``tests/test_slo.py`` drive loop."""
    by_tick = wl.arrivals_by_tick()
    prompts = wl.prompts(JCFG.vocab)
    reqs, last = {}, max(by_tick)
    while True:
        for tr in by_tick.get(fleet.ticks, ()):
            reqs[tr.uid] = fleet.submit(prompts[tr.uid - 1],
                                        max_new=tr.max_new,
                                        tenant=tr.tenant)
        fleet.tick()
        scaler.observe_tick()
        if (fleet.ticks > last and not fleet._arrivals
                and all(r.done for r in reqs.values())):
            return [reqs[u] for u in sorted(reqs)]
        assert fleet.ticks < max_ticks, "closed loop wedged"


def test_herd_closed_loop_equals_jax():
    jparams = jax_llama.init(jax.random.PRNGKey(0), JCFG)
    jfleet = JaxServeFleet(jparams, JCFG, JaxServeConfig(**LOOP_SHAPE),
                           JaxFleetConfig(1, 1), devices=jax.devices()[:3])
    jscaler = JaxAutoscaler(jfleet, jfleet.slo,
                            events=jfleet.profiler.events)
    jreqs = _jax_drive(jfleet, jax_traffic.generate(
        jax_traffic.thundering_herd_config(12, SEED)), jscaler)
    js = jfleet.summary()

    params = llama.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    fleet = ServeFleet(params, CFG, ServeConfig(**LOOP_SHAPE),
                       FleetConfig(1, 1), devices=["cpu"] * 3)
    scaler = Autoscaler(fleet, fleet.slo, events=fleet.profiler.events)
    reqs = serve_fleet.drive(fleet, traffic.generate(
        traffic.thundering_herd_config(12, SEED)), CFG.vocab,
        autoscaler=scaler)
    s = fleet.summary()

    assert [(d.tick, d.action, d.evidence) for d in scaler.decisions] == \
        [(d.tick, d.action, d.evidence) for d in jscaler.decisions]
    assert scaler.summary() == jscaler.summary()
    assert s["slo"] == js["slo"]
    assert [r.generated for r in reqs] == [r.generated for r in jreqs]
    for key in ("ticks", "grows", "handoffs", "handoff_wire_bytes",
                "fleet_replays", "completed", "tokens_out"):
        assert s[key] == js[key], key
    assert scaler.scale_outs >= 1 and s["grows"] >= 1
    assert all(len(r.generated) == r.max_new for r in reqs)
    assert s["recompiles_steady"] == 0
    assert all(r.done_tick >= r.first_tick >= r.submit_tick >= 0
               for r in reqs)
    assert s["slo"]["windows"]["ttft"]["total"] == len(reqs)
    evs = [e for e in fleet.profiler.events.snapshot()
           if e["name"] == "scale.decision"]
    assert len(evs) == len(scaler.decisions) >= 1


@pytest.mark.slow
def test_closed_loop_is_deterministic_across_runs():
    """The port's whole closed loop (traffic -> fleet ticks -> windowed
    SLO -> decisions) replays identically from the seed (JAX's matching
    sweep is slow too)."""
    params = llama.init(torch.Generator().manual_seed(0), CFG, "cpu")
    runs = []
    for _ in range(2):
        fleet = ServeFleet(params, CFG, ServeConfig(**LOOP_SHAPE),
                           FleetConfig(1, 1), devices=["cpu"] * 3)
        scaler = Autoscaler(fleet, fleet.slo, events=fleet.profiler.events)
        reqs = serve_fleet.drive(fleet, traffic.generate(
            traffic.thundering_herd_config(12, SEED)), CFG.vocab,
            autoscaler=scaler)
        runs.append((fleet.summary()["slo"], scaler.summary(),
                     [list(r.generated) for r in reqs]))
    assert runs[0] == runs[1]


def test_tune_and_serve_import_in_either_order():
    """``tune.adapt`` imports ``serve.sched_rules`` and ``serve.autoscale``
    imports ``tune.adapt``: each package imports first in a fresh
    process."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for first, second in (("tune", "serve"), ("serve", "tune")):
        res = subprocess.run(
            [sys.executable, "-c", f"import fpga_ai_nic_tpu_torch.{first}; "
             f"import fpga_ai_nic_tpu_torch.{second}"],
            cwd=root, capture_output=True, text=True, timeout=300)
        assert res.returncode == 0, res.stderr
