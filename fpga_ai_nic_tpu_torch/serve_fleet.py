"""Serving-fleet driver of the port — the counterpart of the fleet tier of
the JAX package's ``tools/serve_bench.py``: random weights from a seed, a
seeded tick-domain workload (``serve.traffic``), a ``ServeFleet`` driven
tick by tick (each request submitted on its arrival tick), with the
autoscaler closing the loop in four of the six scenarios; prints the
fleet's ``summary()`` with its SLO block as one JSON line.

Scenarios (the JAX bench's six):
  steady           1 prefill + 2 decode replicas, steady traffic, no faults
  replica_kill     the same traffic, a decode replica preempted at tick 11
  spike            1 + 1 replicas, spare slots, the autoscaler; a burst
  diurnal          as spike on a day/night cycle, 24 idle ticks drained
  thundering_herd  as spike, everything arriving in the first 3 ticks
  chaos            spike traffic and a replica preempted at tick 18

Examples (on the card; ``--device=cpu`` runs the plain versions instead):
  python -m fpga_ai_nic_tpu_torch.serve_fleet --model=llama3_8b \\
      --scenario=replica_kill
  python -m fpga_ai_nic_tpu_torch.serve_fleet --model=tiny --device=cpu \\
      --scenario=thundering_herd --prompt_lo=4 --prompt_hi=16 \\
      --output_lo=2 --output_hi=8 --page_size=8 --n_pages=28 \\
      --max_pages_per_seq=8 --prefill_chunk=8

Flags are ``--name=value``: ``--scenario``, ``--model`` and
``--model.<field>=`` as in ``serve_llama``, ``--seed``, ``--device``
(default cuda; it raises when CUDA is absent), ``--n_requests`` (default
12, 16 for spike, diurnal and chaos), the traffic's lengths
(``--prompt_lo``, ``--prompt_hi``, ``--output_lo``, ``--output_hi``)
and the ``ServeConfig`` fields (``--max_reqs`` defaults to 4 in the
closed-loop scenarios, as in the JAX bench, else 16).  Every replica is
on ``--device``; the closed-loop scenarios add ``SPARE_SLOTS`` (one) slot
there for the autoscaler's scale-out.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Any, Dict, List, Optional, Sequence

import torch

from . import serve_llama
from .device import resolve_device
from .runtime import chaos as chaos_lib
from .runtime.requests import Request
from .serve import (Autoscaler, FleetConfig, ServeFleet, traffic)

SCENARIOS = ("steady", "replica_kill", "spike", "diurnal",
             "thundering_herd", "chaos")
CLOSED_LOOP = ("spike", "diurnal", "thundering_herd", "chaos")
KILL_TICK = {"replica_kill": 11, "chaos": 18}
SPIKE_TICK = 12
DRAIN_TICKS = {"diurnal": 24}
SPARE_SLOTS = 1                 # the closed loop's scale-out slot
DEFAULTS: Dict[str, Any] = {
    "scenario": "steady", "model": "llama3_8b", "seed": 0,
    "device": "cuda", "n_requests": 0, "prompt_lo": 128,
    "prompt_hi": 1024, "output_lo": 16, "output_hi": 32}


def workload(scenario: str, n: int, seed: int, **lengths: int
             ) -> traffic.Workload:
    """The scenario's seeded traffic (the JAX bench's configs) with the
    given length bounds."""
    if scenario in ("steady", "replica_kill"):
        cfg = traffic.steady_config(n, seed, base_interval_ticks=1.0,
                                    **lengths)
    elif scenario in ("spike", "chaos"):
        cfg = traffic.spike_config(n, seed, spike_tick=SPIKE_TICK, **lengths)
    elif scenario == "diurnal":
        cfg = traffic.diurnal_config(n, seed, period=24, amplitude=0.9,
                                     base_interval_ticks=1.0, **lengths)
    elif scenario == "thundering_herd":
        cfg = traffic.thundering_herd_config(n, seed, **lengths)
    else:
        raise ValueError(f"scenario must be one of {SCENARIOS}")
    return traffic.generate(cfg)


def drive(fleet: ServeFleet, wl: traffic.Workload, vocab: int, *,
          autoscaler: Optional[Autoscaler] = None, max_ticks: int = 600,
          drain_ticks: int = 0) -> List[Request]:
    """Submit each traffic request on its arrival tick, tick the fleet,
    then let the autoscaler observe; ``drain_ticks`` more idle ticks after
    the last completion (the scale-in side).  Returns the requests in uid
    order."""
    by_tick = wl.arrivals_by_tick()
    prompts = wl.prompts(vocab)
    last_arrival = max(by_tick) if by_tick else 0
    reqs: Dict[int, Request] = {}
    drain = None
    while True:
        for tr in by_tick.get(fleet.ticks, ()):
            reqs[tr.uid] = fleet.submit(prompts[tr.uid - 1],
                                        max_new=tr.max_new,
                                        tenant=tr.tenant)
        fleet.tick()
        if autoscaler is not None:
            autoscaler.observe_tick()
        if (drain is None and fleet.ticks > last_arrival
                and not fleet._arrivals
                and all(r.done for r in reqs.values())):
            drain = drain_ticks
        if drain is not None:
            if drain <= 0:
                return [reqs[u] for u in sorted(reqs)]
            drain -= 1
        if fleet.ticks >= max_ticks:
            raise RuntimeError(
                f"fleet drive exceeded {max_ticks} ticks with "
                f"{sum(1 for r in reqs.values() if not r.done)} open")


def slo_block(s: Dict[str, Any], reqs: Sequence[Request],
              scaler: Optional[Autoscaler] = None) -> Dict[str, Any]:
    """The tick-domain SLO figures of a run (the JAX bench's block):
    windowed percentiles, pressure peaks, tokens lost and the controller's
    decisions."""
    w, g = s["slo"]["windows"], s["slo"]["gauges"]
    out = {
        "ticks": s["ticks"],
        "tokens_lost": sum(r.max_new for r in reqs) - s["tokens_out"],
        "ttft_p50_ticks": w["ttft"]["p50"],
        "ttft_p95_ticks": w["ttft"]["p95"],
        "ttft_p99_ticks": w["ttft"]["p99"],
        "queue_wait_p95_ticks": w["queue_wait"]["p95"],
        "tpot_p50_ticks": w["tpot"]["p50"],
        "tpot_p95_ticks": w["tpot"]["p95"],
        "tpot_p99_ticks": w["tpot"]["p99"],
        "queue_depth_peak": g["queue_depth"]["peak"],
        "pages_in_use_peak": g["pages_in_use"]["peak"],
    }
    if scaler is not None:
        out.update(scaler.summary())
        out["decision_sequence"] = [(d.tick, d.action)
                                    for d in scaler.decisions]
    return out


def main(argv: Sequence[str]) -> Dict[str, Any]:
    scenario = next((a.partition("=")[2] for a in argv
                     if a.startswith("--scenario=")), DEFAULTS["scenario"])
    if scenario not in SCENARIOS:
        raise ValueError(f"--scenario must be one of {SCENARIOS}")
    closed = scenario in CLOSED_LOOP
    opts, scfg, cfg = serve_llama.parse(argv, DEFAULTS, dict(
        serve_llama.SERVE_DEFAULTS, max_reqs=4 if closed else 16))
    n = opts["n_requests"] or (16 if scenario in ("spike", "diurnal",
                                                  "chaos") else 12)
    dev = resolve_device(opts["device"])
    params = serve_llama.random_params(cfg, opts["seed"], dev)
    wl = workload(scenario, n, opts["seed"],
                  prompt_lo=opts["prompt_lo"], prompt_hi=opts["prompt_hi"],
                  output_lo=opts["output_lo"], output_hi=opts["output_hi"])
    plan = None
    if scenario in KILL_TICK:
        plan = chaos_lib.FaultPlan([chaos_lib.FaultSpec(
            "preemption", "fleet.membership", step=KILL_TICK[scenario])],
            seed=opts["seed"])
    fcfg = FleetConfig(1, 1) if closed else FleetConfig(1, 2)
    slots = fcfg.n_replicas + (SPARE_SLOTS if closed else 0)
    fleet = ServeFleet(params, cfg, scfg, fcfg, chaos=plan,
                       devices=[dev] * slots)
    scaler = (Autoscaler(fleet, fleet.slo, events=fleet.profiler.events)
              if closed else None)
    t0 = time.perf_counter()
    with chaos_lib.activate(plan):
        reqs = drive(fleet, wl, cfg.vocab, autoscaler=scaler,
                     drain_ticks=DRAIN_TICKS.get(scenario, 0))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    s = fleet.summary()
    out = {"scenario": scenario, "model": opts["model"],
           "device_name": (torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else "cpu"),
           "traffic": wl.summary(), "drive_wall_s": wall,
           "output_tok_s": s["tokens_out"] / wall if wall > 0 else None,
           "chaos_fired": len(plan.fired) if plan is not None else 0,
           **s, "slo_block": slo_block(s, reqs, scaler)}
    return out


if __name__ == "__main__":
    print(json.dumps(main(sys.argv[1:])))
