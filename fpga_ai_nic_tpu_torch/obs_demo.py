"""Telemetry-plane demo: one run, one Perfetto-loadable timeline — the port of
the JAX package's ``examples/obs_demo.py``.

Trains a small MLP for a few steps with every telemetry layer on: Profiler
spans, the step metrics (``TrainConfig.obs_metrics``), the
CollectiveQueue's issue/wait ticket intervals, and a ``torch.profiler``
capture for the device intervals; then merges all of it onto one timebase
and writes:

    <out>/events.jsonl     the structured event stream (schema-versioned)
    <out>/timeline.json    Chrome-trace JSON: load in
                           https://ui.perfetto.dev — host spans, queue
                           tickets and device kernels on one axis
    <out>/summary.json     Profiler.report() + MetricsSink.as_dict()

On the card (the default):

    python -m fpga_ai_nic_tpu_torch.obs_demo --steps=6 --out=/tmp/obs_demo

``--device=cpu`` runs the plain versions on the CPU (the trace then holds
host operators only, so the timeline has no device lane).
"""

from __future__ import annotations

import json
import os
import sys
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch


def run(steps: int = 6, out_dir: str = "/tmp/obs_demo", trace: bool = True,
        codec: Optional[str] = "bfp", fused_optimizer: bool = False,
        device: str = "cuda", n: int = 8) -> Dict[str, Any]:
    from .models import mlp
    from .obs import metrics as obs_metrics
    from .obs import timeline
    from .parallel.mesh import make_ranks
    from .parallel.train import DPTrainer
    from .runtime.queue import CollectiveQueue
    from .utils.config import (CollectiveConfig, MeshConfig, MLPConfig,
                               TrainConfig)
    from .utils.observability import Profiler

    os.makedirs(out_dir, exist_ok=True)
    mcfg = MLPConfig(layer_sizes=(64, 128, 128, 10), dtype="float32")
    # fused_optimizer folds the update into the reduce-scatter; the demo
    # swaps it for the integrity gate, as JAX's does
    cfg = TrainConfig(
        iters=steps, global_batch=16 * n, mesh=MeshConfig(dp=n),
        collective=CollectiveConfig(impl="ring", codec=codec,
                                    integrity_check=not fused_optimizer,
                                    fused_optimizer=fused_optimizer),
        obs_metrics=True)
    ranks = make_ranks(cfg.mesh, device)
    trainer = DPTrainer(lambda p, b: mlp.loss_fn(p, b, mcfg), ranks, cfg)
    state = trainer.init_state(mlp.init(torch.Generator().manual_seed(0),
                                        mcfg, ranks.device))
    r = np.random.default_rng(0)
    x = torch.from_numpy(r.standard_normal((16 * n, 64)).astype(np.float32))
    y = torch.from_numpy(r.integers(0, 10, 16 * n))
    batch = trainer.shard_batch((x, y))

    profiler = Profiler()
    sink = obs_metrics.MetricsSink(events=profiler.events,
                                   static=trainer.obs_static_metrics())
    queue = CollectiveQueue(trainer.step, cfg.collective, profiler)
    wire = trainer.obs_static_metrics()
    metrics: Dict[str, Any] = {}

    def steps_loop(k: int) -> Dict[str, Any]:
        nonlocal state, metrics
        for _ in range(k):
            with profiler.bucket("step"):
                t = queue.issue(state, batch,
                                raw_bytes=wire["raw_bytes_per_allreduce"],
                                wire_bytes=wire["wire_bytes_per_allreduce"])
                state, out = queue.wait(t)
                # integrity-gated steps return their diag dict, the fused
                # optimizer's the bare loss
                metrics = out if isinstance(out, dict) else {"loss": out}
                float(metrics["loss"])
        return metrics

    trace_dir = os.path.join(out_dir, "torch_trace") if trace else None
    with obs_metrics.use_sink(sink):
        with profiler.bucket("warmup"):
            steps_loop(1)                       # builds outside the trace
        if trace_dir:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if ranks.device.type == "cuda"
                else [])
            with profiler.events.span(timeline.DEFAULT_ANCHOR_SPAN):
                with profile(activities=acts) as prof:
                    steps_loop(steps - 1)
                    if ranks.device.type == "cuda":
                        torch.cuda.synchronize(ranks.device)
            os.makedirs(trace_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(
                trace_dir, "obs_demo.pt.trace.json"))
        else:
            steps_loop(steps - 1)

    events_path = profiler.dump_events(os.path.join(out_dir, "events.jsonl"))
    tl = timeline.build(events_jsonl=events_path, trace_dir=trace_dir)
    tl_path = timeline.write(os.path.join(out_dir, "timeline.json"), tl)
    summary = {"profiler": profiler.report(), "metrics": sink.as_dict(),
               "final_loss": float(metrics["loss"]),
               "fused_optimizer": fused_optimizer,
               "timeline": tl["otherData"]}
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps({"out": out_dir, "events_jsonl": events_path,
                      "timeline_json": tl_path,
                      "n_host_events": tl["otherData"]["n_host_events"],
                      "n_device_intervals":
                          tl["otherData"]["n_device_intervals"],
                      "final_loss": summary["final_loss"],
                      "metrics_latest": summary["metrics"]["latest"]}))
    return summary


_TRUE = ("1", "true", "yes", "on")


def main(argv: Sequence[str]) -> int:
    kw: Dict[str, Any] = {}
    for a in argv:
        k, _, v = a.lstrip("-").partition("=")
        if k == "steps":
            kw["steps"] = int(v)
        elif k == "out":
            kw["out_dir"] = v
        elif k == "codec":
            kw["codec"] = v or None
        elif k == "trace":
            kw["trace"] = v.lower() in _TRUE
        elif k == "fused":
            kw["fused_optimizer"] = v.lower() in _TRUE
        elif k == "device":
            kw["device"] = v
        else:
            raise SystemExit(f"unknown flag {a!r} (--steps= --out= --codec= "
                             "--trace= --fused= --device=)")
    run(**kw)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
