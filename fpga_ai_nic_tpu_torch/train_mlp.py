"""Canonical MLP training driver of the port — the counterpart of the JAX
package's ``examples/train_mlp.py``, with the same flags and the same JSON
keys (``loss``, ``samples_per_sec``, ``gflops``, ``wall_s``).

Examples (on the card; ``--device=cpu`` runs the plain versions instead):
  python -m fpga_ai_nic_tpu_torch.train_mlp --bfp=1 --mesh.dp=8 \\
      --collective.compression.codec=pallas \\
      --collective.fused_kernel=true --collective.fused_optimizer=true
  python -m fpga_ai_nic_tpu_torch.train_mlp --mesh.dp=2 \\
      --collective.impl=ring --collective.codec=int8 \\
      --collective.codec_opts=backend=pallas \\
      --collective.fused_optimizer=true --global_batch=5376
  python -m fpga_ai_nic_tpu_torch.train_mlp --model.layer_sizes=256,256,256 \\
      --global_batch=64 --iters=3 --device=cpu
  python -m fpga_ai_nic_tpu_torch.train_mlp --bfp=1 --mesh.dp=8 \\
      --collective.compression.codec=pallas \\
      --collective.fused_kernel=true --collective.fused_optimizer=true \\
      --collective.integrity_check=true
  python -m fpga_ai_nic_tpu_torch.train_mlp --mesh.dp=8 \\
      --collective.impl=ring --collective.codec=auto
  python -m fpga_ai_nic_tpu_torch.train_mlp --bfp=1 --mesh.dp=8 \\
      --collective.compression.codec=pallas \\
      --collective.fused_kernel=true --queue=explicit
  python -m fpga_ai_nic_tpu_torch.train_mlp --bfp=1 --mesh.dp=8 \\
      --collective.compression.codec=pallas \\
      --collective.fused_kernel=true --iters=3 --trace-dir=/tmp/mlp_trace

Flags split by prefix: ``--model.*`` -> MLPConfig, ``--device=`` picks the
device (default cuda; it raises when CUDA is absent), everything else ->
TrainConfig.  ``--bfp=1`` turns on the BFP wire codec and the explicit
ring; it applies before the dotted flags, so they can refine it.
``--queue=fused`` (the default) trains on ``DPTrainer``; ``--queue=explicit``
on ``parallel.queued.QueuedDDPTrainer``, the bucketed all-reduce issued
one collective a bucket through the host issue/wait queue (JAX's
flag), and the JSON carries its counters (``profile``:
``collectives``, the timed steps alone, and ``max_outstanding``).
``--collective.codec=`` names a registered codec (bfp, int8, topk) and
``--collective.codec_opts=key=value,...`` its options (``auto``: the tuner
picks codec, bucket and topology, and the JSON carries its plan under
``tune``); ``--collective.impl=ring``
must come first.  The ranks of ``--mesh.dp`` are virtual ranks on one
card.  The printed JSON carries the codec's ``describe()`` (None when the
wire is uncompressed).  With ``--collective.integrity_check=true`` a step
returns its diagnostics dict (``parallel.train``): the loss is read from
it, each step goes through ``runtime.chaos.check_step_diag``, and the JSON
carries the last step's ``wire_ok`` and ``integrity_ok``.
``--trace-dir=PATH`` (JAX's flag) runs the timed loop under
``torch.profiler`` (host operators and, on a card, every kernel and copy),
writes its chrome trace to ``PATH/train_mlp.pt.trace.json`` and puts the
trace's overlap summary (``utils.trace_analysis``: collective and copy
time covered by compute on another stream vs exposed) in the JSON under
``trace_analysis``.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from .models import mlp
from .ops import fused_update
from .parallel.mesh import make_ranks
from .parallel.queued import QueuedDDPTrainer
from .parallel.train import DPTrainer
from .runtime import chaos
from .runtime.watchdog import Watchdog
from .utils.config import MLPConfig, TrainConfig, from_flags
from .utils.observability import CollectiveStats

_TRUE, _FALSE = ("1", "true", "yes", "on"), ("0", "false", "no", "off")


def trace_flag(argv: Sequence[str]) -> Optional[str]:
    """JAX's ``--trace-dir=PATH`` (the last one given), or None."""
    out = None
    for a in argv:
        key, _, val = a.partition("=")
        if key == "--trace-dir":
            out = val
    return out


def queue_flag(argv: Sequence[str]) -> str:
    """JAX's ``--queue=fused|explicit`` (the last one given)."""
    mode = "fused"
    for a in argv:
        key, _, val = a.partition("=")
        if key == "--queue":
            if val not in ("fused", "explicit"):
                raise ValueError(f"--queue must be fused|explicit, got "
                                 f"{val!r}")
            mode = val
    return mode


def parse(argv: Sequence[str]):
    """``(MLPConfig, TrainConfig, device)`` from the driver's flags
    (``--queue`` is read by ``queue_flag``, ``--trace-dir`` by
    ``trace_flag``)."""
    model_flags: List[str] = []
    rest: List[str] = []
    bfp = False
    device = "cuda"
    for a in argv:
        key, _, val = a.partition("=")
        if a.startswith("--model."):
            model_flags.append(a.replace("--model.", "--", 1))
        elif key == "--bfp":
            if val.lower() not in _TRUE + _FALSE:
                raise ValueError(f"unrecognized --bfp value: {val!r}")
            bfp = val.lower() in _TRUE
        elif key == "--device":
            device = val
        elif key not in ("--queue", "--trace-dir"):
            rest.append(a)
    if bfp:
        rest = ["--collective.impl=ring",
                "--collective.compression.block_size=16"] + rest
    return (from_flags(MLPConfig, model_flags), from_flags(TrainConfig, rest),
            device)


def main(argv: Sequence[str]) -> dict:
    mcfg, cfg, device = parse(argv)
    queue = queue_flag(argv)
    trace_dir = trace_flag(argv)
    ranks = make_ranks(cfg.mesh, device)
    cls = QueuedDDPTrainer if queue == "explicit" else DPTrainer
    tr = cls(lambda p, b: mlp.loss_fn(p, b, mcfg), ranks, cfg)
    state = tr.init_state(mlp.init(torch.Generator().manual_seed(cfg.seed),
                                   mcfg, ranks.device))
    rng = np.random.default_rng(cfg.seed)
    x = torch.from_numpy(rng.standard_normal(
        (cfg.global_batch, mcfg.layer_sizes[0])).astype(np.float32))
    y = torch.from_numpy(rng.integers(
        0, mcfg.num_classes or mcfg.layer_sizes[-1], cfg.global_batch))
    batch = tr.shard_batch((x.to(getattr(torch, mcfg.dtype)), y))

    checked = cfg.collective.integrity_check
    diags = []

    def step(state):
        state, out = tr.step(state, batch)
        if not checked:
            return state, out
        diags.append(out)               # verdicts read after the timing
        return state, out["loss"]

    # a step or the final wait that wedges raises DeviceHangError instead
    # of blocking the driver forever (JAX's driver: Watchdog(600))
    wd = Watchdog(timeout_s=600.0)
    state, loss = wd.run(step, state)            # warm-up: kernel builds
    wd.run(float, loss)
    if queue == "explicit":                      # count the timed steps
        tr.profiler.collectives = CollectiveStats()
    t0 = time.perf_counter()
    with (_profiler(ranks.device) if trace_dir
          else contextlib.nullcontext()) as prof:
        for _ in range(cfg.iters):
            state, loss = wd.run(step, state)
        loss = wd.run(float, loss)               # waits for the device
        if trace_dir and ranks.device.type == "cuda":
            wd.run(torch.cuda.synchronize, ranks.device)
    wall = time.perf_counter() - t0
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir,
                                              "train_mlp.pt.trace.json"))
    for i, diag in enumerate(diags):
        chaos.check_step_diag(diag, i)
    fl = mlp.flops_per_sample(mcfg) * cfg.global_batch * cfg.iters
    codec = fused_update.resolve_codec(tr.cfg.collective)
    tuned = tr.obs_static_metrics().get("tune")
    verdicts = ({"wire_ok": bool(diags[-1]["wire_ok"]),
                 "integrity_ok": bool(diags[-1]["integrity_ok"])}
                if checked else {})
    return {"loss": loss, **verdicts,
            "samples_per_sec": cfg.iters * cfg.global_batch / wall,
            "gflops": fl / wall / 1e9, "wall_s": wall,
            "codec": codec.describe() if codec is not None else None,
            **({"tune": tuned} if tuned is not None else {}),
            "queue": queue,
            **({"profile": tr.profiler.report(),
                "max_outstanding": tr.queue.max_outstanding}
               if queue == "explicit" else {}),
            **({"trace_analysis": _trace_summary(trace_dir, ranks.device)}
               if trace_dir else {}),
            "device": (torch.cuda.get_device_name(ranks.device)
                       if ranks.device.type == "cuda" else "cpu")}


def _profiler(device):
    """``torch.profiler`` over the host operators of every thread (the
    watchdog runs each step in its own) and, on a card, every kernel and
    copy.  Where the installed torch has no ``profile_all_threads`` the
    trace holds the device events and this thread's operators."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.type == "cuda" else [])
    try:
        from torch._C._profiler import _ExperimentalConfig
        return profile(activities=acts, experimental_config=(
            _ExperimentalConfig(profile_all_threads=True)))
    except (ImportError, TypeError):
        return profile(activities=acts)


def _trace_summary(trace_dir: str, device) -> dict:
    """The trace's overlap summary (device events on a card, the host's
    operators on the CPU); an unreadable trace gives ``{"error": ...}``,
    never the loss of the run's result."""
    from .utils import trace_analysis as ta
    analyze = (ta.analyze_trace if device.type == "cuda"
               else ta.analyze_cpu_trace)
    try:
        return ta.summarize(analyze(trace_dir))
    except (FileNotFoundError, ValueError) as e:
        return {"error": f"{type(e).__name__}: {e}"}


if __name__ == "__main__":
    print(json.dumps(main(sys.argv[1:])))
