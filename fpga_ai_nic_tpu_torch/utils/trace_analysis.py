"""Profiler-trace overlap analysis: stall attribution from a ``torch.profiler``
trace — the port of the JAX package's ``utils/trace_analysis.py``.

The reference attributes stalls with hardware counters (stall_host_in/out,
stall_eth_in/out); on a card the runtime hides the queues, so the
attribution comes from the trace.  This module reads the chrome-trace JSON
that kineto exports into a trace directory (``torch.profiler`` with
``tensorboard_trace_handler``, or ``export_chrome_trace``), walks each
card's device events and reports, for every asynchronous one, how much of
its time compute covered (overlapped) and how much ran with nothing else
on the card (exposed): JAX's report keys, the same interval math.

What the classes are on the port:

  collective   the port's own ring and codec kernels (``ring_rs_kernel``,
               ``ring_ag_kernel``, ``bfp_encode_kernel``,
               ``bfp_decode_kernel``, ``int8_encode_kernel``,
               ``int8_decode_kernel``), matched on the whole kernel name
               (templates, arguments and namespaces stripped), never as a
               substring: a kernel merely named after one is compute, the
               reason the JAX package gives for its word-scoped matching;
  dma          ``gpu_memcpy`` and ``gpu_memset`` events;
  compute      every other kernel.

A collective or dma event counts as overlapped where compute kernels on
another stream of the same card cover it (a stream runs its work in
order, so only another stream can hide it): the explicit queue's side
stream (``runtime/queue.py``) is what can.  On a trace without device
events (the CPU) ``analyze_any`` falls back to the host's ``cpu_op``
events, which name no collective there.

Pure-python interval math over the JSON; no tensorboard dependency.
"""

from __future__ import annotations

import argparse
import bisect
import gzip
import json
import os
import re
import sys
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

COLLECTIVE_KERNELS = ("ring_rs_kernel", "ring_ag_kernel", "bfp_encode_kernel",
                      "bfp_decode_kernel", "int8_encode_kernel",
                      "int8_decode_kernel")
_COLLECTIVE_RE = re.compile("|".join(COLLECTIVE_KERNELS))
_KERNEL_CATS = ("kernel",)
_DMA_CATS = ("gpu_memcpy", "gpu_memset")

Interval = Tuple[float, float]          # (start_ns, end_ns)


# ---------------------------------------------------------------------------
# interval arithmetic
# ---------------------------------------------------------------------------

def merge_intervals(ivs: Iterable[Interval]) -> List[Interval]:
    """Union of possibly-overlapping intervals, sorted, coalesced."""
    out: List[Interval] = []
    for s, e in sorted(ivs):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def total_len(ivs: Sequence[Interval]) -> float:
    return sum(e - s for s, e in ivs)


def overlap_len(iv: Interval, merged: Sequence[Interval]) -> float:
    """Length of iv covered by a merged (sorted, disjoint) interval set;
    bisects to the first candidate."""
    s, e = iv
    cov = 0.0
    i = bisect.bisect_right(merged, (s, float("inf"))) - 1
    if i >= 0 and merged[i][1] <= s:
        i += 1
    i = max(i, 0)
    while i < len(merged) and merged[i][0] < e:
        ms, me = merged[i]
        cov += min(e, me) - max(s, ms)
        i += 1
    return cov


# ---------------------------------------------------------------------------
# trace loading
# ---------------------------------------------------------------------------

def find_trace(trace_dir: str) -> str:
    """Newest kineto trace (``*.pt.trace.json``, or ``.json.gz``) under a
    trace directory; without one, the newest ``.json``."""
    cands = []
    for root, _, files in os.walk(trace_dir):
        for f in files:
            if f.endswith((".json", ".json.gz")):
                p = os.path.join(root, f)
                kineto = f.endswith((".pt.trace.json", ".pt.trace.json.gz"))
                cands.append((kineto, os.path.getmtime(p), p))
    if not cands:
        raise FileNotFoundError(f"no chrome-trace .json under {trace_dir}")
    return max(cands)[2]


def _load_trace(trace_dir: str, data: Optional[Dict] = None
                ) -> Tuple[str, Dict]:
    """(trace path, parsed JSON), reusing a caller's parse."""
    path = find_trace(trace_dir)
    if data is not None:
        return path, data
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return path, json.load(f)


def kernel_base(name: str) -> str:
    """A kernel's bare name: ``void ns::ring_rs_kernel<0, 1>(RsArgs)`` ->
    ``ring_rs_kernel``."""
    n = name.strip()
    if n.startswith("void "):
        n = n[5:]
    n = n.split("(", 1)[0].split("<", 1)[0].strip()
    return n.rsplit("::", 1)[-1]


def is_collective(name: str) -> bool:
    """Whole-name classifier of the port's ring and codec kernels."""
    return _COLLECTIVE_RE.fullmatch(kernel_base(name)) is not None


def _events(data: Dict) -> Tuple[List[Dict], int]:
    evs = data.get("traceEvents", data) if isinstance(data, dict) else data
    return [e for e in evs if isinstance(e, dict)], int(
        data.get("baseTimeNanoseconds", 0) if isinstance(data, dict) else 0)


def _ns(base: int, ts_us: Any) -> int:
    """An event's start in integer ns: kineto's microsecond ``ts`` (three
    decimals) after ``baseTimeNanoseconds`` (a unix-epoch ns count that a
    float cannot hold to the nanosecond)."""
    return base + round(float(ts_us) * 1e3)


def _device_events(data: Dict) -> List[Dict]:
    """Complete device events as {device, stream, name, cls, start_ns,
    end_ns}: cls is ``collective``, ``dma`` or ``compute``."""
    evs, base = _events(data)
    out = []
    for ev in evs:
        cat = str(ev.get("cat", "")).lower()
        if ev.get("ph") != "X" or cat not in _KERNEL_CATS + _DMA_CATS:
            continue
        dur = float(ev.get("dur", 0.0))
        if dur <= 0:
            continue
        args = ev.get("args") or {}
        start = _ns(base, ev["ts"])
        name = str(ev.get("name", ""))
        if cat in _DMA_CATS:
            cls = "dma"
        else:
            cls = "collective" if is_collective(name) else "compute"
        out.append({"device": int(args.get("device", ev.get("pid", 0))),
                    "stream": int(args.get("stream", ev.get("tid", 0))),
                    "name": kernel_base(name) if cat in _KERNEL_CATS
                    else name,
                    "cls": cls, "start_ns": start,
                    "end_ns": start + round(dur * 1e3)})
    return out


def _attribution_report(sync_by_stream: Dict[Any, List[Interval]],
                        async_evs: List[Tuple[str, str, Any, Interval]]
                        ) -> Dict:
    """JAX's overlapped/exposed accounting for one card: each async
    event's time split into the part compute on another stream covered
    and the exposed rest, ranked per op."""
    all_sync = merge_intervals(iv for ivs in sync_by_stream.values()
                               for iv in ivs)
    others: Dict[Any, List[Interval]] = {}
    rep = {"sync_busy_s": total_len(all_sync) / 1e9,
           "async_s": 0.0, "async_collective_s": 0.0,
           "async_dma_s": 0.0, "overlapped_s": 0.0, "exposed_s": 0.0}
    exposed_by_op: Dict[str, float] = {}
    for name, cls, stream, iv in async_evs:
        if stream not in others:
            others[stream] = merge_intervals(
                iv_ for s, ivs in sync_by_stream.items() if s != stream
                for iv_ in ivs)
        dur = (iv[1] - iv[0]) / 1e9
        cov = overlap_len(iv, others[stream]) / 1e9
        rep["async_s"] += dur
        rep["async_collective_s" if cls == "collective"
            else "async_dma_s"] += dur
        rep["overlapped_s"] += cov
        exposed = dur - cov
        rep["exposed_s"] += exposed
        if exposed > 0:
            exposed_by_op[name] = exposed_by_op.get(name, 0.0) + exposed
    rep["overlap_frac"] = (rep["overlapped_s"] / rep["async_s"]
                           if rep["async_s"] else 1.0)
    rep["exposed_by_op"] = exposed_by_op
    rep["top_exposed"] = sorted(exposed_by_op.items(),
                                key=lambda kv: -kv[1])[:5]
    rep["n_streams"] = len(sync_by_stream.keys()
                           | {a[2] for a in async_evs})
    return rep


def analyze_trace(trace_dir: str, *, data: Optional[Dict] = None) -> Dict:
    """Overlap/stall report for every card in the trace:
    ``{"devices": {"/device:GPU:<i>": report}, "trace": path}``; each
    report has sync_busy_s (compute), async{,_collective,_dma}_s,
    overlapped_s, exposed_s, overlap_frac, exposed_by_op, top_exposed and
    n_streams."""
    path, data = _load_trace(trace_dir, data)
    by_dev: Dict[int, Tuple[Dict, List]] = {}
    for ev in _device_events(data):
        sync, asy = by_dev.setdefault(ev["device"], ({}, []))
        iv = (ev["start_ns"], ev["end_ns"])
        if ev["cls"] == "compute":
            sync.setdefault(ev["stream"], []).append(iv)
        else:
            asy.append((ev["name"], ev["cls"], ev["stream"], iv))
    if not by_dev:
        raise ValueError(f"{path} holds no device events (kernel, "
                         "gpu_memcpy, gpu_memset): profile on a card with "
                         "ProfilerActivity.CUDA")
    devices = {f"/device:GPU:{d}": _attribution_report(*by_dev[d])
               for d in sorted(by_dev)}
    return {"devices": devices, "trace": path}


def analyze_cpu_trace(trace_dir: str, *, data: Optional[Dict] = None
                      ) -> Dict:
    """The host fallback (a trace taken on the CPU): ``cpu_op`` events as
    compute, those whose name classifies as a collective kernel as async
    (the port's CPU route launches none, so its async time is 0)."""
    path, data = _load_trace(trace_dir, data)
    evs, base = _events(data)
    sync: Dict[Any, List[Interval]] = {}
    asy = []
    for ev in evs:
        if ev.get("ph") != "X" or ev.get("cat") != "cpu_op":
            continue
        dur = float(ev.get("dur", 0.0))
        if dur <= 0:
            continue
        start = _ns(base, ev["ts"])
        iv = (start, start + round(dur * 1e3))
        tid = ev.get("tid", 0)
        if is_collective(str(ev.get("name", ""))):
            asy.append((kernel_base(str(ev["name"])), "collective", tid, iv))
        else:
            sync.setdefault(tid, []).append(iv)
    if not sync and not asy:
        raise ValueError(f"{path} holds no cpu_op events")
    rep = _attribution_report(sync, asy)
    rep["mode"] = "cpu-ops: host operator intervals, no device events"
    return {"devices": {"cpu": rep}, "trace": path}


def analyze_any(trace_dir: str, *, data: Optional[Dict] = None) -> Dict:
    """The device analysis where the trace has device events, the host
    fallback otherwise."""
    _, data = _load_trace(trace_dir, data)
    try:
        return analyze_trace(trace_dir, data=data)
    except ValueError:
        return analyze_cpu_trace(trace_dir, data=data)


def device_intervals(trace_dir: str, *, data: Optional[Dict] = None
                     ) -> List[Dict]:
    """Raw device intervals for the timeline (``obs.timeline``):
    ``{"plane", "line", "name", "start_ns", "end_ns", "cls"}`` with plane
    the card, line its stream, cls ``async`` (collective or dma) or
    ``sync`` — the classes the report counts."""
    _, data = _load_trace(trace_dir, data)
    return [{"plane": f"/device:GPU:{ev['device']}",
             "line": f"stream {ev['stream']}", "name": ev["name"],
             "start_ns": ev["start_ns"], "end_ns": ev["end_ns"],
             "cls": "sync" if ev["cls"] == "compute" else "async"}
            for ev in _device_events(data)]


def summarize(report: Dict) -> Dict:
    """One flattened summary across the cards (the JSON-line shape the
    drivers embed), with the ranked worst offenders."""
    devs = report["devices"].values()
    agg = {k: sum(d[k] for d in devs)
           for k in ("sync_busy_s", "async_s", "async_collective_s",
                     "async_dma_s", "overlapped_s", "exposed_s")}
    agg["overlap_frac"] = (agg["overlapped_s"] / agg["async_s"]
                           if agg["async_s"] else 1.0)
    agg["n_devices"] = len(report["devices"])
    by_op: Dict[str, float] = {}
    for d in devs:
        for name, s in (d.get("exposed_by_op") or
                        dict(d.get("top_exposed", ()))).items():
            by_op[name] = by_op.get(name, 0.0) + s
    agg["top_exposed"] = sorted(by_op.items(), key=lambda kv: -kv[1])[:5]
    return agg


def main(argv: Optional[Sequence[str]] = None) -> int:
    """``python -m fpga_ai_nic_tpu_torch.utils.trace_analysis <trace-dir>``:
    the attribution report as one JSON object on stdout."""
    ap = argparse.ArgumentParser(
        prog="python -m fpga_ai_nic_tpu_torch.utils.trace_analysis",
        description="Overlap/stall attribution from a torch.profiler trace "
                    "directory: collective and copy time split into "
                    "covered by compute on another stream vs exposed.")
    ap.add_argument("trace_dir", help="torch.profiler trace directory")
    ap.add_argument("--mode", choices=("auto", "device", "cpu"),
                    default="auto",
                    help="device = device events only, cpu = host cpu_op "
                         "events only, auto = device with the cpu fallback")
    ap.add_argument("--per-plane", action="store_true",
                    help="full per-card reports instead of the summary")
    ap.add_argument("--intervals", metavar="FILE", default=None,
                    help="also dump the raw device intervals (obs.timeline "
                         "input shape) to FILE")
    args = ap.parse_args(argv)
    analyze = {"auto": analyze_any, "device": analyze_trace,
               "cpu": analyze_cpu_trace}[args.mode]
    try:
        _, data = _load_trace(args.trace_dir)
        report = analyze(args.trace_dir, data=data)
    except (FileNotFoundError, ValueError) as e:
        print(json.dumps({"error": str(e)}))
        return 1
    if args.intervals:
        with open(args.intervals, "w") as f:
            json.dump(device_intervals(args.trace_dir, data=data), f)
    out = dict(report if args.per_plane else summarize(report),
               trace=report["trace"])
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
