"""Single-timebase Perfetto/Chrome-trace export of the whole stack — the
port of the JAX package's ``obs/timeline.py``.

Host spans (Profiler buckets, elastic attempts), the collective queue's
issue/wait ticket intervals and the card's device intervals
(``utils.trace_analysis.device_intervals``: kernels and copies a stream),
merged onto one time axis and emitted as Chrome-trace JSON: load the file
in https://ui.perfetto.dev (or chrome://tracing) and a ticket span with no
compute under it reads as exposed wire time.

Timebase: host events carry absolute unix-epoch ns (``obs.events`` anchors
perf_counter to time.time when the stream is made).  Device intervals
come from the ``torch.profiler`` trace, whose clock is the profiler's, so
they are aligned by anchor, as the JAX package aligns its xplane: the
host span wrapping the capture (``torch_profile`` by convention,
overridable) pins the earliest device event to its start.  The offset is
recorded in the output's ``otherData``.

Output format: the Chrome trace-event JSON object form —
``{"traceEvents": [...], "displayTimeUnit": "ms", "otherData": {...}}``
with complete ("X") events for spans/intervals, counter ("C") events for
metric series, instant ("i") events, and metadata ("M") rows naming the
process/thread lanes.  Perfetto and chrome://tracing both load it.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional, Sequence, Tuple

from . import events as events_lib

# process ids (chrome trace "pid" lanes)
_PID_HOST = 1
_PID_QUEUE = 2
_PID_DEVICE = 3
_PID_ATTRIB = 4     # drift attribution: modeled-vs-measured per stage

DEFAULT_ANCHOR_SPAN = "torch_profile"


def _meta(pid: int, name: str, tid: Optional[int] = None,
          thread_name: Optional[str] = None) -> List[Dict]:
    out = [{"ph": "M", "pid": pid, "name": "process_name",
            "args": {"name": name}}]
    if tid is not None:
        out.append({"ph": "M", "pid": pid, "tid": tid,
                    "name": "thread_name", "args": {"name": thread_name}})
    return out


def _host_trace_events(host_events: Sequence[Dict[str, Any]],
                       t0_ns: int) -> List[Dict]:
    """Host stream -> chrome events.  Spans whose attrs carry
    ``lane='queue'`` (the CollectiveQueue's ticket intervals) get their
    own process so ticket overlap reads at a glance; spans/instants with
    ``lane='attribution'`` (the drift observatory's modeled-vs-measured
    stage residuals, tune.adapt) get the attribution process with one
    thread per stage, so the excess over the roofline model — and every
    ``adapt.switch`` it triggers — reads directly off the timeline;
    other spans lane by emitting thread."""
    out: List[Dict] = []
    tids: Dict[int, int] = {}
    attrib_tids: Dict[str, int] = {}
    queue_meta_done = False
    attrib_meta_done = False
    for ev in host_events:
        ts_us = (ev["t_unix_ns"] - t0_ns) / 1e3
        attrs = ev.get("attrs") or {}
        is_queue = attrs.get("lane") == "queue"
        if is_queue:
            pid, tid = _PID_QUEUE, int(attrs.get("uid", 0)) % 64
            if not queue_meta_done:
                out.extend(_meta(_PID_QUEUE, "collective queue (tickets)"))
                queue_meta_done = True
        elif attrs.get("lane") == "attribution":
            pid = _PID_ATTRIB
            if not attrib_meta_done:
                out.extend(_meta(_PID_ATTRIB,
                                 "drift attribution (modeled vs measured)"))
                attrib_meta_done = True
            stage = str(attrs.get("stage", "step"))
            if stage not in attrib_tids:        # first sighting
                attrib_tids[stage] = len(attrib_tids) + 1
                out.append({"ph": "M", "pid": _PID_ATTRIB,
                            "tid": attrib_tids[stage],
                            "name": "thread_name",
                            "args": {"name": stage}})
            tid = attrib_tids[stage]
        else:
            pid = _PID_HOST
            raw_tid = ev.get("tid", 0)
            if raw_tid not in tids:             # first sighting
                tids[raw_tid] = len(tids) + 1
                out.extend(_meta(_PID_HOST, "host", tid=tids[raw_tid],
                                 thread_name=f"thread-{tids[raw_tid]}"))
            tid = tids[raw_tid]
        kind = ev.get("kind")
        if kind == events_lib.SPAN:
            out.append({"ph": "X", "pid": pid, "tid": tid,
                        "name": ev["name"], "ts": ts_us,
                        "dur": ev.get("dur_ns", 0) / 1e3,
                        "args": attrs or {}})
        elif kind == events_lib.COUNTER:
            out.append({"ph": "C", "pid": _PID_HOST, "tid": 0,
                        "name": ev["name"], "ts": ts_us,
                        "args": {"value": ev.get("value", 0.0)}})
        elif kind == events_lib.INSTANT:
            out.append({"ph": "i", "pid": pid, "tid": tid, "s": "g",
                        "name": ev["name"], "ts": ts_us,
                        "args": attrs or {}})
    return out


def _device_offset_ns(device_intervals: Sequence[Dict[str, Any]],
                      host_events: Sequence[Dict[str, Any]],
                      anchor_span: str) -> Tuple[int, str]:
    """(shift, alignment) applied to device timestamps.  With the anchor
    span present (the host span wrapping the profiler capture) the
    earliest device event pins to its start: alignment ``anchored``.
    With device events but NO anchor span, the fallback to the earliest
    host event is a GUESS — the device epoch is backend-defined, so the
    merge may be misaligned by an arbitrary constant; that state is
    reported as ``offset_unknown`` (and chrome_trace plants an explicit
    marker in the device lane) instead of silently rendering a timeline
    whose cross-plane overlap claims mean nothing."""
    if not device_intervals:
        return 0, "n/a"
    dev_min = min(iv["start_ns"] for iv in device_intervals)
    for ev in host_events:
        if ev.get("kind") == events_lib.SPAN and ev["name"] == anchor_span:
            return int(ev["t_unix_ns"] - dev_min), "anchored"
    if host_events:
        anchor = min(ev["t_unix_ns"] for ev in host_events)
        return int(anchor - dev_min), "offset_unknown"
    return 0, "offset_unknown"


def _device_trace_events(device_intervals: Sequence[Dict[str, Any]],
                         offset_ns: int, t0_ns: int) -> List[Dict]:
    out: List[Dict] = []
    lanes: Dict[str, int] = {}
    for iv in device_intervals:
        lane = f"{iv.get('plane', 'device')} / {iv.get('line', 'ops')}"
        if lane not in lanes:                   # first sighting
            lanes[lane] = len(lanes) + 1
            out.extend(_meta(_PID_DEVICE, "device planes",
                             tid=lanes[lane], thread_name=lane))
        tid = lanes[lane]
        ts_us = (iv["start_ns"] + offset_ns - t0_ns) / 1e3
        out.append({"ph": "X", "pid": _PID_DEVICE, "tid": tid,
                    "name": iv["name"], "ts": ts_us,
                    "dur": (iv["end_ns"] - iv["start_ns"]) / 1e3,
                    "args": {"cls": iv.get("cls", "sync")}})
    return out


def chrome_trace(host_events: Sequence[Dict[str, Any]],
                 device_intervals: Optional[Sequence[Dict[str, Any]]] = None,
                 anchor_span: str = DEFAULT_ANCHOR_SPAN,
                 header: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Merge host events (obs.events snapshot/JSONL shape) and optional
    device intervals (utils.trace_analysis.device_intervals shape) into
    one Chrome-trace JSON object.  All timestamps are rebased to the
    earliest host event so the trace opens at t=0."""
    device_intervals = list(device_intervals or [])
    host_events = list(host_events)
    offset, alignment = _device_offset_ns(device_intervals, host_events,
                                          anchor_span)
    starts = [ev["t_unix_ns"] for ev in host_events]
    starts += [iv["start_ns"] + offset for iv in device_intervals]
    t0_ns = min(starts) if starts else 0
    trace_events: List[Dict] = []
    trace_events.extend(_meta(_PID_HOST, "host"))
    trace_events.extend(_host_trace_events(host_events, t0_ns))
    trace_events.extend(_device_trace_events(device_intervals, offset,
                                             t0_ns))
    if alignment == "offset_unknown":
        # the anchor span is missing: the device plane is placed by a
        # guess, and anyone reading cross-plane overlap must see that IN
        # the trace, not only in metadata nobody opens
        trace_events.append({
            "ph": "i", "pid": _PID_DEVICE, "tid": 0, "s": "p",
            "name": "offset_unknown", "ts": 0.0,
            "args": {"why": f"no '{anchor_span}' anchor span in the host "
                            "stream — device timestamps aligned to the "
                            "earliest host event, which may be off by an "
                            "arbitrary constant"}})
    other: Dict[str, Any] = {
        "schema_version": events_lib.SCHEMA_VERSION,
        "t0_unix_ns": t0_ns,
        "n_host_events": len(host_events),
        "n_device_intervals": len(device_intervals),
        "device_offset_ns": offset,
        "device_alignment": alignment,
    }
    if header:
        other["stream_header"] = header
    return {"traceEvents": trace_events, "displayTimeUnit": "ms",
            "otherData": other}


def build(events_jsonl: Optional[str] = None,
          stream: Optional[events_lib.EventStream] = None,
          trace_dir: Optional[str] = None,
          anchor_span: str = DEFAULT_ANCHOR_SPAN) -> Dict[str, Any]:
    """One-call export: host events from a JSONL dump or a live stream,
    device intervals from a ``torch.profiler`` trace directory when
    given."""
    if (events_jsonl is None) == (stream is None):
        raise ValueError("pass exactly one of events_jsonl / stream")
    if stream is not None:
        header, host_events = stream.header(), stream.snapshot()
    else:
        header, host_events = events_lib.read_jsonl(events_jsonl)
    device_intervals = None
    if trace_dir is not None:
        from ..utils import trace_analysis
        device_intervals = trace_analysis.device_intervals(trace_dir)
    return chrome_trace(host_events, device_intervals,
                        anchor_span=anchor_span, header=header)


def write(path: str, trace: Dict[str, Any]) -> str:
    with open(path, "w") as f:
        json.dump(trace, f)
    return path


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m fpga_ai_nic_tpu_torch.obs.timeline",
        description="Merge an obs event stream (+ optional torch.profiler "
                    "trace) into Perfetto-loadable Chrome-trace JSON.")
    ap.add_argument("events_jsonl", help="EventStream.dump_jsonl file")
    ap.add_argument("--trace-dir", default=None,
                    help="torch.profiler trace dir (device intervals)")
    ap.add_argument("--anchor-span", default=DEFAULT_ANCHOR_SPAN,
                    help="host span name pinning the device timebase "
                         f"(default: {DEFAULT_ANCHOR_SPAN})")
    ap.add_argument("-o", "--out", default="timeline.json")
    args = ap.parse_args(argv)
    trace = build(events_jsonl=args.events_jsonl, trace_dir=args.trace_dir,
                  anchor_span=args.anchor_span)
    write(args.out, trace)
    od = trace["otherData"]
    print(f"wrote {args.out}: {od['n_host_events']} host events, "
          f"{od['n_device_intervals']} device intervals "
          f"(offset {od['device_offset_ns']} ns) — load in "
          "https://ui.perfetto.dev")
    return 0


if __name__ == "__main__":
    sys.exit(main())
