"""Structured telemetry event stream — spans, counters and instants on one
timebase.  The port's own copy of the JAX package's ``obs/events.py`` (that
module needs no JAX; the port imports nothing of the JAX package).

  - Schema-versioned: a JSONL dump leads with a header carrying
    ``SCHEMA_VERSION`` and the timebase anchors.
  - O(1) hot path: ``emit`` appends one tuple under a lock into a bounded
    ring; rendering happens at dump time.
  - Bounded, with honest overflow: the ring keeps the newest ``capacity``
    events and counts every evicted one in ``events_dropped``.
  - One timebase: ``time.perf_counter_ns()`` timestamps, with a paired
    (``time.time_ns``, ``perf_counter_ns``) anchor so any event converts
    to absolute unix-epoch ns (``to_unix_ns``).
  - Thread-safe.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Deque, Dict, Iterator, List, Optional, Tuple

SCHEMA_VERSION = 1

# event kinds (the "ph" analogue of the chrome trace format)
SPAN = "span"          # has dur_ns
INSTANT = "instant"    # point event
COUNTER = "counter"    # has value

_EVENT_KINDS = (SPAN, INSTANT, COUNTER)


class EventStream:
    """Bounded ring of structured telemetry events (see module docstring).

    One instance per Profiler; the default capacity holds about ten
    thousand ticks of span traffic while bounding memory for long runs.
    """

    def __init__(self, capacity: int = 1 << 16) -> None:
        assert capacity > 0
        self.capacity = int(capacity)
        # ring slots: (t_ns, dur_ns, kind, name, value, attrs, tid)
        self._buf: Deque[Tuple] = deque()
        self._lock = threading.Lock()
        self.events_dropped = 0
        self._emitted = 0
        # single-timebase anchor pair (see module docstring)
        self.t0_unix_ns = time.time_ns()
        self.t0_perf_ns = time.perf_counter_ns()

    # -- timebase -----------------------------------------------------------

    @staticmethod
    def now_ns() -> int:
        return time.perf_counter_ns()

    def to_unix_ns(self, t_perf_ns: float) -> int:
        """perf_counter timestamp -> absolute unix-epoch ns (the merge
        axis shared with device-plane trace intervals)."""
        return int(self.t0_unix_ns + (t_perf_ns - self.t0_perf_ns))

    # -- hot path -----------------------------------------------------------

    def emit(self, kind: str, name: str, t_ns: Optional[int] = None,
             dur_ns: Optional[int] = None, value: Optional[float] = None,
             attrs: Optional[Dict[str, Any]] = None) -> None:
        """Append one event.  O(1): a tuple append (plus one eviction when
        the ring is full) under a plain lock."""
        if t_ns is None:
            t_ns = time.perf_counter_ns()
        tid = threading.get_ident()
        with self._lock:
            self._emitted += 1
            if len(self._buf) >= self.capacity:
                self._buf.popleft()
                self.events_dropped += 1
            self._buf.append((t_ns, dur_ns, kind, name, value, attrs, tid))

    def instant(self, name: str, **attrs: Any) -> None:
        self.emit(INSTANT, name, attrs=attrs or None)

    def counter(self, name: str, value: float,
                **attrs: Any) -> None:
        self.emit(COUNTER, name, value=float(value), attrs=attrs or None)

    @contextmanager
    def span(self, name: str, **attrs: Any) -> Iterator[None]:
        """Timed span; records on exit (exceptions still record — a span
        that died is exactly the span the timeline must show)."""
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            t1 = time.perf_counter_ns()
            self.emit(SPAN, name, t_ns=t0, dur_ns=t1 - t0,
                      attrs=attrs or None)

    # -- rendering (cold path) ----------------------------------------------

    def snapshot(self) -> List[Dict[str, Any]]:
        """Events as dicts, oldest first, timestamps in absolute unix ns
        (the JSONL / timeline shape)."""
        with self._lock:
            raw = list(self._buf)
        out = []
        for t_ns, dur_ns, kind, name, value, attrs, tid in raw:
            ev: Dict[str, Any] = {"t_unix_ns": self.to_unix_ns(t_ns),
                                  "kind": kind, "name": name, "tid": tid}
            if dur_ns is not None:
                ev["dur_ns"] = int(dur_ns)
            if value is not None:
                ev["value"] = value
            if attrs:
                ev["attrs"] = attrs
            out.append(ev)
        return out

    def summary(self) -> Dict[str, Any]:
        """Aggregate view: per-span-name wall-clock totals (the
        DETAILED_PROFILE breakdown), latest counter values, and the
        recorded/dropped accounting.  Cheap enough to embed in every
        bench artifact."""
        with self._lock:
            raw = list(self._buf)
            emitted, dropped = self._emitted, self.events_dropped
        spans: Dict[str, Dict[str, float]] = {}
        counters: Dict[str, float] = {}
        kinds: Dict[str, int] = {}
        for t_ns, dur_ns, kind, name, value, attrs, tid in raw:
            kinds[kind] = kinds.get(kind, 0) + 1
            if kind == SPAN and dur_ns is not None:
                agg = spans.setdefault(name, {"count": 0, "total_s": 0.0,
                                              "max_s": 0.0})
                agg["count"] += 1
                agg["total_s"] += dur_ns / 1e9
                agg["max_s"] = max(agg["max_s"], dur_ns / 1e9)
            elif kind == COUNTER and value is not None:
                counters[name] = value       # latest wins (time-ordered)
        for agg in spans.values():
            agg["total_s"] = round(agg["total_s"], 6)
            agg["max_s"] = round(agg["max_s"], 6)
        return {"schema_version": SCHEMA_VERSION,
                "emitted": emitted, "recorded": len(raw),
                "events_dropped": dropped,
                "by_kind": kinds, "spans": spans, "counters": counters}

    # -- JSONL sink ---------------------------------------------------------

    def header(self) -> Dict[str, Any]:
        with self._lock:
            emitted, dropped = self._emitted, self.events_dropped
        return {"schema_version": SCHEMA_VERSION,
                "t0_unix_ns": self.t0_unix_ns,
                "emitted": emitted, "events_dropped": dropped,
                "capacity": self.capacity}

    def dump_jsonl(self, path: str) -> str:
        """Write header line + one JSON line per event (absolute unix-ns
        timestamps — streams from different processes merge directly)."""
        events = self.snapshot()       # render before opening (no IO races)
        with open(path, "w") as f:
            f.write(json.dumps(self.header()) + "\n")
            for ev in events:
                f.write(json.dumps(ev) + "\n")
        return path


def read_jsonl(path: str) -> Tuple[Dict[str, Any], List[Dict[str, Any]]]:
    """(header, events) from a dump_jsonl file.  Rejects unknown schema
    versions — the versioning contract that lets the timeline/gate tools
    evolve without silently misreading old dumps."""
    with open(path) as f:
        lines = [json.loads(l) for l in f if l.strip()]
    if not lines:
        raise ValueError(f"{path}: empty event stream")
    header, events = lines[0], lines[1:]
    ver = header.get("schema_version")
    if ver != SCHEMA_VERSION:
        raise ValueError(
            f"{path}: event schema v{ver!r} != supported v{SCHEMA_VERSION}")
    return header, events
