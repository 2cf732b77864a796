"""Serving SLO observatory: windowed live metrics over the request plane —
the port of the JAX package's ``obs/slo.py`` (host Python, no device work).

``obs.metrics.RequestSpans`` summarizes a whole run after the fact; an
autoscaler needs the live view ("p99 TTFT over the last N completions")
plus per-tick pressure gauges (queue depth, pages in use, free pages,
per-replica batch occupancy):

  SloWindow      one bounded sliding window: O(1) insert (a deque with
                 maxlen; overflow evicts the oldest sample, counted),
                 nearest-rank p50/p95/p99 at snapshot time through
                 ``obs.metrics.percentile``.
  SloAggregator  the per-fleet collection: named windows (TTFT / TPOT /
                 queue wait by default; an unknown series raises), per-tick
                 gauges with latest and peak, each gauge mirrored as a
                 ``slo.<name>`` counter event on the attached EventStream.

Units are the caller's: the fleet feeds tick-domain values (TTFT in fleet
ticks), so a seeded run snapshots identically on any machine.  Every
mutation and every snapshot takes the aggregator's lock; the event-stream
mirror runs outside it (the stream has its own).
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Deque, Dict, Optional, Tuple

from .events import EventStream
from .metrics import percentile

__all__ = ["SloWindow", "SloAggregator", "DEFAULT_SERIES"]

DEFAULT_SERIES: Tuple[str, ...] = ("ttft", "tpot", "queue_wait")

# the percentile set every window reports — the p99 the after-the-fact
# summaries lacked is first-class here
QUANTILES: Tuple[float, ...] = (50.0, 95.0, 99.0)


class SloWindow:
    """One bounded sliding window: O(1) insert, snapshot-time sort.

    NOT thread-safe on its own — the owning SloAggregator serializes
    access under one lock (a per-window lock would invite lock-order
    inversions between snapshot-all and record)."""

    def __init__(self, maxlen: int) -> None:
        assert maxlen > 0
        self.maxlen = int(maxlen)
        self._buf: Deque[float] = deque(maxlen=self.maxlen)
        self.total = 0               # lifetime inserts (evictions implied)

    def push(self, value: float) -> None:
        self._buf.append(float(value))
        self.total += 1

    @property
    def evicted(self) -> int:
        return self.total - len(self._buf)

    def snapshot(self) -> Dict[str, Any]:
        """count/total/mean + nearest-rank p50/p95/p99 over the CURRENT
        window.  Empty windows report ``None`` (JSON null, the
        RequestSpans convention — never float NaN, which json.dump
        serializes as a token strict parsers reject) plus an explicit
        ``empty`` flag."""
        vals = sorted(self._buf)
        out: Dict[str, Any] = {"count": len(vals), "total": self.total,
                               "window": self.maxlen}
        if not vals:
            out["empty"] = True
            out["mean"] = None
            for q in QUANTILES:
                out[f"p{int(q)}"] = None
            return out
        out["mean"] = round(sum(vals) / len(vals), 6)
        for q in QUANTILES:
            out[f"p{int(q)}"] = round(percentile(vals, q), 6)
        return out


class SloAggregator:
    """Streaming windowed SLO metrics + per-tick gauges for one fleet.

    ``observe(series, value)`` is the O(1) hot path (one lock, one deque
    append); ``gauge(name, value)`` records a per-tick level (latest +
    peak kept) and mirrors it to the event stream as ``slo.<name>``;
    ``snapshot()`` renders the whole live view — the autoscaler's input
    and the bench's banked ``slo`` row."""

    def __init__(self, events: Optional[EventStream] = None, *,
                 window: int = 256,
                 series: Tuple[str, ...] = DEFAULT_SERIES) -> None:
        assert window > 0
        self.events = events
        self.window = int(window)
        self._windows: Dict[str, SloWindow] = {
            name: SloWindow(self.window) for name in series}
        self._gauge_latest: Dict[str, float] = {}
        self._gauge_peak: Dict[str, float] = {}
        self.observations = 0
        self._lock = threading.Lock()

    # -- recording (the drive loop / engine side) ---------------------------

    def observe(self, series: str, value: float) -> None:
        """One sample into a named window (O(1)); unknown series raise —
        a typo'd series name must not silently open a window nothing
        ever snapshots."""
        with self._lock:
            win = self._windows.get(series)
            if win is None:
                raise KeyError(
                    f"unknown SLO series {series!r} (have "
                    f"{sorted(self._windows)}; declare extra series at "
                    "construction)")
            win.push(value)
            self.observations += 1

    def gauge(self, name: str, value: float, *,
              replica: Optional[int] = None) -> None:
        """One per-tick level sample.  ``replica`` scopes per-replica
        gauges (batch occupancy) without colliding across replicas; the
        event-stream mirror carries it as an attr so the Perfetto
        counter track splits per replica."""
        v = float(value)
        key = name if replica is None else f"{name}.r{replica}"
        with self._lock:
            self._gauge_latest[key] = v
            peak = self._gauge_peak.get(key)
            self._gauge_peak[key] = v if peak is None else max(peak, v)
        if self.events is not None:
            if replica is None:
                self.events.counter(f"slo.{name}", v)
            else:
                self.events.counter(f"slo.{name}", v, replica=replica)

    # -- reading (the autoscaler / bench side) ------------------------------

    def window_stat(self, series: str, stat: str) -> Optional[float]:
        """One windowed statistic (e.g. ``("ttft", "p99")``) — the
        autoscaler's per-tick read; None while the window is empty."""
        snap = self.snapshot()["windows"].get(series)
        if snap is None:
            return None
        v = snap.get(stat)
        return None if v is None else float(v)

    def gauge_value(self, name: str, *,
                    peak: bool = False) -> Optional[float]:
        with self._lock:
            d = self._gauge_peak if peak else self._gauge_latest
            v = d.get(name)
            return None if v is None else float(v)

    def snapshot(self) -> Dict[str, Any]:
        """The live view: per-series window stats + gauge latest/peak +
        total observation accounting.  Safe to call from any thread
        while the drive loop records."""
        with self._lock:
            windows = {name: win.snapshot()
                       for name, win in self._windows.items()}
            gauges = {name: {"latest": self._gauge_latest[name],
                             "peak": self._gauge_peak[name]}
                      for name in sorted(self._gauge_latest)}
            n = self.observations
        return {"window": self.window, "observations": n,
                "windows": windows, "gauges": gauges}
