"""Profiler facade: named wall-clock buckets, collective and recovery
accounting and the structured event stream underneath — the port's own
copy of ``CollectiveStats``, ``RecoveryStats`` and ``Profiler`` from the
JAX package's ``utils/observability.py`` (those need no JAX).  The
explicit queue (``runtime.queue``) records into ``Profiler.collectives``.
Counters change only inside locked ``record_*`` methods.
"""

from __future__ import annotations

import json
import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..obs.events import EventStream


def _lock_field():
    # per-instance lock as a non-compared dataclass field
    return field(default_factory=threading.Lock, repr=False, compare=False)


@dataclass
class CollectiveStats:
    """Issue/completion accounting of the queued collectives: counts, wire
    and raw bytes, latency (issue to ready), stall (blocked in ``wait``)
    and overlap (issue to the start of ``wait``), and tickets abandoned
    by recovery."""

    issued: int = 0
    completed: int = 0
    abandoned: int = 0        # inflight tickets dropped by recovery
    wire_bytes: int = 0
    raw_bytes: int = 0
    # running latency aggregates (O(1) memory)
    latency_sum_s: float = 0.0
    latency_max_s: float = 0.0
    stall_s: float = 0.0      # blocked inside wait()
    overlap_s: float = 0.0    # issue -> wait gap
    _lock: threading.Lock = _lock_field()

    def record_issue(self, raw_bytes: int = 0, wire_bytes: int = 0) -> None:
        with self._lock:
            self.issued += 1
            self.raw_bytes += raw_bytes
            self.wire_bytes += wire_bytes or raw_bytes

    def record_completion(self, latency_s: float, stall_s: float,
                          overlap_s: float) -> None:
        with self._lock:
            self.completed += 1
            self.latency_sum_s += latency_s
            self.latency_max_s = max(self.latency_max_s, latency_s)
            self.stall_s += stall_s
            self.overlap_s += overlap_s

    def record_abandoned(self, n: int = 1) -> None:
        with self._lock:
            self.abandoned += n

    def record_latency(self, seconds: float) -> None:
        with self._lock:
            self.latency_sum_s += seconds
            self.latency_max_s = max(self.latency_max_s, seconds)

    def as_dict(self) -> Dict:
        with self._lock:
            n = self.completed
            return {
                "issued": self.issued,
                "completed": self.completed,
                "abandoned": self.abandoned,
                "wire_bytes": self.wire_bytes,
                "raw_bytes": self.raw_bytes,
                "compression_ratio": (self.raw_bytes / self.wire_bytes
                                      if self.wire_bytes else 1.0),
                "mean_latency_ms": (self.latency_sum_s / n * 1e3) if n
                                   else 0.0,
                "max_latency_ms": self.latency_max_s * 1e3,
                "stall_s": self.stall_s,
                "overlap_s": self.overlap_s,
            }


@dataclass
class RecoveryStats:
    """Fault/recovery accounting: every detected fault, every recovery
    and the mean time to recovery (the serving engine's replay tier
    records here)."""

    faults: Dict[str, int] = field(default_factory=lambda: defaultdict(int))
    recoveries: int = 0
    failed_recoveries: int = 0
    checkpoint_restores: int = 0
    # live mesh-reshard recoveries (parallel.reshard): the first-tier
    # path that migrates the in-memory state to the surviving mesh shape
    # instead of restoring a checkpoint — tracked with its OWN MTTR
    # aggregates so the reshard-vs-restore claim is measurable from the
    # same stats dump
    reshards: int = 0
    mttr_sum_s: float = 0.0
    mttr_max_s: float = 0.0
    # single-tier recoveries only (see record_recovery): the *_n counts
    # are the matching mean denominators, NOT the occurrence counters
    # above (a reshard-then-restore recovery increments both occurrence
    # counters but neither MTTR aggregate)
    mttr_reshard_sum_s: float = 0.0
    mttr_reshard_max_s: float = 0.0
    mttr_reshard_n: int = 0
    mttr_restore_sum_s: float = 0.0
    mttr_restore_max_s: float = 0.0
    mttr_restore_n: int = 0
    # durability-plane counters (utils.checkpoint v2): peer repairs of
    # corrupt stored shards, absorbed save failures, emergency dumps
    ckpt_repairs: int = 0
    ckpt_repair_wire_bytes: int = 0
    ckpt_save_failures: int = 0
    emergency_dumps: int = 0
    # bounded event log: [{step, kind, site, error, recovered_in_s}]
    events: List[Dict] = field(default_factory=list)
    max_events: int = 128
    # faults recorded past max_events: the log truncates, the COUNT never
    # does — a dump with a full log must say what it left out
    events_dropped: int = 0
    _lock: threading.Lock = _lock_field()

    def record_fault(self, kind: str, step: int, site: str = "",
                     error: str = "") -> Dict:
        ev = {"step": step, "kind": kind, "site": site,
              "error": error[:200], "recovered_in_s": None}
        with self._lock:
            self.faults[kind] += 1
            if len(self.events) < self.max_events:
                self.events.append(ev)
            else:
                self.events_dropped += 1
        return ev

    def record_recovery(self, seconds: float, *, restored: bool = False,
                        resharded: bool = False,
                        event: Dict = None) -> None:
        # per-tier MTTR aggregates attribute the wall clock to the tier
        # that ALONE performed the recovery: a step that resharded and
        # then still needed a restore books its (multi-tier) duration
        # into neither — crediting it to both would corrupt exactly the
        # reshard-vs-restore comparison these aggregates exist to make.
        # The occurrence counters still count every tier that fired.
        with self._lock:
            self.recoveries += 1
            if restored:
                self.checkpoint_restores += 1
                if not resharded:
                    self.mttr_restore_sum_s += seconds
                    self.mttr_restore_max_s = max(self.mttr_restore_max_s,
                                                  seconds)
                    self.mttr_restore_n += 1
            if resharded:
                self.reshards += 1
                if not restored:
                    self.mttr_reshard_sum_s += seconds
                    self.mttr_reshard_max_s = max(self.mttr_reshard_max_s,
                                                  seconds)
                    self.mttr_reshard_n += 1
            self.mttr_sum_s += seconds
            self.mttr_max_s = max(self.mttr_max_s, seconds)
        if event is not None:
            event["recovered_in_s"] = round(seconds, 4)
            event["tier"] = ("reshard+restore" if resharded and restored
                             else "reshard" if resharded
                             else "restore" if restored else "retry")

    def record_failed_recovery(self) -> None:
        with self._lock:
            self.failed_recoveries += 1

    def record_ckpt_repair(self, wire_bytes: int = 0) -> None:
        """One stored shard healed from its peer mirror at restore time
        (utils.checkpoint peer repair; ``wire_bytes`` = the pair
        transfer program's exact payload)."""
        with self._lock:
            self.ckpt_repairs += 1
            self.ckpt_repair_wire_bytes += int(wire_bytes)

    def record_ckpt_save_failure(self) -> None:
        """A checkpoint save failed mid-sequence (disk-full / injected
        kill) and was absorbed — the commit protocol kept the directory
        restorable, and the next cadence save retries."""
        with self._lock:
            self.ckpt_save_failures += 1

    def record_emergency_dump(self) -> None:
        """The ladder exhausted and the live state was persisted as an
        emergency checkpoint ('dump before dying')."""
        with self._lock:
            self.emergency_dumps += 1

    def as_dict(self) -> Dict:
        with self._lock:
            n = self.recoveries
            nrs, nre = self.mttr_reshard_n, self.mttr_restore_n
            return {
                "faults": dict(self.faults),
                "faults_total": sum(self.faults.values()),
                "recoveries": n,
                "failed_recoveries": self.failed_recoveries,
                "checkpoint_restores": self.checkpoint_restores,
                "reshards": self.reshards,
                "ckpt_repairs": self.ckpt_repairs,
                "ckpt_repair_wire_bytes": self.ckpt_repair_wire_bytes,
                "ckpt_save_failures": self.ckpt_save_failures,
                "emergency_dumps": self.emergency_dumps,
                "mttr_mean_s": (self.mttr_sum_s / n) if n else 0.0,
                "mttr_max_s": self.mttr_max_s,
                "mttr_reshard_mean_s": (self.mttr_reshard_sum_s / nrs)
                                       if nrs else 0.0,
                "mttr_reshard_max_s": self.mttr_reshard_max_s,
                "mttr_restore_mean_s": (self.mttr_restore_sum_s / nre)
                                       if nre else 0.0,
                "mttr_restore_max_s": self.mttr_restore_max_s,
                "events": list(self.events),
                "events_dropped": self.events_dropped,
            }


class Profiler:
    """Named wall-clock buckets + collective and recovery stats + the
    structured event stream underneath.  One instance per engine; cheap
    enough to leave on.  Each ``bucket()`` also lands a span in
    ``self.events``."""

    def __init__(self, events: Optional[EventStream] = None,
                 capacity: int = 1 << 16):
        self.buckets: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.collectives = CollectiveStats()
        self.recovery = RecoveryStats()
        self.events = events if events is not None else EventStream(capacity)
        self._lock = threading.Lock()

    @contextmanager
    def bucket(self, name: str):
        t0 = time.perf_counter()
        t0_ns = time.perf_counter_ns()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.buckets[name] += dt
                self.counts[name] += 1
            self.events.emit("span", name, t_ns=t0_ns,
                             dur_ns=time.perf_counter_ns() - t0_ns)

    def report(self) -> Dict:
        with self._lock:
            buckets = dict(self.buckets)
            counts = dict(self.counts)
        return {
            "buckets_s": buckets,
            "counts": counts,
            "collectives": self.collectives.as_dict(),
            "recovery": self.recovery.as_dict(),
            "events": self.events.summary(),
        }

    def json_line(self) -> str:
        return json.dumps(self.report())

    def dump_events(self, path: str) -> str:
        """JSONL sink for the underlying stream (obs.timeline input)."""
        return self.events.dump_jsonl(path)
