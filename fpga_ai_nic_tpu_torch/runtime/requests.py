"""Serving-plane request intake — the port's own copy of the JAX package's
``runtime/requests.py`` (that module needs no JAX; the port imports nothing
of the JAX package).

A thread-safe intake queue a front end submits generation requests into,
drained by the single-threaded engine loop (``serve.engine.ServeEngine``);
every submit lands an instant on the event stream.  ``ServeStats`` counters
change only inside locked ``record_*`` methods: front-end threads and the
engine loop both touch them.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

__all__ = ["Request", "RequestQueue", "ServeStats",
           "WAITING", "PREFILL", "DECODE", "FINISHED"]

# request lifecycle states (host-side; the device step never sees them)
WAITING = "waiting"      # queued or evicted — holds no slot, no pages
PREFILL = "prefill"      # slot assigned, replaying prompt (+ any generated
                         # tokens it lost to an eviction/preemption) in
                         # static chunks
DECODE = "decode"        # one token per engine tick
FINISHED = "finished"


@dataclass
class Request:
    """One generation request plus its host-side runtime bookkeeping.

    The device step never reads any of this: slots, page assignments and
    replay targets reach it as values of its operands."""

    uid: int
    prompt: np.ndarray               # int32 [prompt_len]
    max_new: int
    eos_id: Optional[int] = None
    not_before_s: float = 0.0        # arrival offset (offered-load shaping)
    tenant: Optional[str] = None     # traffic-mix label (telemetry only)

    # -- scheduler state (owned by serve.scheduler.ContinuousBatcher) -------
    state: str = WAITING
    slot: int = -1
    admit_seq: int = -1              # admission order; eviction picks newest
    generated: List[int] = field(default_factory=list)
    prefill_done: int = 0            # positions written this admission
    replay_len: int = 0              # prefill target for this admission
    evictions: int = 0

    # -- telemetry timestamps (perf_counter seconds; nan = not yet) ---------
    t_submit: float = float("nan")
    t_admit: float = float("nan")    # FIRST admission (queue wait endpoint)
    t_first: float = float("nan")    # first NEW token (TTFT endpoint)
    t_done: float = float("nan")

    # -- tick-domain milestones (fleet ticks; -1 = not yet) -----------------
    submit_tick: int = -1
    admit_tick: int = -1
    first_tick: int = -1
    done_tick: int = -1

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def n_tokens(self) -> int:
        """Positions the KV cache must hold right now: every prompt token
        plus every generated token except the newest (whose K/V is
        written by the decode step that consumes it)."""
        g = len(self.generated)
        return self.prompt_len + (g - 1 if g else 0)

    @property
    def done(self) -> bool:
        return self.state == FINISHED


class RequestQueue:
    """Thread-safe request intake with ticket telemetry.

    ``submit()`` may be called from any thread (a front-end, the bench
    driver's arrival process); ``pop_arrived()`` is the engine loop's
    single-threaded drain.  Arrival shaping: a request with
    ``not_before_s=t`` becomes visible t seconds after the queue's
    construction — how the bench sweeps offered load without threads."""

    def __init__(self, events: Optional[Any] = None,
                 stats: Optional["ServeStats"] = None) -> None:
        self.events = events             # obs.events.EventStream or None
        self.stats = stats or ServeStats()
        self._lock = threading.Lock()
        self._pending: List[Request] = []
        self._uid = 0
        self.t0 = time.perf_counter()

    def now(self) -> float:
        return time.perf_counter() - self.t0

    def submit(self, prompt: np.ndarray, max_new: int, *,
               eos_id: Optional[int] = None,
               not_before_s: float = 0.0) -> Request:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        with self._lock:
            self._uid += 1
            req = Request(uid=self._uid, prompt=prompt, max_new=max_new,
                          eos_id=eos_id, not_before_s=float(not_before_s),
                          t_submit=time.perf_counter())
            self._pending.append(req)
        self.stats.record_submitted()
        if self.events is not None:
            self.events.instant("serve.submit", uid=req.uid,
                                prompt_len=req.prompt_len,
                                max_new=req.max_new)
        return req

    def pop_arrived(self) -> List[Request]:
        """Drain every request whose arrival offset has elapsed (FIFO
        within the drained set)."""
        now = self.now()
        with self._lock:
            out = [r for r in self._pending if r.not_before_s <= now]
            self._pending = [r for r in self._pending
                             if r.not_before_s > now]
        return out

    def next_arrival_in(self) -> Optional[float]:
        """Seconds until the earliest still-future arrival (None when the
        queue is drained) — the engine's idle-sleep bound."""
        now = self.now()
        with self._lock:
            if not self._pending:
                return None
            return max(0.0, min(r.not_before_s for r in self._pending) - now)

    @property
    def pending(self) -> int:
        with self._lock:
            return len(self._pending)


@dataclass
class ServeStats:
    """Cross-thread serving counters, mutated ONLY through locked
    ``record_*`` methods (front-end submit threads and the engine loop
    both land here)."""

    submitted: int = 0
    admitted: int = 0
    completed: int = 0
    evicted: int = 0
    tokens_out: int = 0
    serve_recoveries: int = 0
    handoffs_in: int = 0         # requests adopted via fleet KV handoff
    handoffs_out: int = 0        # requests migrated away (pages released)
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False)

    def record_submitted(self) -> None:
        with self._lock:
            self.submitted += 1

    def record_admitted(self) -> None:
        with self._lock:
            self.admitted += 1

    def record_completed(self, n_tokens: int) -> None:
        with self._lock:
            self.completed += 1
            self.tokens_out += int(n_tokens)

    def record_evicted(self, n: int = 1) -> None:
        with self._lock:
            self.evicted += int(n)

    def record_recovery(self) -> None:
        with self._lock:
            self.serve_recoveries += 1

    def record_handoff_in(self) -> None:
        with self._lock:
            self.handoffs_in += 1

    def record_handoff_out(self) -> None:
        with self._lock:
            self.handoffs_out += 1

    def as_dict(self) -> Dict[str, int]:
        with self._lock:
            return {"submitted": self.submitted,
                    "admitted": self.admitted,
                    "completed": self.completed,
                    "evicted": self.evicted,
                    "tokens_out": self.tokens_out,
                    "serve_recoveries": self.serve_recoveries,
                    "handoffs_in": self.handoffs_in,
                    "handoffs_out": self.handoffs_out}
