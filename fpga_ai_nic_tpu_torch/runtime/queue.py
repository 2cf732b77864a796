"""The explicit collective queue — the port of the JAX package's
``runtime/queue.py``: the reference's host issue/wait ABI (a collective
issued, a done flag waited on, at most ``CollectiveConfig.max_inflight``
in flight) on CUDA streams and events.

On a card, ``issue`` launches the collective behind the work already
queued, on a side stream of its own:

  1. the side stream waits on the current stream (the inputs are ready);
  2. the collective runs under ``torch.cuda.stream(side)``, so its kernels,
     which launch on the current stream (``ops._build``), follow it;
  3. every tensor that crosses streams is marked with ``record_stream``:
     the inputs for the side stream, the results for the current one, so
     the caching allocator does not hand their memory to another
     allocation while the other stream may still use it;
  4. a CUDA event is recorded on the side stream: the ticket's done flag.

``wait`` synchronizes the host on the event (the host-visible stall, JAX's
``block_until_ready``), then has the current stream wait on it.  On the
CPU ``issue`` runs the collective at once, for the tests; the device is
explicit (the tensors').

The bounded window blocks ``issue`` on the oldest ticket once
``max_inflight`` are outstanding; ``max_outstanding`` keeps the most that
were ever outstanding at once.  Issues, completions, latency, stall
(blocked in ``wait``), overlap (issue to ``wait``) and abandoned tickets
are counted in ``profiler.collectives``; each completion lands a
``collective`` span (lane ``queue``) in ``profiler.events``.

``chaos`` (a ``runtime.chaos.FaultPlan``) fires at the two host-visible
points, as in the JAX package: ``queue.issue`` before the launch (a hang,
slowdown, exception or preemption; a corruption damages the issued
arguments) and ``queue.wait`` before the wait (a corruption damages the
waited result).  A ticket abandoned by recovery fires nothing and records
nothing: a timed-out attempt that wakes later must not take the live
run's specs.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Deque, Dict, List, Optional

import torch

from ..utils.config import CollectiveConfig
from ..utils.observability import Profiler


@dataclass
class Ticket:
    """A completion handle: the result (pending on the card until waited
    for), the issue time and the event that marks it done."""
    uid: int
    result: Any
    issued_at: float
    waited: bool = False
    ready_at: Optional[float] = None
    abandoned: bool = False          # dropped by recovery; never consumed
    raw_bytes: int = 0
    wire_bytes: int = 0
    event: Optional[torch.cuda.Event] = None


def _tensors(tree: Any) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


class CollectiveQueue:
    """Bounded-window issue queue over a collective ``fn(*args) -> result``
    (tensors, or tuples and dicts of them)."""

    def __init__(self, fn: Callable, coll: CollectiveConfig,
                 profiler: Optional[Profiler] = None,
                 chaos: Optional[Any] = None) -> None:
        self.fn = fn
        self.chaos = chaos
        self.coll = coll
        self.profiler = profiler or Profiler()
        self.max_outstanding = 0
        self._inflight: Deque[Ticket] = deque()
        self._uid = 0
        # bumped by abandon(): an issue() that straddles a recovery marks
        # its own ticket abandoned instead of enqueueing it
        self._epoch = 0
        self._lock = threading.Lock()
        self._streams: Dict[torch.device, torch.cuda.Stream] = {}

    def _side(self, device: torch.device) -> torch.cuda.Stream:
        # under the lock: a watchdog worker's issue and the main thread's
        # may both make the device's first side stream
        with self._lock:
            if device not in self._streams:
                self._streams[device] = torch.cuda.Stream(device)
            return self._streams[device]

    def _launch(self, args: tuple):
        """``(result, event)``: the collective on the side stream of the
        inputs' card (steps 1-4 of the module docstring), or run at once
        on the CPU (no event)."""
        ins = _tensors(args)
        cuda = [t for t in ins if t.is_cuda]
        if not cuda:
            return self.fn(*args), None
        dev = cuda[0].device
        main = torch.cuda.current_stream(dev)
        side = self._side(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            result = self.fn(*args)
            event = torch.cuda.Event()
            event.record(side)
        for t in cuda:
            t.record_stream(side)
        for t in _tensors(result):
            if t.is_cuda:
                t.record_stream(main)
        return result, event

    # -- the reference ABI ----------------------------------------------------

    def issue(self, *args: Any, raw_bytes: int = 0,
              wire_bytes: int = 0) -> Ticket:
        with self._lock:
            epoch = self._epoch
        while True:
            with self._lock:
                if (epoch != self._epoch
                        or len(self._inflight) < self.coll.max_inflight):
                    break
                head = self._inflight[0]
            self.wait(head)                       # the window is full
        if self.chaos is not None and epoch == self._epoch:
            self.chaos.fire("queue.issue")        # may sleep or raise
        with self._lock:
            alive = epoch == self._epoch
        if not alive:
            # recovery abandoned the window while this issue waited
            self.profiler.collectives.record_abandoned()
            return Ticket(0, None, time.perf_counter(), abandoned=True)
        if self.chaos is not None:
            args = self.chaos.corrupt("queue.issue", args)
        result, event = self._launch(args)
        t = Ticket(0, result, time.perf_counter(), raw_bytes=raw_bytes,
                   wire_bytes=wire_bytes or raw_bytes, event=event)
        with self._lock:
            if epoch != self._epoch:     # abandoned during the launch
                t.abandoned = True
                self.profiler.collectives.record_abandoned()
                return t
            self._uid += 1
            t.uid = self._uid
            self._inflight.append(t)
            self.max_outstanding = max(self.max_outstanding,
                                       len(self._inflight))
        self.profiler.collectives.record_issue(raw_bytes, wire_bytes)
        self.profiler.events.instant("queue.issue", uid=t.uid,
                                     wire_bytes=t.wire_bytes)
        return t

    def wait(self, ticket: Ticket) -> Any:
        if ticket.waited:
            return ticket.result
        if ticket.abandoned:
            ticket.waited = True
            return ticket.result
        if self.chaos is not None:
            self.chaos.fire("queue.wait")
        t0 = time.perf_counter()
        if ticket.event is not None:
            ticket.event.synchronize()
            dev = next(t.device for t in _tensors(ticket.result)
                       if t.is_cuda)
            torch.cuda.current_stream(dev).wait_event(ticket.event)
        with self._lock:
            if ticket.abandoned:
                ticket.waited = True
                return ticket.result
            try:
                self._inflight.remove(ticket)
            except ValueError:
                pass
        if self.chaos is not None:
            # the waited result is what the caller consumes
            ticket.result = self.chaos.corrupt("queue.wait", ticket.result)
        now = time.perf_counter()
        ticket.waited = True
        ticket.ready_at = now
        latency = now - ticket.issued_at
        stall = now - t0                          # blocked in wait()
        overlap = t0 - ticket.issued_at           # issue -> wait gap
        self.profiler.collectives.record_completion(latency, stall, overlap)
        self.profiler.events.emit(
            "span", "collective", t_ns=int(ticket.issued_at * 1e9),
            dur_ns=int(latency * 1e9),
            attrs={"lane": "queue", "uid": ticket.uid,
                   "stall_s": round(stall, 6),
                   "overlap_s": round(overlap, 6),
                   "wire_bytes": ticket.wire_bytes,
                   "raw_bytes": ticket.raw_bytes})
        return ticket.result

    def wait_all(self) -> None:
        while True:
            with self._lock:
                if not self._inflight:
                    return
                head = self._inflight[0]
            self.wait(head)

    def abandon(self) -> int:
        """Drop every inflight ticket without waiting (the recovery path
        after a detected hang); their results are never consumed.
        Returns the count."""
        with self._lock:
            self._epoch += 1
            n = len(self._inflight)
            for t in self._inflight:
                t.abandoned = True
            self._inflight.clear()
        if n:
            self.profiler.collectives.record_abandoned(n)
            self.profiler.events.instant("queue.abandon", dropped=n)
        return n

    @property
    def outstanding(self) -> int:
        return len(self._inflight)
