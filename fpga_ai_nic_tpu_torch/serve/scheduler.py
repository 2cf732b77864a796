"""Continuous-batching scheduler — host policy over the paged pool; the
port of the JAX package's ``serve/scheduler.py``.

Per engine tick the batcher decides WHICH requests occupy the static
decode slots and WHERE their KV pages live; the device step then runs
with those decisions as plain tensor values.  Policies (all deterministic,
so a seeded serving run replays exactly):

  - **Admission**: FIFO from the waiting queue whenever a slot is free
    and the free-page watermark covers the request's current replay
    length + 1 (enough to prefill and take the first decode step without
    immediately thrashing).  Page allocation itself is LAZY — pages are
    claimed as positions advance, so a short completion hands capacity
    to the next request mid-prefill.
  - **Chunked prefill**: one static-width chunk per tick (oldest PREFILL
    request first), interleaved with the decode batch — a long prompt
    never stalls every decoding request for its whole prefill, only by
    one chunk's latency (the Sarathi/vLLM discipline).
  - **Eviction**: when a page is needed and the pool is dry, the
    NEWEST-admitted other live request is evicted — pages freed, request
    requeued at the FRONT of the waiting queue with its generated tokens
    kept host-side.  Re-admission replays prompt + generated[:-1] as a
    prefill (greedy decode is deterministic, so the continuation is
    token-identical).  LIFO victims bound
    eviction cascades: the oldest request monotonically progresses, so
    any workload whose single worst request fits the pool terminates.

Submission validates that a request's WORST-CASE footprint
(prompt + max_new) fits both one page-table row and the usable pool, so
a lone request can always run to completion — the no-deadlock base case
the eviction policy leans on.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

import numpy as np

from ..runtime.requests import (DECODE, FINISHED, PREFILL, WAITING,
                                Request)
# ONE definition of every discrete scheduling decision (the port's copy
# of the JAX package's rules, held equal to them by test)
from .sched_rules import SCHED_RULES as _RULES
from .paged import NULL_PAGE, PageAllocator, ServeConfig

__all__ = ["ContinuousBatcher"]


class ContinuousBatcher:
    """Slot/page bookkeeping + the admit/evict/interleave policy.

    Single-threaded by contract (the engine loop); the cross-thread
    intake is `runtime.requests.RequestQueue`."""

    def __init__(self, scfg: ServeConfig, alloc: PageAllocator,
                 stats: Optional[Any] = None) -> None:
        self.scfg = scfg
        self.alloc = alloc
        self._stats = stats          # runtime.requests.ServeStats or None
        # the static page table the device step consumes (int32, shape
        # [max_reqs, max_pages_per_seq], host numpy); NULL_PAGE marks
        # unallocated
        self.table = np.full((scfg.max_reqs, scfg.max_pages_per_seq),
                             NULL_PAGE, np.int32)
        self._pages: List[List[int]] = [[] for _ in range(scfg.max_reqs)]
        self.slots: List[Optional[Request]] = [None] * scfg.max_reqs
        self.waiting: List[Request] = []
        self.evictions = 0
        self._admit_seq = 0

    # -- intake --------------------------------------------------------------

    def validate_shape(self, prompt_len: int, max_new: int) -> None:
        """Reject requests that could never run alone (the eviction
        policy's termination argument needs every accepted request to fit
        the pool by itself)."""
        worst = prompt_len + max_new
        if worst > self.scfg.max_seq:
            raise ValueError(
                f"prompt {prompt_len} + max_new {max_new} = {worst} "
                f"exceeds max_seq {self.scfg.max_seq} "
                "(= max_pages_per_seq * page_size)")
        if self.scfg.pages_for(worst) > self.scfg.usable_pages:
            raise ValueError(
                f"worst case needs {self.scfg.pages_for(worst)} pages "
                f"but the pool holds {self.scfg.usable_pages} usable "
                "pages")

    def enqueue(self, req: Request, *, front: bool = False) -> None:
        self.validate_shape(req.prompt_len, req.max_new)
        req.state = WAITING
        req.slot = -1
        req.prefill_done = 0
        # replay target: every position the cache must hold before decode
        # can resume (prompt + all generated but the newest, whose K/V
        # the resuming decode step writes itself)
        req.replay_len = _RULES.replay_target(req.n_tokens)
        if front:
            self.waiting.insert(0, req)
        else:
            self.waiting.append(req)

    # -- admission -----------------------------------------------------------

    def _committed_outstanding(self) -> int:
        """Pages already PROMISED to live requests but not yet allocated
        (allocation is lazy): a prefilling request will claim up to
        replay_len + 1 positions' worth, a decoding one its next
        position.  The admission watermark subtracts this so a newly
        admitted request cannot immediately force an eviction storm."""
        return _RULES.committed_outstanding(
            [(self.scfg.pages_for(
                _RULES.committed_target(r.state, r.replay_len,
                                        r.n_tokens)),
              len(self._pages[r.slot]))
             for r in self.slots if r is not None])

    def admit(self) -> List[Request]:
        """Admit waiting requests into free slots while the free-page
        watermark holds; returns the newly admitted set (telemetry)."""
        out: List[Request] = []
        while self.waiting:
            slot = next((i for i, r in enumerate(self.slots) if r is None),
                        None)
            if slot is None:
                break
            req = self.waiting[0]
            need = self.scfg.pages_for(
                _RULES.admission_need(req.replay_len))
            if not _RULES.admit_ok(self.alloc.free,
                                   self._committed_outstanding(), need):
                break                     # watermark: avoid admit-thrash
            self.waiting.pop(0)
            req.slot = slot
            req.state = PREFILL
            self._admit_seq += 1
            req.admit_seq = self._admit_seq
            self.slots[slot] = req
            out.append(req)
        return out

    # -- pages ---------------------------------------------------------------

    def ensure_pages(self, req: Request, n_positions: int) -> bool:
        """Grow ``req``'s page set to cover ``n_positions``, evicting
        newer requests if the pool is dry.  False = cannot proceed this
        tick (every evictable victim is older, or req is alone)."""
        slot = req.slot
        need = self.scfg.pages_for(n_positions)
        if need > self.scfg.max_pages_per_seq:
            raise ValueError(
                f"request {req.uid} needs {need} pages > table width "
                f"{self.scfg.max_pages_per_seq}")
        while len(self._pages[slot]) < need:
            got = self.alloc.alloc(1)
            if got is None:
                victim = self._eviction_victim(req)
                if victim is None:
                    return False
                self.evict(victim)
                continue
            self.table[slot, len(self._pages[slot])] = got[0]
            self._pages[slot].append(got[0])
        return True

    def _eviction_victim(self, protect: Request) -> Optional[Request]:
        """Newest-admitted live request other than ``protect`` that holds
        at least one reclaimable page."""
        live = [r for r in self.slots
                if r is not None and r is not protect
                and self._pages[r.slot]]
        pos = _RULES.pick_victim([r.admit_seq for r in live])
        return None if pos is None else live[pos]

    def evict(self, req: Request) -> None:
        """Free the request's pages and requeue it (front — evicted work
        has priority) with its generated tokens kept for replay."""
        self._release_slot(req)
        req.evictions += 1
        self.evictions += 1
        if self._stats is not None:
            self._stats.record_evicted()
        self.enqueue(req, front=True)

    def _release_slot(self, req: Request) -> None:
        slot = req.slot
        if self._pages[slot]:
            self.alloc.free_pages(self._pages[slot])
            self._pages[slot] = []
        self.table[slot, :] = NULL_PAGE
        self.slots[slot] = None
        req.slot = -1

    def finish(self, req: Request) -> None:
        self._release_slot(req)
        req.state = FINISHED

    # -- KV handoff (a fleet's migration path) -------------------------------

    @property
    def free_slots(self) -> int:
        return sum(1 for r in self.slots if r is None)

    def pages_of(self, req: Request) -> List[int]:
        """The page ids a live request currently owns (copy) — a fleet's
        migration set.  Empty for a slotless request."""
        if req.slot < 0:
            return []
        return list(self._pages[req.slot])

    def adopt(self, req: Request, pages: List[int], *,
              state: str = DECODE) -> Optional[int]:
        """Install a request DIRECTLY into a free slot with its KV pages
        already resident — a fleet's KV-handoff path: the pages were
        migrated from another replica's pool (same values, new page
        ids), so the request continues with ZERO replay.  ``pages`` must
        have been allocated from THIS batcher's allocator by the caller
        (accounting stays exact) and must cover every position the
        request's cache holds.  Returns the slot, or None with no free
        slot (caller keeps the request where it is)."""
        if len(pages) > self.scfg.max_pages_per_seq:
            raise ValueError(
                f"adopting {len(pages)} pages > table width "
                f"{self.scfg.max_pages_per_seq}")
        slot = next((i for i, r in enumerate(self.slots) if r is None),
                    None)
        if slot is None:
            return None
        self.table[slot, :] = NULL_PAGE
        self.table[slot, :len(pages)] = np.asarray(pages, np.int32)
        self._pages[slot] = list(pages)
        self.slots[slot] = req
        req.slot = slot
        req.state = state
        self._admit_seq += 1
        req.admit_seq = self._admit_seq
        return slot

    def release(self, req: Request) -> None:
        """Free the slot + pages WITHOUT requeueing — the handoff SOURCE
        side: the page bytes were already copied out by the transfer
        program, and dirty recycling makes the freed pages immediately
        reusable here."""
        self._release_slot(req)

    # -- per-tick work selection ---------------------------------------------

    def prefill_work(self) -> Optional[Tuple[Request, int, int]]:
        """(request, start, n_true) for this tick's prefill chunk — the
        oldest PREFILL request, one static-width chunk (n_true <= chunk
        is the unpadded token count).  None: nothing to prefill, or the
        pool is starved for it this tick."""
        cands = [r for r in self.slots
                 if r is not None and r.state == PREFILL]
        pos = _RULES.pick_oldest([r.admit_seq for r in cands])
        if pos is None:
            return None
        req = cands[pos]
        start = req.prefill_done
        n_true = _RULES.prefill_chunk_len(self.scfg.prefill_chunk,
                                          req.replay_len, start)
        if not self.ensure_pages(req, start + n_true):
            return None
        return req, start, n_true

    def decode_batch(self) -> List[Request]:
        """DECODE requests that can take a step this tick (oldest first;
        each needs one more position's page — may evict newer ones)."""
        out: List[Request] = []
        cands = [r for r in self.slots
                 if r is not None and r.state == DECODE]
        for pos in _RULES.decode_order([r.admit_seq for r in cands]):
            req = cands[pos]
            if req.state != DECODE:
                continue              # evicted by an older sibling above
            if self.ensure_pages(req, _RULES.committed_target(
                    req.state, req.replay_len, req.n_tokens)):
                out.append(req)
        return [r for r in out if r.state == DECODE]

    # -- recovery ------------------------------------------------------------

    def release_all(self) -> List[Request]:
        """Preemption recovery: every live request loses its slot/pages
        and requeues (submit order) for replay; returns the released
        set.  The allocator is expected to be REPLACED by the caller —
        pages freed here are never reused."""
        live = [r for r in self.slots if r is not None]
        for req in sorted(live, key=lambda r: r.uid):
            self._release_slot(req)
            self.enqueue(req)
        self.waiting.sort(key=lambda r: r.uid)
        return live

    def rebind(self, alloc: PageAllocator) -> None:
        """Point at a fresh allocator (post-preemption pool rebuild)."""
        self.alloc = alloc

    # -- introspection -------------------------------------------------------

    @property
    def live(self) -> List[Request]:
        return [r for r in self.slots if r is not None]

    def pages_in_use(self) -> int:
        return sum(len(p) for p in self._pages)
