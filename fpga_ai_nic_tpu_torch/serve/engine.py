"""Serving engine — continuous batching over the paged decode path; the
port of the JAX package's ``serve/engine.py``.

The host loop runs discrete TICKS.  Each tick the scheduler
(``scheduler.ContinuousBatcher``) decides which requests occupy the static
decode slots and where their KV pages live; then at most two device steps
run — one prefill chunk (``[1, prefill_chunk]`` tokens of the oldest
prefilling request) and one decode step (``[max_reqs, 1]`` tokens, every
decoding slot, empty slots masked), both through
``llama_decode.forward_paged``, whose attention is the paged gather-attend
kernel on the card.  PyTorch runs eagerly: there is no traced program.
``trace_counts()`` reads 1 for a step the engine has run and 0 for one it
has not (what JAX's counted jit reads after warm-up).
``recompiles_steady()`` is 0 by construction: nothing is traced, and each
kernel source is built and loaded once a process (``ops._build``), so no
tick, kill or scale event can compile again.

Roles (the fleet's disaggregation, ``serve.fleet``): a ``"prefill"``
replica admits and prefills but never decodes; a ``"decode"`` replica
admits nothing and decodes only requests the fleet hands it with their KV
pages (``ContinuousBatcher.adopt``); ``"both"`` does all of it.
``record_landed_pages`` and ``ledger_entries`` keep the page ledger
through a migration.

Two guards gate a tick before any of its tokens reach a stream: the exact
per-page checksum ledger (``ServeConfig.page_integrity``: each step
verifies its input pool against the ledger the previous step recorded,
then records its output pool's) and the logit guard (non-finite or
oversized logits).  A tripped guard, or any error of the tick, goes to
replay-tier recovery: a fresh pool and allocator, every live request
requeued with its generated tokens kept, and re-admission replays them as
ordinary prefill — greedy decoding makes the continuation token-exact.
Every recovery is counted (``summary()["recovery"]``), so a caller that
must not see one can check.

Faults inside the tick (JAX's ``serve/engine.py``): ``chaos`` (a
``runtime.chaos.FaultPlan``) fires at ``serve.step`` once a tick, inside
its device work (a hang or slowdown sleeps, an exception or preemption
raises, a corruption damages a copy of the tick's pool: the page ledger
or the logit guard must catch it before a token is emitted), and
``ServeConfig.step_timeout_s`` bounds each tick's device work with a
``runtime.watchdog.Watchdog`` (the tick synchronises on its results
inside the bound).  The pool is written in place by the steps, so the
tick's closure takes the pool, the ledger, the page table and the
requests' positions on the engine thread before the worker starts: a
timed-out tick that wakes after recovery writes only into the abandoned
pool, and ``_recover`` allocates a new one (never zeroing the old one in
place).  ``join_watchdog`` waits for such ticks.

``tp_mesh`` (JAX's tensor-parallel ticks): the tp ranks of one replica,
virtual ranks on its card (a tp-only ``VirtualRanks`` or a
``MeshConfig(tp=n)``).  The params are split by ``llama.param_specs``
into the tp ranks' trees, the pool holds every rank's kv heads
(``kv_local_heads(cfg, tp) * tp``: JAX's global pool, sharded on that
axis) and both steps run ``forward_paged(..., tp_axis="tp")``, whose
logits are gathered over tp, so the argmax is over the same rows as at
tp = 1.  ``page_integrity`` with tp raises JAX's ``ValueError``.
"""

from __future__ import annotations

import math
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models import llama, llama_decode
from ..models.llama import LlamaConfig, Params
from ..obs.metrics import RequestSpans
from ..ops import integrity as integrity_lib
from ..runtime import chaos as chaos_lib
from ..runtime.requests import DECODE, Request, RequestQueue, ServeStats
from ..parallel.mesh import VirtualRanks
from ..runtime.watchdog import DeviceHangError, Watchdog
from ..utils.config import MeshConfig
from ..utils.observability import Profiler
from .paged import (PageAllocator, ServeConfig, contiguous_cache_bytes,
                    init_pool, page_table_bytes, pool_bytes)
from .scheduler import ContinuousBatcher

__all__ = ["ServeEngine"]

Pool = List[Dict[str, torch.Tensor]]
PrefillWork = Tuple[Request, int, int]
StepOut = Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor],
                Optional[torch.Tensor]]


def _tp_extent(tp_mesh: Any) -> int:
    """The tp ranks of ``tp_mesh``: None (one), a ``VirtualRanks`` or a
    ``MeshConfig`` whose other axes are all 1."""
    if tp_mesh is None:
        return 1
    if isinstance(tp_mesh, VirtualRanks):
        others = (tp_mesh.n, tp_mesh.sp, tp_mesh.ep, tp_mesh.pp)
    elif isinstance(tp_mesh, MeshConfig):
        others = tuple(k for name, k in tp_mesh.axis_sizes() if name != "tp")
    else:
        raise TypeError(f"tp_mesh must be a VirtualRanks or a MeshConfig "
                        f"of tp ranks, got {type(tp_mesh).__name__}")
    if any(k != 1 for k in others):
        raise ValueError(f"tp_mesh must hold tp ranks only: {tp_mesh}")
    return tp_mesh.tp


def _params_to(params: Any, dev: torch.device) -> Any:
    """The tree (dicts and lists, a MoE layer's ``"moe"`` dict too) on
    ``dev``."""
    if isinstance(params, dict):
        return {k: _params_to(v, dev) for k, v in params.items()}
    if isinstance(params, list):
        return [_params_to(v, dev) for v in params]
    return params.to(dev)


class ServeEngine:
    """Continuous-batching inference engine over ``forward_paged``.

    Greedy (argmax) sampling: determinism is what makes eviction replay
    and recovery token-exact.  Single-threaded host loop (a tick's device
    work runs on the watchdog's worker with ``step_timeout_s``);
    ``runtime.requests`` holds the thread-safe seams (intake, stats)."""

    def __init__(self, params: Params, cfg: LlamaConfig, scfg: ServeConfig,
                 *, profiler: Optional[Profiler] = None,
                 chaos: Optional[Any] = None,
                 dtype: Optional[str] = None,
                 device: DeviceLike = "cuda",
                 replica_id: int = 0,
                 role: str = "both",
                 tp_mesh: Optional[Any] = None,
                 attend_impl: str = "kernel") -> None:
        if role not in ("both", "prefill", "decode"):
            raise ValueError(f"role must be both|prefill|decode: {role!r}")
        if attend_impl not in llama_decode.ATTEND_IMPLS:
            raise ValueError(f"attend_impl must be one of "
                             f"{llama_decode.ATTEND_IMPLS}: {attend_impl!r}")
        self.tp_size = _tp_extent(tp_mesh)
        llama._shard_counts(cfg, self.tp_size)      # JAX's tp errors
        if tp_mesh is not None and scfg.page_integrity:
            # the checksum ledger is over the GLOBAL pool; JAX's tp tick
            # sees only its kv shard and refuses the pair
            raise ValueError(
                "page_integrity is not supported with a tp-sharded tick "
                "(the page-checksum ledger is global; shards see only "
                "their kv slice)")
        self.device = resolve_device(getattr(tp_mesh, "device", device))
        self.replica_id = int(replica_id)
        self.role = role
        self.attend_impl = attend_impl
        self.tp_mesh = tp_mesh
        self._tp_axis = "tp" if self.tp_size > 1 else None
        self.params = _params_to(params, self.device)
        if self.tp_size > 1:
            self.params = llama.shard_params(
                self.params, llama.param_specs(cfg, "tp", None,
                                               self.tp_size),
                {"tp": self.tp_size})
        self.cfg = cfg
        self.scfg = scfg
        self.dtype = dtype
        self.profiler = profiler or Profiler()
        self.stats = ServeStats()
        self.queue = RequestQueue(events=self.profiler.events,
                                  stats=self.stats)
        self.spans = RequestSpans(self.profiler.events)
        self.chaos = chaos
        self.watchdog = (Watchdog(scfg.step_timeout_s)
                         if scfg.step_timeout_s is not None else None)
        self.alloc = PageAllocator(scfg.n_pages)
        self.batcher = ContinuousBatcher(scfg, self.alloc, stats=self.stats)
        self.pool: Pool = self._fresh_pool()
        # exact per-page checksum ledger: what the last step computed over
        # its OUTPUT pool; the next step verifies its input against it.  A
        # zero pool checksums to all zeros, so a fresh ledger is zeros.
        self.ledger = self._fresh_ledger()
        self.ticks = 0
        self._wall_s = 0.0
        self._consec_failures = 0
        self._pages_peak = 0         # survives allocator rebuilds
        self.page_trips = 0          # exact-tier (page checksum) trips
        self.logit_trips = 0         # magnitude-tier (logit guard) trips
        self.prefill_calls = 0       # forward_paged calls, by kind
        self.decode_calls = 0
        self.prefill_tokens = 0      # true (unpadded) prompt tokens run

    def _fresh_pool(self) -> Pool:
        return init_pool(self.cfg, self.scfg, dtype=self.dtype,
                         device=self.device, tp_size=self.tp_size)

    def _fresh_ledger(self) -> Optional[torch.Tensor]:
        if not self.scfg.page_integrity:
            return None
        return torch.zeros((self.scfg.n_pages,), dtype=torch.int64,
                           device=self.device)

    def record_landed_pages(self, pages: Sequence[int],
                            checksums: Any) -> None:
        """Ledger entries for pages written outside the engine's steps: a
        KV migration lands page blocks directly into the pool, and the
        destination records their checksums, or its next step's input
        check would trip on the migration.  Called for a rejected landing
        too: those pages stay free and dirty, and a dirty page must still
        agree with the ledger."""
        if self.ledger is None:
            return
        idx = torch.as_tensor(np.asarray(pages, np.int64),
                              device=self.device)
        self.ledger[idx] = torch.as_tensor(
            np.asarray(checksums, np.uint32).astype(np.int64),
            device=self.device)

    def ledger_entries(self, pages: Sequence[int]) -> np.ndarray:
        """uint32 ``[len(pages)]``: the ledger's write-time checksums of
        ``pages`` (what a migration's landed bytes must still hash to)."""
        assert self.ledger is not None, "page_integrity is off"
        return self.ledger.cpu().numpy()[
            np.asarray(pages, np.int64)].astype(np.uint32)

    # -- the two device steps (shapes fixed by ServeConfig) ------------------

    def _logit_guard(self, logits: torch.Tensor) -> torch.Tensor:
        """True when this step's logits are non-finite or past the garbage
        magnitude bound."""
        bad = ~torch.isfinite(logits).all()
        if self.scfg.logit_guard_abs is not None:
            bad = bad | (logits.abs().max().to(torch.float32)
                         > self.scfg.logit_guard_abs)
        return bad

    def _page_check(self, pool: Pool,
                    ledger: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """Number of pool pages whose exact checksum differs from the
        ledger: their bytes changed outside the ledger-keeping steps."""
        if ledger is None:
            return None
        got = integrity_lib.page_checksums(pool)
        return (got != ledger).sum()

    def _decode_step(self, pool: Pool, tokens: torch.Tensor,
                     table: torch.Tensor, pos: torch.Tensor,
                     active: torch.Tensor,
                     ledger: Optional[torch.Tensor]) -> StepOut:
        bad_pages = self._page_check(pool, ledger)
        logits, pool = llama_decode.forward_paged(
            self.params, tokens, pool, table, pos, self.cfg,
            page_size=self.scfg.page_size, tp_axis=self._tp_axis,
            active=active, attend_impl=self.attend_impl)
        toks = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        new_ledger = (None if ledger is None
                      else integrity_lib.page_checksums(pool))
        return toks, self._logit_guard(logits), bad_pages, new_ledger

    def _prefill_step(self, pool: Pool, tokens: torch.Tensor,
                      row: torch.Tensor, pos0: torch.Tensor, last: int,
                      ledger: Optional[torch.Tensor]) -> StepOut:
        bad_pages = self._page_check(pool, ledger)
        logits, pool = llama_decode.forward_paged(
            self.params, tokens, pool, row, pos0, self.cfg,
            page_size=self.scfg.page_size, tp_axis=self._tp_axis,
            attend_impl=self.attend_impl)
        # the continuation at the chunk's last TRUE token — consumed only
        # when this chunk completes a fresh prefill
        nxt = torch.argmax(logits[0, last], dim=-1).to(torch.int32)
        new_ledger = (None if ledger is None
                      else integrity_lib.page_checksums(pool))
        return nxt, self._logit_guard(logits), bad_pages, new_ledger

    # -- intake --------------------------------------------------------------

    def submit(self, prompt: np.ndarray, max_new: int, *,
               eos_id: Optional[int] = None,
               not_before_s: float = 0.0) -> Request:
        """Validate against the static budget, then queue (thread-safe)."""
        p = np.asarray(prompt, np.int32).reshape(-1)
        self.batcher.validate_shape(int(p.shape[0]), int(max_new))
        return self.queue.submit(p, max_new, eos_id=eos_id,
                                 not_before_s=not_before_s)

    # -- the loop ------------------------------------------------------------

    def run(self, *, max_ticks: int = 1_000_000) -> Dict[str, Any]:
        """Serve until every submitted request finishes; returns
        ``summary()``."""
        t0 = time.perf_counter()
        while (self.queue.pending or self.batcher.waiting
               or self.batcher.live):
            if self.ticks >= max_ticks:
                raise RuntimeError(
                    f"serve loop exceeded max_ticks={max_ticks} with "
                    f"{len(self.batcher.live)} live / "
                    f"{len(self.batcher.waiting)} waiting requests")
            if not self._tick():
                wait = self.queue.next_arrival_in()
                time.sleep(min(0.01, wait if wait is not None else 0.001))
        self._wall_s += time.perf_counter() - t0
        return self.summary()

    def tick(self) -> bool:
        """One public engine tick (``run()`` loops this)."""
        return self._tick()

    def _tick(self) -> bool:
        for req in self.queue.pop_arrived():
            self.batcher.enqueue(req)
        now = time.perf_counter()
        if self.role != "decode":
            # a decode replica takes work only through the fleet's KV
            # handoff (batcher.adopt); its waiting list holds evictions,
            # which the fleet replays through a prefill replica
            for req in self.batcher.admit():
                self.stats.record_admitted()
                if math.isnan(req.t_admit):
                    req.t_admit = now
        # decode first, then prefill: prefill's page demand may evict the
        # NEWEST decoder, so the batch is re-filtered before dispatch
        dec = self.batcher.decode_batch() if self.role != "prefill" else []
        pre = (self.batcher.prefill_work()
               if self.role != "decode" else None)
        dec = [r for r in dec if r.state == DECODE and r.slot >= 0]
        if pre is None and not dec:
            return False
        with self.profiler.events.span("serve.tick", lane="serve",
                                       replica=self.replica_id,
                                       n_decode=len(dec),
                                       prefill=pre is not None):
            try:
                pool, out = self._device_tick(pre, dec)
            except Exception as err:  # noqa: BLE001 — the recovery boundary
                self._recover(err)
                return True
        self.pool = pool
        # the step counters are the engine thread's: taken here, where the
        # tick's result is, so a timed-out tick's worker writes none
        if pre is not None:
            self.prefill_calls += 1
            self.prefill_tokens += pre[2]
        if dec:
            self.decode_calls += 1
        if self.ledger is not None and out.get("ledger") is not None:
            self.ledger = out["ledger"]
        self._consec_failures = 0
        self._apply(pre, dec, out)
        self.profiler.events.counter("serve.pages_in_use",
                                     self.alloc.in_use,
                                     replica=self.replica_id)
        self.ticks += 1
        return True

    def _device_tick(self, pre: Optional[PrefillWork], dec: List[Request]
                     ) -> Tuple[Pool, Dict[str, Any]]:
        """All device work of one tick as a closure the watchdog can bound:
        ``(pool, out)``.  Everything the closure reads of the engine (the
        pool, the ledger, the page table, the requests' slots, tokens and
        positions, the tick number) is taken here, on the engine thread,
        before the worker starts, so a timed-out tick that wakes after
        ``_recover`` runs against the abandoned pool, never the new one."""
        scfg = self.scfg
        dev = self.device
        table_np = self.batcher.table.copy()
        pool_in, ledger_in, tick = self.pool, self.ledger, self.ticks
        pre_snap: Optional[Tuple[np.ndarray, int, int, int, int]] = None
        if pre is not None:
            req, start, n_true = pre
            full = np.concatenate(
                [req.prompt, np.asarray(req.generated, np.int32)])
            pre_tokens = np.zeros((1, scfg.prefill_chunk), np.int32)
            pre_tokens[0, :n_true] = full[start:start + n_true]
            final = start + n_true >= req.replay_len
            last = (req.replay_len - 1 - start) if final else 0
            pre_snap = (pre_tokens, req.slot, start, last, n_true)
        dec_snap = [(r.slot, r.generated[-1], r.n_tokens) for r in dec]

        def work() -> Tuple[Pool, Dict[str, Any]]:
            pool, ledger = pool_in, ledger_in
            if self.chaos is not None:
                self.chaos.begin_step(tick)
                self.chaos.fire("serve.step")      # may sleep or raise
                # a corruption spec damages a copy of the tick's pool: the
                # ledger or the logit guard must catch it before emission
                pool = self.chaos.corrupt("serve.step", pool)
            table = torch.from_numpy(table_np).to(dev)
            out: Dict[str, Any] = {}
            corrupted = False
            bad_pages = 0
            if pre_snap is not None:
                pre_tokens, slot, start, last, n_true = pre_snap
                tok, bad, nbad, ledger = self._prefill_step(
                    pool, torch.from_numpy(pre_tokens).to(dev),
                    table[slot:slot + 1].contiguous(),
                    torch.tensor([start], dtype=torch.int32, device=dev),
                    last, ledger)
                if nbad is not None:
                    bad_pages += int(nbad)                 # waits
                out["prefill_tok"] = int(tok)              # waits
                corrupted |= bool(bad)
            if dec_snap:
                R = scfg.max_reqs
                toks = np.zeros((R, 1), np.int32)
                pos = np.zeros((R,), np.int32)
                act = np.zeros((R,), bool)
                for slot, tok_in, n_tok in dec_snap:
                    toks[slot, 0] = tok_in
                    pos[slot] = n_tok
                    act[slot] = True
                ntok, bad, nbad, ledger = self._decode_step(
                    pool, torch.from_numpy(toks).to(dev), table,
                    torch.from_numpy(pos).to(dev),
                    torch.from_numpy(act).to(dev), ledger)
                if nbad is not None:
                    bad_pages += int(nbad)                 # waits
                out["decode_toks"] = ntok.cpu().numpy()    # waits
                corrupted |= bool(bad)
            if bad_pages:
                # the EXACT tier tripped first: some page's bytes changed
                # outside the ledger-keeping steps — gated before _apply,
                # so no poisoned token was emitted
                raise chaos_lib.WireIntegrityError(
                    f"serve tick {tick}: {bad_pages} KV pool page(s) "
                    "failed their exact checksum against the write-time "
                    "ledger")
            if corrupted:
                raise chaos_lib.IntegrityError(
                    f"serve tick {tick} produced non-finite/garbage "
                    "logits — gated before emission")
            out["ledger"] = ledger
            return pool, out

        if self.watchdog is not None:
            return self.watchdog.run(work)
        return work()

    def join_watchdog(self, timeout_s: float = 60.0) -> int:
        """Wait for every timed-out tick's thread (``Watchdog.join``);
        returns how many still run (0 without ``step_timeout_s``)."""
        return 0 if self.watchdog is None else self.watchdog.join(timeout_s)

    def _apply(self, pre: Optional[PrefillWork], dec: List[Request],
               out: Dict[str, Any]) -> None:
        now = time.perf_counter()
        if pre is not None:
            req, start, n_true = pre
            req.prefill_done = start + n_true
            if req.prefill_done >= req.replay_len:
                req.state = DECODE
                if not req.generated:
                    # fresh prefill: the chunk's sample IS the first new
                    # token; a replay re-derives generated[-1] instead
                    self._append_token(req, int(out["prefill_tok"]), now)
        if dec:
            toks = out["decode_toks"]
            for r in dec:
                self._append_token(r, int(toks[r.slot]), now)

    def _append_token(self, req: Request, tok: int, now: float) -> None:
        req.generated.append(tok)
        if math.isnan(req.t_first):
            req.t_first = now
            self.profiler.events.instant("serve.first_token", uid=req.uid)
        if (len(req.generated) >= req.max_new
                or (req.eos_id is not None and tok == req.eos_id)):
            req.t_done = now
            self.batcher.finish(req)
            self.stats.record_completed(len(req.generated))
            self.spans.record(req.uid, t_submit=req.t_submit,
                              t_admit=req.t_admit, t_first=req.t_first,
                              t_done=req.t_done,
                              n_tokens=len(req.generated))

    # -- recovery ------------------------------------------------------------

    def _recover(self, err: Exception) -> None:
        """Replay-tier recovery: fresh pool + allocator, every live request
        requeued with generated tokens kept.  MTTR = detection -> engine
        serviceable."""
        self._consec_failures += 1
        if self._consec_failures > self.scfg.max_retries:
            raise err
        if isinstance(err, chaos_lib.InjectedPreemption):
            kind = "preemption"
        elif isinstance(err, DeviceHangError):
            kind = "hang"
        elif isinstance(err, chaos_lib.WireIntegrityError):
            kind = "wire-corruption"
            self.page_trips += 1
        elif isinstance(err, chaos_lib.IntegrityError):
            kind = "corruption"
            self.logit_trips += 1
        else:
            kind = getattr(err, "kind", type(err).__name__)
        ev = self.profiler.recovery.record_fault(
            kind, step=self.ticks, site="serve.step", error=repr(err))
        t0 = time.perf_counter()
        self._pages_peak = max(self._pages_peak, self.alloc.peak_in_use)
        self.batcher.release_all()
        self.alloc = PageAllocator(self.scfg.n_pages)
        self.batcher.rebind(self.alloc)
        # a new pool, never the old one zeroed in place: a timed-out tick
        # may still write into the old one
        self.pool = []
        self.pool = self._fresh_pool()
        self.ledger = self._fresh_ledger()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.profiler.recovery.record_recovery(
            time.perf_counter() - t0, event=ev)
        self.stats.record_recovery()
        self.profiler.events.instant("serve.recovered", tick=self.ticks,
                                     kind=kind)
        time.sleep(self.scfg.backoff_s * (2 ** (self._consec_failures - 1)))

    # -- introspection -------------------------------------------------------

    def trace_counts(self) -> Dict[str, int]:
        """1 for each step the engine has run, 0 for one it has not: what
        JAX's counted jit reads once warm (one trace a program)."""
        return {"prefill": int(self.prefill_calls > 0),
                "decode": int(self.decode_calls > 0)}

    def recompiles_steady(self) -> int:
        """JAX's count of retraces after warm-up; always 0 here: the port
        runs eagerly and loads each kernel source once a process."""
        return 0

    def obs_static_metrics(self) -> Dict[str, Any]:
        """Static serving facts; the byte accounting is exact."""
        scfg = self.scfg
        return {"serve": {
            "max_reqs": scfg.max_reqs,
            "page_size": scfg.page_size,
            "n_pages": scfg.n_pages,
            "max_pages_per_seq": scfg.max_pages_per_seq,
            "prefill_chunk": scfg.prefill_chunk,
            "page_table_bytes": page_table_bytes(scfg),
            "pool_bytes": pool_bytes(self.cfg, scfg, dtype=self.dtype,
                                     tp_size=self.tp_size),
            "contiguous_cache_bytes": contiguous_cache_bytes(
                self.cfg, scfg.max_reqs, scfg.max_seq, dtype=self.dtype),
        }}

    def summary(self) -> Dict[str, Any]:
        rec = self.profiler.recovery.as_dict()
        stats = self.stats.as_dict()
        wall = self._wall_s
        usable = self.scfg.usable_pages
        peak = max(self._pages_peak, self.alloc.peak_in_use)
        return {
            "replica_id": self.replica_id,
            "role": self.role,
            "attend_impl": self.attend_impl,
            "device": str(self.device),
            "ticks": self.ticks,
            "wall_s": round(wall, 4),
            **stats,
            "evictions": self.batcher.evictions,
            "prefill_calls": self.prefill_calls,
            "decode_calls": self.decode_calls,
            "prefill_tokens": self.prefill_tokens,
            "pages_in_use_peak": peak,
            "page_util_peak": round(peak / usable, 4),
            "throughput_tok_s": (round(stats["tokens_out"] / wall, 2)
                                 if wall > 0 else None),
            "trace_counts": self.trace_counts(),
            "recompiles_steady": self.recompiles_steady(),
            "page_integrity": bool(self.scfg.page_integrity),
            "page_trips": self.page_trips,
            "logit_trips": self.logit_trips,
            "requests": self.spans.summary(),
            "recovery": {"faults": rec["faults"],
                         "recoveries": rec["recoveries"],
                         "mttr_mean_s": rec["mttr_mean_s"]},
            **self.obs_static_metrics(),
        }
