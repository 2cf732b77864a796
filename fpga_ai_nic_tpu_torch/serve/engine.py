"""Serving engine — continuous batching over the paged decode path; the
port of the JAX package's ``serve/engine.py`` at its default role
``"both"``.

The host loop runs discrete TICKS.  Each tick the scheduler
(``scheduler.ContinuousBatcher``) decides which requests occupy the static
decode slots and where their KV pages live; then at most two device steps
run — one prefill chunk (``[1, prefill_chunk]`` tokens of the oldest
prefilling request) and one decode step (``[max_reqs, 1]`` tokens, every
decoding slot, empty slots masked), both through
``llama_decode.forward_paged``, whose attention is the paged gather-attend
kernel on the card.  PyTorch runs eagerly: there is no traced program, so
the JAX engine's trace counters have no counterpart here (CUDA graphs of
the two steps are later work).

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
from typing import Any, Dict, List, Optional, Tuple

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
from ..runtime.watchdog import DeviceHangError
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
    and recovery token-exact.  Single-threaded host loop;
    ``runtime.requests`` holds the thread-safe seams (intake, stats).

    Not ported yet, and refused at construction: roles other than
    ``"both"`` (the fleet's prefill/decode split and KV handoff, ROADMAP
    A.7), ``chaos`` (fault injection, A.8) and
    ``ServeConfig.step_timeout_s`` (the watchdog, A.8)."""

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
        if role != "both":
            raise NotImplementedError(
                f"role={role!r} (the fleet's prefill/decode split) waits for "
                "ROADMAP A.7")
        if chaos is not None:
            raise NotImplementedError(
                "chaos (fault injection) waits for ROADMAP A.8")
        if scfg.step_timeout_s is not None:
            raise NotImplementedError(
                "ServeConfig.step_timeout_s (the watchdog) waits for "
                "ROADMAP A.8")
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
        self.decode_calls += 1
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
        self.prefill_calls += 1
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
        for req in self.batcher.admit():
            self.stats.record_admitted()
            if math.isnan(req.t_admit):
                req.t_admit = now
        # decode first, then prefill: prefill's page demand may evict the
        # NEWEST decoder, so the batch is re-filtered before dispatch
        dec = self.batcher.decode_batch()
        pre = self.batcher.prefill_work()
        dec = [r for r in dec if r.state == DECODE and r.slot >= 0]
        if pre is None and not dec:
            return False
        with self.profiler.events.span("serve.tick", lane="serve",
                                       replica=self.replica_id,
                                       n_decode=len(dec),
                                       prefill=pre is not None):
            try:
                out = self._device_tick(pre, dec)
            except Exception as err:  # noqa: BLE001 — the recovery boundary
                self._recover(err)
                return True
        if self.ledger is not None and out.get("ledger") is not None:
            self.ledger = out["ledger"]
        self._consec_failures = 0
        self._apply(pre, dec, out)
        self.profiler.events.counter("serve.pages_in_use",
                                     self.alloc.in_use,
                                     replica=self.replica_id)
        self.ticks += 1
        return True

    def _device_tick(self, pre: Optional[PrefillWork],
                     dec: List[Request]) -> Dict[str, Any]:
        """All device work of one tick.  The pool is updated in place;
        a tick that raises leaves it to ``_recover``, which replaces it."""
        scfg = self.scfg
        dev = self.device
        table = torch.from_numpy(self.batcher.table.copy()).to(dev)
        ledger = self.ledger
        out: Dict[str, Any] = {}
        corrupted = False
        bad_pages = 0
        if pre is not None:
            req, start, n_true = pre
            full = np.concatenate(
                [req.prompt, np.asarray(req.generated, np.int32)])
            pre_tokens = np.zeros((1, scfg.prefill_chunk), np.int32)
            pre_tokens[0, :n_true] = full[start:start + n_true]
            final = start + n_true >= req.replay_len
            last = (req.replay_len - 1 - start) if final else 0
            tok, bad, nbad, ledger = self._prefill_step(
                self.pool, torch.from_numpy(pre_tokens).to(dev),
                table[req.slot:req.slot + 1].contiguous(),
                torch.tensor([start], dtype=torch.int32, device=dev),
                last, ledger)
            self.prefill_tokens += n_true
            if nbad is not None:
                bad_pages += int(nbad)                     # waits
            out["prefill_tok"] = int(tok)                  # waits
            corrupted |= bool(bad)
        if dec:
            R = scfg.max_reqs
            toks = np.zeros((R, 1), np.int32)
            pos = np.zeros((R,), np.int32)
            act = np.zeros((R,), bool)
            for r in dec:
                toks[r.slot, 0] = r.generated[-1]
                pos[r.slot] = r.n_tokens
                act[r.slot] = True
            ntok, bad, nbad, ledger = self._decode_step(
                self.pool, torch.from_numpy(toks).to(dev), table,
                torch.from_numpy(pos).to(dev), torch.from_numpy(act).to(dev),
                ledger)
            if nbad is not None:
                bad_pages += int(nbad)                     # waits
            out["decode_toks"] = ntok.cpu().numpy()        # waits
            corrupted |= bool(bad)
        if bad_pages:
            # the EXACT tier tripped first: some page's bytes changed
            # outside the ledger-keeping steps — gated before _apply, so
            # no poisoned token was emitted
            raise chaos_lib.WireIntegrityError(
                f"serve tick {self.ticks}: {bad_pages} KV pool page(s) "
                "failed their exact checksum against the write-time ledger")
        if corrupted:
            raise chaos_lib.IntegrityError(
                f"serve tick {self.ticks} produced non-finite/garbage "
                "logits — gated before emission")
        out["ledger"] = ledger
        return out

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
            "page_integrity": bool(self.scfg.page_integrity),
            "page_trips": self.page_trips,
            "logit_trips": self.logit_trips,
            "requests": self.spans.summary(),
            "recovery": {"faults": rec["faults"],
                         "recoveries": rec["recoveries"],
                         "mttr_mean_s": rec["mttr_mean_s"]},
            **self.obs_static_metrics(),
        }
