"""Paged KV-cache pool and page allocator — the port of the JAX package's
``serve/paged.py``.

One preallocated pool per layer, ``[n_pages, kv, page_size, hd]``, with
page 0 reserved as the null page (the write target of empty slots and the
read target of unallocated table entries; never visible through the
attention mask); a static ``[max_reqs, max_pages_per_seq]`` int32 page
table; recycled pages handed out dirty, which ``forward_paged``'s mask
makes safe.  Byte accounting is exact: ``pool_bytes`` equals the bytes of
the tensors ``init_pool`` allocates.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

from ..device import DeviceLike, resolve_device
from ..models import llama_decode
from ..models.llama import LlamaConfig

__all__ = ["NULL_PAGE", "ServeConfig", "PageAllocator", "init_pool",
           "pool_bytes", "contiguous_cache_bytes", "page_table_bytes"]

NULL_PAGE = 0


@dataclass(frozen=True)
class ServeConfig:
    """Static shape and budget knobs of the serving plane."""

    max_reqs: int = 8                # decode slots (R)
    page_size: int = 16              # positions per KV page
    n_pages: int = 64                # pool pages INCLUDING null page 0
    max_pages_per_seq: int = 8       # page-table width (P)
    prefill_chunk: int = 16          # tokens per prefill call (static T)
    # watchdog bound over each tick's device work; the port has no
    # watchdog yet, so the engine refuses anything but None
    step_timeout_s: Optional[float] = None
    max_retries: int = 4
    backoff_s: float = 0.01
    # second-tier tick guard: logits that are non-finite or larger than
    # this in magnitude gate the tick (IntegrityError, replay recovery);
    # None disables the magnitude half
    logit_guard_abs: Optional[float] = 1e6
    # first-tier tick guard: exact per-page checksums of the pool
    # (ops.integrity.page_checksums), verified on every tick's input and
    # recorded from its output
    page_integrity: bool = True

    def __post_init__(self) -> None:
        if self.max_reqs < 1 or self.page_size < 1:
            raise ValueError("max_reqs and page_size must be >= 1")
        if self.logit_guard_abs is not None and self.logit_guard_abs <= 0:
            raise ValueError("logit_guard_abs must be positive (or None)")
        if self.n_pages < 2:
            raise ValueError("n_pages must be >= 2 (page 0 is reserved)")
        if self.max_pages_per_seq < 1:
            raise ValueError("max_pages_per_seq must be >= 1")
        if self.prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")

    @property
    def max_seq(self) -> int:
        """Longest sequence a single page-table row can address."""
        return self.max_pages_per_seq * self.page_size

    @property
    def usable_pages(self) -> int:
        return self.n_pages - 1          # page 0 is the null page

    def pages_for(self, n_positions: int) -> int:
        """Pages needed to hold ``n_positions`` KV entries."""
        return max(0, -(-int(n_positions) // self.page_size))


class PageAllocator:
    """Free-list allocator over pool pages ``1..n_pages-1``; freed pages
    are recycled LIFO and handed out dirty.  Single-threaded (only the
    engine loop allocates)."""

    def __init__(self, n_pages: int) -> None:
        if n_pages < 2:
            raise ValueError("n_pages must be >= 2 (page 0 is reserved)")
        self.n_pages = int(n_pages)
        self._free: List[int] = list(range(self.n_pages - 1, 0, -1))
        self.in_use = 0
        self.peak_in_use = 0

    @property
    def free(self) -> int:
        return len(self._free)

    def alloc(self, n: int = 1) -> Optional[List[int]]:
        """n pages, or None (caller evicts and retries) — never partial."""
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        self.in_use += n
        self.peak_in_use = max(self.peak_in_use, self.in_use)
        return pages

    def free_pages(self, pages: List[int]) -> None:
        for p in pages:
            if not 1 <= p < self.n_pages:
                raise ValueError(
                    f"page {p} outside pool (1..{self.n_pages - 1})")
        self._free.extend(pages)
        self.in_use -= len(pages)
        if self.in_use < 0 or len(self._free) > self.n_pages - 1:
            raise RuntimeError("page double-free detected")


def _dtype(cfg: LlamaConfig, dtype: Optional[str]) -> torch.dtype:
    return getattr(torch, dtype or cfg.dtype)


def init_pool(cfg: LlamaConfig, scfg: ServeConfig, *,
              dtype: Optional[str] = None, device: DeviceLike = "cuda",
              tp_size: int = 1) -> List[Dict[str, torch.Tensor]]:
    """Per-layer paged K/V pools ``[n_pages, kv, page_size, hd]``,
    zero-filled once — the only full-pool fill the serving plane does.
    With ``tp_size`` the pool holds every tp rank's kv heads, ``kv =
    kv_local_heads(cfg, tp) * tp`` (JAX's global pool, sharded on that
    axis: more than ``n_kv_heads`` under kv-head replication)."""
    dev = resolve_device(device)
    dt = _dtype(cfg, dtype)
    shape = (scfg.n_pages, llama_decode.kv_local_heads(cfg, tp_size)
             * tp_size, scfg.page_size, cfg.head_dim)
    return [{"k": torch.zeros(shape, dtype=dt, device=dev),
             "v": torch.zeros(shape, dtype=dt, device=dev)}
            for _ in range(cfg.n_layers)]


def pool_bytes(cfg: LlamaConfig, scfg: ServeConfig, *,
               dtype: Optional[str] = None, tp_size: int = 1) -> int:
    """Exact bytes of the paged pool (all layers, K and V; every tp rank's
    kv heads with ``tp_size``)."""
    itemsize = torch.empty((), dtype=_dtype(cfg, dtype)).element_size()
    per_layer = (2 * scfg.n_pages * llama_decode.kv_local_heads(cfg, tp_size)
                 * tp_size * scfg.page_size * cfg.head_dim * itemsize)
    return cfg.n_layers * per_layer


def contiguous_cache_bytes(cfg: LlamaConfig, batch: int, max_seq: int, *,
                           dtype: Optional[str] = None) -> int:
    """Exact bytes ``init_cache`` would allocate for the same concurrency —
    what the paged pool is measured against."""
    itemsize = torch.empty((), dtype=_dtype(cfg, dtype)).element_size()
    return (cfg.n_layers * 2 * batch * llama_decode.kv_local_heads(cfg)
            * max_seq * cfg.head_dim * itemsize)


def page_table_bytes(scfg: ServeConfig) -> int:
    """Exact bytes of the static int32 page table."""
    return scfg.max_reqs * scfg.max_pages_per_seq * 4
