"""Live KV migration between serving replicas — the port of the JAX
package's ``serve/handoff.py``.

A replica that is preempted, drained or done prefilling holds live
requests' KV pages.  Moving request r's pages from replica A's pool to
replica B's loses none of its prefill work:

  - a **HandoffPlan** is the static description: ``n_move`` pages (each
    ``[kv_local, page_size, head_dim]`` a layer, for K and for V) crossing
    from the source pool to the destination pool.  ``wire_bytes()`` is
    exactly the pages' bytes; the page-table row and the request's tokens
    move on the host and are declared apart (``host_bytes``).
  - **apply_handoff** runs the move, block by block in
    ``handoff_program``'s order (layer-major, K before V): gather the
    moving pages of the source block (``index_select``), pass them through
    the wire tap at point ``"handoff.wire"``, write them into the
    destination block in place (``index_copy_``).  The source is left as
    it was.

The JAX package lowers the move to one ``shard_map`` over a two-device
pair mesh with one ``ppermute`` a block and donated pools.  The port's
fleet places replicas as slots on the card (``serve.fleet``), so a move
between two replicas on one device is a page copy within the card's
memory, and between two devices the gathered block goes over with
``.to(dst.device)`` (not verified: the port's runs have one card, ROADMAP
A.11).  There is no pair mesh and no lowering.

Because ``forward_paged`` does not depend on which pages hold a request's
positions, a migrated request continues on the destination bit for bit as
it would have at home.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..models import llama_decode
from ..models.llama import LlamaConfig
from ..ops import integrity as integrity_lib
from ..ops import ring as ring_ops
from ..verify import opstream as _opstream
from .paged import ServeConfig

# the block order of one KV migration (and with it the landed checksum's
# per-block weights): one definition, shared with the protocol program
handoff_program = _opstream.handoff_program

__all__ = ["HandoffPlan", "make_plan", "plan_for", "apply_handoff",
           "handoff_program"]

Pool = List[Dict[str, torch.Tensor]]


class HandoffPlan(NamedTuple):
    """Static shape of one KV migration: ``n_move`` pool pages, for each
    layer's K and V.  Page ids are arguments of ``apply_handoff``, not plan
    fields."""

    n_layers: int
    kv_local: int
    page_size: int
    head_dim: int
    n_pages: int                 # pool pages a replica
    n_move: int                  # pages that move
    dtype: str = "float32"

    @property
    def itemsize(self) -> int:
        return getattr(torch, self.dtype).itemsize

    @property
    def page_bytes(self) -> int:
        """Bytes of one page of one layer's K or V."""
        return self.kv_local * self.page_size * self.head_dim * self.itemsize

    def wire_bytes(self) -> int:
        """Exactly the bytes of the moving pages (K and V, every layer)."""
        return 2 * self.n_layers * self.n_move * self.page_bytes

    def host_bytes(self, n_tokens: int) -> int:
        """Bytes that move on the host a migrated request: the page-table
        row (int32) and the request's prompt and generated token ids."""
        return self.n_move * 4 + int(n_tokens) * 4

    def describe(self) -> Dict[str, Any]:
        return {"n_layers": self.n_layers, "kv_local": self.kv_local,
                "page_size": self.page_size, "head_dim": self.head_dim,
                "n_pages": self.n_pages, "n_move": self.n_move,
                "dtype": self.dtype, "wire_bytes": self.wire_bytes()}


def make_plan(*, n_layers: int, kv_local: int, page_size: int,
              head_dim: int, n_pages: int, n_move: int,
              dtype: str = "float32") -> HandoffPlan:
    assert n_layers >= 1 and kv_local >= 1 and page_size >= 1
    assert 1 <= n_move < n_pages, (n_move, n_pages)
    if not isinstance(getattr(torch, dtype, None), torch.dtype):
        raise ValueError(f"unknown dtype {dtype!r}")
    return HandoffPlan(n_layers=n_layers, kv_local=kv_local,
                       page_size=page_size, head_dim=head_dim,
                       n_pages=n_pages, n_move=n_move, dtype=dtype)


def plan_for(cfg: LlamaConfig, scfg: ServeConfig, n_move: int, *,
             tp_size: int = 1, dtype: Optional[str] = None) -> HandoffPlan:
    """The plan for migrating ``n_move`` pages between two replicas of one
    model and serving geometry (the fleet builds every replica from one
    (cfg, scfg) pair)."""
    return make_plan(
        n_layers=cfg.n_layers,
        kv_local=llama_decode.kv_local_heads(cfg, tp_size),
        page_size=scfg.page_size, head_dim=cfg.head_dim,
        n_pages=scfg.n_pages, n_move=n_move, dtype=dtype or cfg.dtype)


def apply_handoff(plan: HandoffPlan, src_pool: Pool, dst_pool: Pool,
                  src_pages: Sequence[int], dst_pages: Sequence[int], *,
                  expect: Optional[Any] = None) -> Any:
    """Pages ``src_pages`` of ``src_pool`` land at ``dst_pages`` of
    ``dst_pool`` (written in place).  Returns ``(src_pool, dst_pool)``; the
    caller owns the host bookkeeping (allocator, table rows, request
    state).

    ``expect`` (uint32 ``[n_move]``, the source ledger's checksums of
    ``src_pages``) adds the landed-page check: the return grows to
    ``(src_pool, dst_pool, ok, landed)``, where ``landed`` (numpy uint32)
    is ``gathered_page_checksums`` recomputed over the landed blocks (on
    the card through ``row_checksums``) and ``ok`` is landed == expect for
    every page.  A bit flipped anywhere between the source's write and the
    landing fails ``ok``."""
    assert len(src_pages) == len(dst_pages) == plan.n_move
    assert len(src_pool) == len(dst_pool) == plan.n_layers
    src_dev = src_pool[0]["k"].device
    dst_dev = dst_pool[0]["k"].device
    src_idx = torch.as_tensor(np.asarray(src_pages, np.int64),
                              device=src_dev)
    dst_idx = torch.as_tensor(np.asarray(dst_pages, np.int64),
                              device=dst_dev)
    blocks = []
    for mv in handoff_program(plan.n_layers):
        layer, key = divmod(mv.pool, 2)
        name = "kv"[key]
        payload = src_pool[layer][name].index_select(0, src_idx).to(dst_dev)
        payload = ring_ops.tap_wire_array(payload, "handoff.wire")
        dst_pool[layer][name].index_copy_(0, dst_idx, payload)
        blocks.append(payload)
    if expect is None:
        return src_pool, dst_pool
    landed = integrity_lib.gathered_page_checksums(blocks)
    landed = landed.cpu().numpy().astype(np.uint32)
    ok = bool(np.array_equal(landed, np.asarray(expect, np.uint32)))
    return src_pool, dst_pool, ok, landed
