"""Exact checksums over stored bits — the port of the page part of the JAX
package's ``ops/integrity.py`` (the serving tick's exact tier).

The checksum is an odd-weighted wraparound word sum,

    chk(x) = sum_i (2*i + 1) * word_i(x)      (mod 2^32),

where ``word_i`` enumerates the array's elements as uint32 words (4-byte
dtypes reinterpreted, 1-/2-byte dtypes zero-extended).  Torch has no
wrapping uint32 multiply-sum, so the words and weights are held in int64,
the products and sums are taken there and the result is masked with
``& 0xFFFFFFFF``: a product or sum that overflows int64 wraps in two's
complement, which keeps the low 32 bits exact.  Checksums are returned as
int64 tensors holding the uint32 value (0 .. 2^32-1), bit for bit the JAX
package's ``uint32`` results.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

__all__ = ["words_u32", "word_checksum", "page_checksums",
           "gathered_page_checksums"]

MASK32 = 0xFFFFFFFF
_VIEW = {4: torch.int32, 2: torch.int16, 1: torch.uint8}


def words_u32(x: torch.Tensor) -> torch.Tensor:
    """A tensor as a flat int64 vector of its uint32 words (values
    0 .. 2^32-1).  8-byte dtypes are rejected, as in the JAX package."""
    x = x.reshape(-1)
    size = x.element_size()
    if size not in _VIEW:
        raise TypeError(f"no checksummed payload may have itemsize {size} "
                        f"(dtype {x.dtype})")
    w = x.view(_VIEW[size]).to(torch.int64)
    return w & MASK32 if size == 4 else w & ((1 << (8 * size)) - 1)


def _weights(n: int, device: torch.device) -> torch.Tensor:
    """(2*i + 1) mod 2^32 for i < n, as int64."""
    return ((torch.arange(n, dtype=torch.int64, device=device) << 1) | 1
            ) & MASK32


def word_checksum(x: torch.Tensor) -> torch.Tensor:
    """int64 scalar holding the uint32 checksum of one tensor."""
    w = words_u32(x)
    return (w * _weights(w.shape[0], w.device)).sum() & MASK32


def gathered_page_checksums(blocks: Sequence[torch.Tensor]) -> torch.Tensor:
    """[n_pages] int64 (uint32 values) — one checksum per leading-axis
    page, summed over the blocks with per-block odd multipliers (weights
    restart per page per block).  One block at a time, so no int64 copy
    of more than one block is ever formed."""
    acc = None
    for j, arr in enumerate(blocks):
        n_pages = arr.shape[0]
        w = words_u32(arr).reshape(n_pages, -1)
        per_page = (w * _weights(w.shape[1], w.device)[None, :]).sum(
            dim=1) & MASK32
        term = ((2 * j + 1) * per_page) & MASK32
        acc = term if acc is None else (acc + term) & MASK32
    if acc is None:
        raise ValueError("no blocks to checksum")
    return acc


def page_checksums(pool: List[Dict[str, torch.Tensor]]) -> torch.Tensor:
    """[n_pages] int64 (uint32 values) — one exact checksum per KV-pool
    page over every layer's K and V bytes of that page, layer-major, K
    before V (the JAX package's block order).  A zero-filled pool
    checksums to all zeros, so a fresh ledger is zeros."""
    return gathered_page_checksums(
        [layer[key] for layer in pool for key in ("k", "v")])
