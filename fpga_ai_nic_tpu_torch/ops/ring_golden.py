"""Numpy golden model of the sliced ring all-reduce.

A copy of the JAX package's ``ops/ring_golden.py`` (numpy only); the
gather and all-reduce also take the ``layout`` argument here, so the
"sublane" layout of the CUDA ring kernels is specified end to end.

Simulates, device by device and hop by hop, exactly what the ring in
`ops.ring` computes — including the per-hop BFP compress/decompress (so
quantization error accumulation is part of the spec, not an accident) and
the floating-point add order.  This is the "three-instance testbench with a
golden compare" the reference documents but does not ship
(readme.pdf §3.2-3.3; hw/sim absent per hw/README:1) — here it is real,
shipped, and runs in CI.

Ring schedule (identical to ops.ring; natural chunk ownership — device i
ends with chunk i — rather than the reference's rotated order,
hw/all_reduce.sv:361, which only served its host-write FSM):
  - reduce-scatter hop s (s = 0..n-2): device i sends partial chunk
    (i - s - 1) mod n to device (i+1) mod n and accumulates the received
    partial into chunk (i - s - 2) mod n; the final accumulation lands on
    chunk i.
  - all-gather hop s: device i forwards the most recently received chunk
    (starting from its own chunk i) and stores the arrival at index
    (i - s - 1) mod n.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from . import bfp_golden
from ..utils.config import BFPConfig


def _compress(x: np.ndarray, cfg: BFPConfig,
              layout: str = "flat16") -> Tuple[np.ndarray, np.ndarray]:
    return bfp_golden.bfp_encode(x, cfg.block_size, cfg.mantissa_bits,
                                 cfg.rounding, layout=layout)


def _roundtrip(x: np.ndarray, cfg: Optional[BFPConfig],
               layout: str = "flat16") -> np.ndarray:
    if cfg is None:
        return x
    mant, se = _compress(x, cfg, layout)
    return bfp_golden.bfp_decode(mant, se, cfg.block_size, layout=layout)


def ring_reduce_scatter(shards: np.ndarray,
                        compression: Optional[BFPConfig] = None,
                        layout: str = "flat16") -> np.ndarray:
    """shards: [n, L] per-device input vectors (L divisible by n).

    Returns [n, L//n]: device i's fully-reduced chunk i.

    layout picks the BFP block membership (bfp_golden): "flat16" is the
    reference's consecutive-element grouping (the XLA codec); "sublane"
    is the TPU lane layout the Pallas wire kernels quantize in — with it
    this golden model is the DIRECT bit spec of ops.ring_pallas's fused
    reduce-scatter (block-aligned slicing never changes block
    membership, so per-slice and whole-chunk quantization agree)."""
    n, L = shards.shape
    assert L % n == 0
    chunks = shards.reshape(n, n, L // n).astype(np.float32).copy()
    for s in range(n - 1):
        sends = [_roundtrip(chunks[i, (i - s - 1) % n], compression, layout)
                 for i in range(n)]
        for i in range(n):
            chunks[i, (i - s - 2) % n] += sends[(i - 1) % n]
    return np.stack([chunks[i, i] for i in range(n)])


def ring_all_gather(owned: np.ndarray,
                    compression: Optional[BFPConfig] = None,
                    layout: str = "flat16") -> np.ndarray:
    """owned: [n, C] — device i contributes chunk i.  Returns [n, n*C]:
    each device's reassembled full vector.  With compression the chunk is
    quantized once on first send and forwarded verbatim (BFP roundtrip is
    idempotent), so replicas are identical — matching ops.ring."""
    n, C = owned.shape
    out = np.zeros((n, n, C), np.float32)
    carry = np.stack([_roundtrip(owned[i].astype(np.float32), compression,
                                 layout) for i in range(n)])
    for i in range(n):
        out[i, i] = carry[i]
    for s in range(n - 1):
        carry = carry[(np.arange(n) - 1) % n]          # hop to next neighbor
        for i in range(n):
            out[i, (i - s - 1) % n] = carry[i]
    return out.reshape(n, n * C)


def ring_all_reduce(shards: np.ndarray,
                    compression: Optional[BFPConfig] = None,
                    layout: str = "flat16") -> np.ndarray:
    """Full all-reduce = reduce-scatter + all-gather. Returns [n, L]."""
    owned = ring_reduce_scatter(shards, compression, layout)
    return ring_all_gather(owned, compression, layout)


def ring_reduce_scatter_pair(shards: np.ndarray, compression: BFPConfig,
                             slice_elems: int
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """The sublane reduce-scatter with the fused kernel's checksum pair
    (``csrc/ring_rs.cu`` with a pair): ``(owned [n, C], pair [n, 2]
    uint32)``, pair[r] = (send, recv) of rank r.

    Slice k of a chunk ([slice_elems], whole tiles) is one frame: its int8
    mantissas then its int8 scales in the sublane layout, each byte
    zero-extended, checksummed with ``golden_word_checksum``.  Rank i's
    k-th slice at hop s is emission q = s * S + k (S slices a chunk),
    weighted 2q + 1; it adds to send[i] and to recv[i + 1]."""
    from ..compress.golden import golden_word_checksum
    n, L = shards.shape
    C = L // n
    assert L % n == 0 and C % slice_elems == 0
    S = C // slice_elems
    chunks = shards.reshape(n, n, C).astype(np.float32).copy()
    pair = np.zeros((n, 2), np.uint64)
    mask = np.uint64(0xFFFFFFFF)
    for s in range(n - 1):
        sends = []
        for i in range(n):
            part = chunks[i, (i - s - 1) % n]
            dec = np.empty(C, np.float32)
            for k in range(S):
                sl = slice(k * slice_elems, (k + 1) * slice_elems)
                mant, se = _compress(part[sl], compression, "sublane")
                frame = np.concatenate([mant.reshape(-1).view(np.uint8),
                                        se.reshape(-1).view(np.uint8)])
                term = np.uint64(((2 * (s * S + k) + 1) & 0xFFFFFFFF)
                                 * int(golden_word_checksum(frame))) & mask
                pair[i, 0] = (pair[i, 0] + term) & mask
                pair[(i + 1) % n, 1] = (pair[(i + 1) % n, 1] + term) & mask
                dec[sl] = bfp_golden.bfp_decode(mant, se,
                                                compression.block_size,
                                                layout="sublane")
            sends.append(dec)
        for i in range(n):
            chunks[i, (i - s - 2) % n] += sends[(i - 1) % n]
    return (np.stack([chunks[i, i] for i in range(n)]),
            pair.astype(np.uint32))
