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
