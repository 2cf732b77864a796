"""Numpy golden models of the int8 and top-k codecs and the codec-generic
flat and hierarchical ring goldens — the port's own copy of the JAX package's
``compress/golden.py`` (numpy only).

The golden is the bit-level specification: the port's torch codecs
(``compress.int8``, ``compress.topk``), the CUDA int8 kernels
(``csrc/int8_codec.cu``) and the plain rings (``ops.ring``,
``ops.ring_hier``) are held equal
to it bit for bit, including top-k's tie rule and int8's stochastic-rounding
hash.

One change from the reference: the bf16 scale is computed without
``ml_dtypes``.  ``_to_bf16`` rounds f32 to bf16 (round to nearest, ties to
even) with integer bit operations and returns the bf16 bit patterns as
``uint16``; the int8 functions take and return scales in that form.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import numpy as np

from ..ops import bfp_golden

RoundtripFn = Callable[[np.ndarray], np.ndarray]


# ---------------------------------------------------------------------------
# top-k (spec for compress.topk.TopKCodec)
# ---------------------------------------------------------------------------

def topk_encode(x: np.ndarray, bucket_elems: int = 512,
                k: int = 64) -> Tuple[np.ndarray, np.ndarray]:
    """Flat f32 [n] -> (values f32 [nb, k], indices int16 [nb, k]).
    Equal magnitudes keep ascending index order (a stable argsort of the
    negated magnitudes), as ``lax.top_k`` returns them."""
    x = np.asarray(x, np.float32)
    assert x.ndim == 1 and x.shape[0] % bucket_elems == 0
    xb = x.reshape(-1, bucket_elems)
    order = np.argsort(-np.abs(xb), axis=-1, kind="stable")[:, :k]
    vals = np.take_along_axis(xb, order, axis=-1)
    return vals, order.astype(np.int16)


def topk_decode(vals: np.ndarray, idx: np.ndarray, n_elems: int,
                bucket_elems: int = 512) -> np.ndarray:
    nb = n_elems // bucket_elems
    out = np.zeros((nb, bucket_elems), np.float32)
    rows = np.arange(nb)[:, None]
    out[rows, idx.astype(np.int64)] = vals
    return out.reshape(n_elems)


def topk_roundtrip(x: np.ndarray, bucket_elems: int = 512,
                   k: int = 64) -> np.ndarray:
    vals, idx = topk_encode(x, bucket_elems, k)
    return topk_decode(vals, idx, x.shape[0], bucket_elems)


# ---------------------------------------------------------------------------
# int8 (spec for compress.int8.Int8Codec)
# ---------------------------------------------------------------------------

def seed_stamp(seed: int) -> int:
    """The 32-bit word the hash mixes into every value's bits."""
    return (seed * 0x9E3779B9) & 0xFFFFFFFF


def hash_u01(bits: np.ndarray, seed: int) -> np.ndarray:
    """Value bits (uint32) -> pseudo-uniform f32 in [0, 1): the murmur3
    finalizer over ``bits ^ seed_stamp(seed)``, top 24 bits times 2^-24.
    The constants are the bit spec."""
    with np.errstate(over="ignore"):
        z = bits.astype(np.uint32) ^ np.uint32(seed_stamp(seed))
        z = z ^ (z >> np.uint32(16))
        z = z * np.uint32(0x85EBCA6B)
        z = z ^ (z >> np.uint32(13))
        z = z * np.uint32(0xC2B2AE35)
        z = z ^ (z >> np.uint32(16))
    return (z >> np.uint32(8)).astype(np.float32) * np.float32(2.0 ** -24)


def _to_bf16(x: np.ndarray) -> np.ndarray:
    """f32 -> bf16 bit patterns (uint16), rounded to nearest, ties to even;
    a NaN becomes the quiet NaN of its sign.  The same bits as
    ``x.astype(ml_dtypes.bfloat16)``."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    bias = np.uint32(0x7FFF) + ((bits >> np.uint32(16)) & np.uint32(1))
    with np.errstate(over="ignore"):
        rounded = (bits + bias) >> np.uint32(16)
    quiet_nan = ((bits >> np.uint32(16)) & np.uint32(0x8000)) | np.uint32(
        0x7FC0)
    out = np.where(np.isnan(x), quiet_nan, rounded)
    return out.astype(np.uint16)


def _bf16_to_f32(b: np.ndarray) -> np.ndarray:
    """bf16 bit patterns (uint16) -> f32, exactly."""
    return (np.asarray(b, np.uint16).astype(np.uint32)
            << np.uint32(16)).view(np.float32)


def int8_encode(x: np.ndarray, block_size: int = 16,
                rounding: str = "stochastic", seed: int = 0,
                layout: str = "flat16"
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Flat f32 [n] -> (int8 q [n], bf16 scale bits uint16 [n/block]).

    scale = bf16(max|x| * f32(1/127)), 1.0 for an all-zero block; q =
    clip(floor(x/scale + u), -127, 127) with u = hash_u01 of x's bits
    ("stochastic") or clip(rint(x/scale)) ("nearest").  layout: "flat16"
    = consecutive-element blocks, "sublane" = lane-column blocks
    (``ops.bfp_golden._to_blocks``)."""
    x = np.ascontiguousarray(x, np.float32)
    xb = bfp_golden._to_blocks(x, block_size, layout)
    maxabs = np.abs(xb).max(axis=-1)
    scale = _to_bf16(np.where(maxabs > 0, maxabs * np.float32(1.0 / 127.0),
                              np.float32(1.0)).astype(np.float32))
    with np.errstate(divide="ignore", invalid="ignore"):
        # a block of subnormals only has scale bf16(0): x / 0 clips to 127
        v = xb / _bf16_to_f32(scale)[..., None]
    if rounding == "stochastic":
        bits = bfp_golden._to_blocks(x.view(np.uint32), block_size, layout)
        v = np.floor(v + hash_u01(bits, seed))
    elif rounding == "nearest":
        v = np.rint(v)
    else:
        raise ValueError(rounding)
    q = np.clip(v, -127.0, 127.0).astype(np.int8)
    return (bfp_golden._from_blocks(q, x.shape, block_size, layout),
            scale.reshape(-1))


def int8_decode(q: np.ndarray, scale: np.ndarray, block_size: int = 16,
                dtype: Any = np.float32,
                layout: str = "flat16") -> np.ndarray:
    """q * f32(scale), exact in f32 (at most 15 significand bits)."""
    qb = bfp_golden._to_blocks(np.asarray(q, np.int8), block_size,
                               layout).astype(np.float32)
    x = qb * _bf16_to_f32(np.asarray(scale).reshape(-1))[..., None]
    return bfp_golden._from_blocks(x, q.shape, block_size, layout).astype(
        dtype)


def int8_roundtrip(x: np.ndarray, block_size: int = 16,
                   rounding: str = "stochastic", seed: int = 0,
                   layout: str = "flat16") -> np.ndarray:
    q, s = int8_encode(x, block_size, rounding, seed, layout)
    return int8_decode(q, s, block_size, np.float32, layout)


# ---------------------------------------------------------------------------
# codec-generic roundtrip lookup
# ---------------------------------------------------------------------------

def roundtrip_fn(codec: Any) -> RoundtripFn:
    """The numpy golden roundtrip matching a port codec's configuration."""
    from .bfp import BFPCodec, use_pallas
    from .int8 import Int8Codec
    from .topk import TopKCodec

    if isinstance(codec, BFPCodec):
        cfg = codec.cfg

        def rt(x: np.ndarray) -> np.ndarray:
            layout = "sublane" if use_pallas(cfg, x.shape[0]) else "flat16"
            mant, se = bfp_golden.bfp_encode(
                x, cfg.block_size, cfg.mantissa_bits, cfg.rounding,
                layout=layout)
            return bfp_golden.bfp_decode(mant, se, cfg.block_size,
                                         layout=layout)
        return rt
    if isinstance(codec, TopKCodec):
        return lambda x: topk_roundtrip(x, codec.bucket_elems, codec.k)
    if isinstance(codec, Int8Codec):
        layout = "sublane" if codec.sublane else "flat16"
        return lambda x: int8_roundtrip(x, codec.block_size, codec.rounding,
                                        codec.seed, layout)
    raise TypeError(f"no golden model registered for {type(codec).__name__}")


# ---------------------------------------------------------------------------
# codec-generic ring golden
# ---------------------------------------------------------------------------

def _rt(x: np.ndarray, roundtrip: Optional[RoundtripFn]) -> np.ndarray:
    return x if roundtrip is None else roundtrip(np.asarray(x, np.float32))


def ring_reduce_scatter(shards: np.ndarray,
                        roundtrip: Optional[RoundtripFn] = None
                        ) -> np.ndarray:
    """[n, L] per-rank inputs -> [n, L//n] owned reduced chunks, with
    ``roundtrip`` applied to every hop payload: the schedule and f32 add
    order of ``ops.ring_golden.ring_reduce_scatter``, for any codec."""
    n, L = shards.shape
    assert L % n == 0
    chunks = shards.reshape(n, n, L // n).astype(np.float32).copy()
    for s in range(n - 1):
        sends = [_rt(chunks[i, (i - s - 1) % n], roundtrip)
                 for i in range(n)]
        for i in range(n):
            chunks[i, (i - s - 2) % n] += sends[(i - 1) % n]
    return np.stack([chunks[i, i] for i in range(n)])


def ring_all_gather(owned: np.ndarray,
                    roundtrip: Optional[RoundtripFn] = None) -> np.ndarray:
    """[n, C] owned chunks -> [n, n*C] replicas.  Each chunk is encoded
    once and forwarded verbatim, so replicas are identical even for codecs
    that are not idempotent."""
    n, C = owned.shape
    out = np.zeros((n, n, C), np.float32)
    carry = np.stack([_rt(owned[i], roundtrip) for i in range(n)])
    for i in range(n):
        out[i, i] = carry[i]
    for s in range(n - 1):
        carry = carry[(np.arange(n) - 1) % n]
        for i in range(n):
            out[i, (i - s - 1) % n] = carry[i]
    return out.reshape(n, n * C)


def ring_all_reduce(shards: np.ndarray,
                    roundtrip: Optional[RoundtripFn] = None) -> np.ndarray:
    return ring_all_gather(ring_reduce_scatter(shards, roundtrip), roundtrip)


# ---------------------------------------------------------------------------
# hierarchical (intra x inter) 2-stage ring golden (spec for ops.ring_hier:
# raw f32 on the fast intra hop, ``roundtrip`` only on the slow inter hop)
# ---------------------------------------------------------------------------

def hier_reduce_scatter(shards: np.ndarray, n_intra: int,
                        roundtrip: Optional[RoundtripFn] = None
                        ) -> np.ndarray:
    """[n, L] per-rank inputs -> [n, L//n] owned reduced chunks with
    natural ownership (rank d ends with chunk d): phase A, the codec-free
    flat-ring schedule inside each group of ``n_intra`` consecutive ranks
    (unit = the ng*C elements whose intra index matches), then phase B, the
    flat-ring schedule across groups with ``roundtrip`` on every hop
    payload."""
    n, L = shards.shape
    ni = int(n_intra)
    assert n % ni == 0 and L % n == 0, (n, ni, L)
    ng, C = n // ni, L // n
    # units[d, j'] = concat over g' of chunk g'*ni + j' of rank d
    units = (shards.reshape(n, ng, ni, C).astype(np.float32)
             .transpose(0, 2, 1, 3).reshape(n, ni, ng * C).copy())
    for s in range(ni - 1):          # phase A: intra, raw (no roundtrip)
        sends = [units[d, (d % ni - s - 1) % ni] for d in range(n)]
        for d in range(n):
            g, j = d // ni, d % ni
            src = g * ni + (j - 1) % ni          # intra predecessor
            units[d, (j - s - 2) % ni] += sends[src]
    # own[d, q] = group-partial sum of chunk q*ni + (d % ni)
    own = np.stack([units[d, d % ni].reshape(ng, C) for d in range(n)])
    for s in range(ng - 1):          # phase B: inter, codec on the wire
        sends = [_rt(own[d, (d // ni - s - 1) % ng], roundtrip)
                 for d in range(n)]
        for d in range(n):
            g, j = d // ni, d % ni
            src = ((g - 1) % ng) * ni + j        # inter predecessor
            own[d, (g - s - 2) % ng] += sends[src]
    return np.stack([own[d, d // ni] for d in range(n)])


def hier_all_gather(owned: np.ndarray, n_intra: int,
                    roundtrip: Optional[RoundtripFn] = None) -> np.ndarray:
    """[n, C] owned chunks -> [n, n*C] replicas: the codec inter gather
    first (each chunk quantized once when it crosses the slow boundary,
    forwarded verbatim), then the raw intra gather.  With n_inter == 1
    nothing is quantized (no slow boundary exists)."""
    n, C = owned.shape
    ni = int(n_intra)
    assert n % ni == 0, (n, ni)
    ng = n // ni
    owned = owned.astype(np.float32)
    # phase B': inter all-gather across groups (members share j)
    blocks = np.zeros((n, ng, C), np.float32)
    if ng > 1:
        carry = np.stack([_rt(owned[d], roundtrip) for d in range(n)])
        for d in range(n):
            blocks[d, d // ni] = carry[d]
        for s in range(ng - 1):
            nxt = np.empty_like(carry)
            for d in range(n):
                g, j = d // ni, d % ni
                nxt[d] = carry[((g - 1) % ng) * ni + j]
            carry = nxt
            for d in range(n):
                blocks[d, (d // ni - s - 1) % ng] = carry[d]
    else:
        for d in range(n):
            blocks[d, 0] = owned[d]
    # phase A': raw intra all-gather of the [ng*C] block
    flat = blocks.reshape(n, ng * C)
    out = np.zeros((n, ni, ng * C), np.float32)
    carry = flat.copy()
    for d in range(n):
        out[d, d % ni] = carry[d]
    for s in range(ni - 1):
        nxt = np.empty_like(carry)
        for d in range(n):
            g, j = d // ni, d % ni
            nxt[d] = carry[g * ni + (j - 1) % ni]
        carry = nxt
        for d in range(n):
            out[d, (d % ni - s - 1) % ni] = carry[d]
    # out[d, p] = chunks {q*ni + p}; restore natural chunk order
    return (out.reshape(n, ni, ng, C).transpose(0, 2, 1, 3)
            .reshape(n, n * C))


def hier_all_reduce(shards: np.ndarray, n_intra: int,
                    roundtrip: Optional[RoundtripFn] = None) -> np.ndarray:
    return hier_all_gather(hier_reduce_scatter(shards, n_intra, roundtrip),
                           n_intra, roundtrip)


# ---------------------------------------------------------------------------
# exact wire checksums (spec for ops.integrity)
# ---------------------------------------------------------------------------

_U32 = np.uint64(0xFFFFFFFF)


def golden_words_u32(x: np.ndarray) -> np.ndarray:
    """An array as the flat uint32 word vector the checksum is defined
    over: 4-byte dtypes reinterpreted word for word (little-endian),
    1- and 2-byte dtypes zero-extended (bf16 arrives here as its uint16
    bit patterns).  8-byte dtypes are rejected."""
    x = np.ascontiguousarray(x).reshape(-1)
    size = x.dtype.itemsize
    if size == 4:
        return x.view(np.uint32)
    if size == 2:
        return x.view(np.uint16).astype(np.uint32)
    if size == 1:
        return x.view(np.uint8).astype(np.uint32)
    raise TypeError(f"no wire payload may have itemsize {size}")


def _weighted_sum(w: np.ndarray) -> np.ndarray:
    """sum_i (2i + 1) * w[..., i] (mod 2^32) over the last axis, each
    product reduced mod 2^32 before the uint64 sum."""
    w = w.astype(np.uint64)
    weights = (((np.arange(w.shape[-1], dtype=np.uint64) << np.uint64(1))
                | np.uint64(1)) & _U32)
    return np.sum((w * weights) & _U32, axis=-1, dtype=np.uint64) & _U32


def golden_word_checksum(x: np.ndarray) -> np.uint32:
    """The odd-weighted wraparound word sum sum_i (2i+1) * word_i
    (mod 2^32) of one array."""
    return np.uint32(_weighted_sum(golden_words_u32(x)))


def golden_payload_checksum(payload) -> np.uint32:
    """Per-element odd multipliers over a hop's payload tuple."""
    acc = 0
    for k, p in enumerate(payload):
        acc += (2 * k + 1) * int(golden_word_checksum(np.asarray(p)))
    return np.uint32(acc & 0xFFFFFFFF)


def golden_page_checksums(pool) -> np.ndarray:
    """[n_pages] uint32: one checksum per KV-pool page over every layer's
    K and V bytes, word weights restarting per page per array, odd
    per-array multipliers in layer-major K-then-V order."""
    acc = None
    j = 0
    for layer in pool:
        for key in ("k", "v"):
            arr = np.ascontiguousarray(np.asarray(layer[key]))
            n_pages = arr.shape[0]
            per_page = _weighted_sum(
                golden_words_u32(arr).reshape(n_pages, -1))
            term = (np.uint64(2 * j + 1) * per_page) & _U32
            acc = term if acc is None else (acc + term) & _U32
            j += 1
    return acc.astype(np.uint32)
