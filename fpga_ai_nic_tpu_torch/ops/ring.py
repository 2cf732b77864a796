"""Plain torch ring collectives over virtual ranks — the port of the JAX
package's ``ops/ring.py``.

The JAX rings run inside ``shard_map`` with one device per rank.  Here the
n ranks are virtual: their per-rank vectors are stacked as the rows of one
``[n, L]`` tensor, and a hop to the next neighbour is a roll of the
encoded payload by one row.  The schedule, the per-hop encode -> decode,
the add order and the verbatim forwarding of the gather are the
reference's (``ops.ring_golden`` is the bit spec):

  reduce-scatter hop s (s = 0..n-2): rank i sends partial chunk
    (i-s-1) % n to rank i+1, which adds it into its chunk (i-s-2) % n;
    rank i ends with the full sum of chunk i.
  all-gather: each rank encodes its chunk once and stores its own decoded
    copy; hop s forwards the frames verbatim and rank i decodes the
    arrival into slot (i-s-1) % n.

A codec encodes all ranks' payloads in one call.  That gives the bits of
encoding each rank alone only when each rank's part is a whole number of
the codec's layout units (``Codec.unit_elems``: a compression unit, or a
whole (block, 128)-lane tile in the sublane layout); otherwise the rings
raise ``ValueError``, as the JAX package's sublane kernels assert.  The
padding (``fused_update.pad_multiple``) guarantees whole compression units;
whole tiles only where the fused kernels pad for them or the length
happens to tile.  These are the plain versions the fused CUDA ring kernels
(``ops.ring_cuda``) are held against.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..compress import as_codec


def _hop(payload: torch.Tensor) -> torch.Tensor:
    """Rows [n, ...] -> what each rank receives from its left neighbour."""
    return torch.roll(payload, shifts=1, dims=0)


def check_whole_units(codec, per_rank_elems: int) -> None:
    """Raise unless a [per_rank_elems] part of every rank may share one
    codec call with the others' (each a whole number of layout units)."""
    unit = codec.unit_elems(per_rank_elems)
    if per_rank_elems % unit:
        raise ValueError(
            f"codec {codec.name!r}: a rank's {per_rank_elems} elements are "
            f"not a whole number of its {unit}-element layout units, so "
            f"encoding the ranks together would mix their blocks")


def _send(payload: torch.Tensor, codec,
          slice_elems: Optional[int] = None) -> torch.Tensor:
    """One ring hop of every rank's [C] payload ([n, C]), codec-compressed
    on the wire when ``codec`` is set.  When the codec allows it the hop
    goes as [slice_elems] slices, which bounds the codec's temporaries and
    leaves the bits unchanged."""
    if codec is None:
        return _hop(payload)
    n, C = payload.shape
    S = slice_elems if codec.sliceable(C, slice_elems) else C
    check_whole_units(codec, S)
    out = torch.empty_like(payload)
    for off in range(0, C, S):
        part = payload[:, off:off + S].reshape(-1)
        wire = codec.encode(part)
        arrived = tuple(_hop(p.reshape(n, -1)).reshape(-1) for p in wire)
        out[:, off:off + S] = codec.decode(arrived, n * S,
                                           payload.dtype).reshape(n, S)
    return out


def ring_reduce_scatter(x: torch.Tensor, compression=None,
                        slice_elems: Optional[int] = None) -> torch.Tensor:
    """x: [n, L] per-rank vectors (L % n == 0) -> [n, L/n]: rank i's fully
    reduced chunk i."""
    n, L = x.shape
    if L % n:
        raise ValueError(f"need length divisible by {n}, got {x.shape}")
    if n == 1:
        return x
    codec = as_codec(compression)
    chunks = x.reshape(n, n, L // n).clone()
    ranks = torch.arange(n, device=x.device)
    for s in range(n - 1):
        recv = _send(chunks[ranks, (ranks - s - 1) % n], codec, slice_elems)
        dst = (ranks - s - 2) % n
        chunks[ranks, dst] = chunks[ranks, dst] + recv
    return chunks[ranks, ranks]


def ring_all_gather(owned: torch.Tensor, compression=None) -> torch.Tensor:
    """owned: [n, C] (rank i contributes chunk i) -> [n, n*C]: every rank's
    reassembled vector.  Frames are encoded once and forwarded verbatim,
    so all replicas are bitwise equal."""
    n, C = owned.shape
    codec = as_codec(compression)
    if n == 1:
        return owned if codec is None else codec.roundtrip(
            owned.reshape(-1)).reshape(1, C)
    ranks = torch.arange(n, device=owned.device)
    out = torch.empty((n, n, C), dtype=owned.dtype, device=owned.device)
    if codec is None:
        wire = (owned,)

        def landed(p):
            return p[0]
    else:
        check_whole_units(codec, C)
        wire = tuple(p.reshape(n, -1)
                     for p in codec.encode(owned.reshape(-1)))

        def landed(p):
            return codec.decode(tuple(q.reshape(-1) for q in p), n * C,
                                owned.dtype).reshape(n, C)
    out[ranks, ranks] = landed(wire)
    for s in range(n - 1):
        wire = tuple(_hop(p) for p in wire)
        out[ranks, (ranks - s - 1) % n] = landed(wire)
    return out.reshape(n, n * C)


def ring_all_reduce(x: torch.Tensor, compression=None) -> torch.Tensor:
    """Full all-reduce (sum) = reduce-scatter + all-gather: [n, L] -> [n, L]."""
    return ring_all_gather(ring_reduce_scatter(x, compression), compression)


def wire_bytes_per_device(L: int, n: int, compression=None,
                          dtype_bytes: int = 4) -> int:
    """Bytes each rank puts on the ring for one all-reduce of L elements."""
    elems = 2 * (n - 1) * (L // n)
    codec = as_codec(compression)
    if codec is None:
        return elems * dtype_bytes
    return codec.wire_bytes(elems)
