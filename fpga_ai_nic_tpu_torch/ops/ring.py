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
padding (``fused_update.pad_multiple``) guarantees whole layout units:
whole tiles where the fused kernels carry the wire or the codec takes the
sublane layout.  These are the plain versions the fused CUDA ring kernels
(``ops.ring_cuda``) are held against.

``integrity=True`` (``ops.integrity``) checksums every message's encoded
payload once on the sending rank and once on the receiving rank with the
same odd weight, and returns ``(out, wire_ok)``: the conservation verdict
over the ranks.  Each rank's payload is checksummed on its own, as one JAX
device sees it (the rows of the batched codec output).  The bits of the
result are those of integrity off.

Two seams for fault injection (``runtime.chaos``), plain Python callables,
None by default (then nothing runs): the value tap sees each rank's input
row of a collective (``set_fault_tap``), the wire tap each rank's received
payload arrays between the hop and the decode (``set_wire_tap``), which is
what the receive-side checksums read.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from . import integrity as _integrity
from ..compress import as_codec

Payload = Tuple[torch.Tensor, ...]

_FAULT_TAP: Optional[Callable] = None
_WIRE_TAP: Optional[Callable] = None


def set_fault_tap(tap: Optional[Callable]) -> None:
    """Install (or remove, None) the value tap ``tap(row, point)``, called
    once per rank on its input row of each collective, in rank order."""
    global _FAULT_TAP
    _FAULT_TAP = tap


def set_wire_tap(tap: Optional[Callable]) -> None:
    """Install (or remove, None) the wire tap ``tap(array, point)``, called
    once per rank per payload array of each message that rank receives."""
    global _WIRE_TAP
    _WIRE_TAP = tap


def _tap_rows(rows: torch.Tensor, tap: Callable, point: str
              ) -> torch.Tensor:
    """Each rank's row through ``tap``; a copy only where a row changed."""
    out = rows
    for r in range(rows.shape[0]):
        row = rows[r]
        got = tap(row, point)
        if got is not row:
            if out is rows:
                out = rows.clone()
            out[r] = got
    return out


def _tap(x: torch.Tensor, point: str) -> torch.Tensor:
    return x if _FAULT_TAP is None else _tap_rows(x, _FAULT_TAP, point)


def _tap_wire(payload: Payload, point: str) -> Payload:
    """The received payload arrays ``[n, ...]`` (rank rows) through the wire
    tap, rank by rank and array by array."""
    if _WIRE_TAP is None:
        return payload
    out = list(payload)
    for r in range(payload[0].shape[0]):
        for j, p in enumerate(out):
            row = p[r]
            got = _WIRE_TAP(row, point)
            if got is not row:
                if out[j] is payload[j]:
                    out[j] = payload[j].clone()
                out[j][r] = got
    return tuple(out)


Perm = Optional[Sequence[Tuple[int, int]]]


def _hop(payload: torch.Tensor, perm: Perm = None) -> torch.Tensor:
    """Rows [n, ...] -> what each rank receives: from its left neighbour,
    or with ``perm`` ([(src, dst), ...], every rank a destination once)
    ``received[dst] = payload[src]``."""
    if perm is None:
        return torch.roll(payload, shifts=1, dims=0)
    src = [0] * payload.shape[0]
    for a, b in perm:
        src[b] = a
    return payload[torch.tensor(src, device=payload.device)]


def check_whole_units(codec, per_rank_elems: int) -> None:
    """Raise unless a [per_rank_elems] part of every rank may share one
    codec call with the others' (each a whole number of layout units)."""
    unit = codec.unit_elems(per_rank_elems)
    if per_rank_elems % unit:
        raise ValueError(
            f"codec {codec.name!r}: a rank's {per_rank_elems} elements are "
            f"not a whole number of its {unit}-element layout units, so "
            f"encoding the ranks together would mix their blocks")


def _send_n_messages(codec, length: int,
                     slice_elems: Optional[int]) -> int:
    """Messages one ``_send`` of a [length] chunk emits: the stride of the
    collective's message counter, so every (hop, slice) has its own odd
    conservation weight."""
    if codec is None or not codec.sliceable(length, slice_elems):
        return 1
    return length // slice_elems


FrameChecksum = Callable[[Payload], torch.Tensor]
Carry = Tuple[torch.Tensor, torch.Tensor]


def _checked(chk: Optional[Carry], w: int, frame_checksum: FrameChecksum,
             rows: Payload, side: int) -> Optional[Carry]:
    """Add ``w * checksum`` of each rank's payload to one side of the
    (send, recv) carry."""
    if chk is None:
        return None
    acc = list(chk)
    acc[side] = (acc[side] + w * frame_checksum(rows)) & _integrity.MASK32
    return acc[0], acc[1]


def _send(payload: torch.Tensor, codec,
          slice_elems: Optional[int] = None, chk: Optional[Carry] = None,
          msg_base: int = 0,
          frame_checksum: FrameChecksum = _integrity.row_checksums,
          perm: Perm = None):
    """One ring hop of every rank's [C] payload ([n, C]), codec-compressed
    on the wire when ``codec`` is set.  When the codec allows it the hop
    goes as [slice_elems] slices, which bounds the codec's temporaries and
    leaves the bits unchanged.  With ``chk`` (the (send, recv) carry) slice
    k is message ``msg_base + k``; returns ``received`` or ``(received,
    chk')``.  ``perm`` replaces the next-neighbour permutation: the seam
    ``ops.ring_hier`` drives its intra and inter subring hops through, so
    the wire taps and checksums see those hops too."""
    if codec is None:
        if chk is None and _WIRE_TAP is None:
            return _hop(payload, perm)
        w = _integrity.hop_weight(msg_base)
        chk = _checked(chk, w, frame_checksum, (payload,), 0)
        arrived = _tap_wire((_hop(payload, perm),), "ring.wire")
        chk = _checked(chk, w, frame_checksum, arrived, 1)
        return arrived[0] if chk is None else (arrived[0], chk)
    n, C = payload.shape
    S = slice_elems if codec.sliceable(C, slice_elems) else C
    check_whole_units(codec, S)
    out = torch.empty_like(payload)
    for k, off in enumerate(range(0, C, S)):
        part = payload[:, off:off + S].reshape(-1)
        wire = tuple(p.reshape(n, -1) for p in codec.encode(part))
        w = _integrity.hop_weight(msg_base + k)
        chk = _checked(chk, w, frame_checksum, wire, 0)
        arrived = _tap_wire(tuple(_hop(p, perm) for p in wire),
                            "ring.wire")
        chk = _checked(chk, w, frame_checksum, arrived, 1)
        out[:, off:off + S] = codec.decode(
            tuple(p.reshape(-1) for p in arrived), n * S,
            payload.dtype).reshape(n, S)
    return out if chk is None else (out, chk)


def ring_reduce_scatter_pair(
        x: torch.Tensor, compression=None, slice_elems: Optional[int] = None,
        frame_checksum: FrameChecksum = _integrity.row_checksums):
    """The checked reduce-scatter: ``(out [n, L/n], send [n], recv [n])``,
    the per-rank accumulators of ``frame_checksum`` over every message
    (each rank's payload rows), weighted by ``hop_weight`` of its index
    ``s * stride + k`` (hop s, slice k)."""
    return _reduce_scatter(x, compression, slice_elems, frame_checksum)


def _reduce_scatter(x, compression, slice_elems, frame_checksum):
    n, L = x.shape
    if L % n:
        raise ValueError(f"need length divisible by {n}, got {x.shape}")
    checked = frame_checksum is not None
    chk = _integrity.zero_carry(n, x.device) if checked else None
    if n == 1:
        return (x,) + chk if checked else x
    codec = as_codec(compression, L // n, x.device)
    x = _tap(x, "ring.reduce_scatter")
    chunks = x.reshape(n, n, L // n).clone()
    ranks = torch.arange(n, device=x.device)
    stride = _send_n_messages(codec, L // n, slice_elems)
    for s in range(n - 1):
        send = chunks[ranks, (ranks - s - 1) % n]
        if checked:
            recv, chk = _send(send, codec, slice_elems, chk, s * stride,
                              frame_checksum)
        else:
            recv = _send(send, codec, slice_elems)
        dst = (ranks - s - 2) % n
        chunks[ranks, dst] = chunks[ranks, dst] + recv
    out = chunks[ranks, ranks]
    return (out,) + chk if checked else out


def ring_reduce_scatter(x: torch.Tensor, compression=None,
                        slice_elems: Optional[int] = None,
                        integrity: bool = False):
    """x: [n, L] per-rank vectors (L % n == 0) -> [n, L/n]: rank i's fully
    reduced chunk i; with ``integrity``, ``(owned, wire_ok)``."""
    if not integrity:
        return _reduce_scatter(x, compression, slice_elems, None)
    out, sa, ra = _reduce_scatter(x, compression, slice_elems,
                                  _integrity.row_checksums)
    return out, _integrity.conservation_ok(sa, ra)


def ring_all_gather(owned: torch.Tensor, compression=None,
                    integrity: bool = False):
    """owned: [n, C] (rank i contributes chunk i) -> [n, n*C]: every rank's
    reassembled vector; with ``integrity``, ``(gathered, wire_ok)``.
    Frames are encoded once and forwarded verbatim, so all replicas are
    bitwise equal."""
    n, C = owned.shape
    codec = as_codec(compression, C, owned.device)
    owned = _tap(owned, "ring.all_gather")
    if n == 1:
        out = owned if codec is None else codec.roundtrip(
            owned.reshape(-1)).reshape(1, C)
        return (out, torch.tensor(True, device=owned.device)) if integrity \
            else out
    ranks = torch.arange(n, device=owned.device)
    out = torch.empty((n, n, C), dtype=owned.dtype, device=owned.device)
    if codec is None:
        wire: Payload = (owned,)

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
    chk = _integrity.zero_carry(n, owned.device) if integrity else None
    frame = _integrity.row_checksums
    for s in range(n - 1):
        w = _integrity.hop_weight(s)
        chk = _checked(chk, w, frame, wire, 0)
        wire = _tap_wire(tuple(_hop(p) for p in wire), "ring.wire")
        chk = _checked(chk, w, frame, wire, 1)
        out[ranks, (ranks - s - 1) % n] = landed(wire)
    out = out.reshape(n, n * C)
    return (out, _integrity.conservation_ok(*chk)) if integrity else out


def ring_all_reduce(x: torch.Tensor, compression=None,
                    slice_elems: Optional[int] = None,
                    integrity: bool = False):
    """Full all-reduce (sum) = reduce-scatter + all-gather: [n, L] -> [n, L];
    with ``integrity``, ``(reduced, wire_ok)``, the AND of both phases'."""
    if not integrity:
        return ring_all_gather(ring_reduce_scatter(x, compression,
                                                   slice_elems), compression)
    owned, ok_rs = ring_reduce_scatter(x, compression, slice_elems, True)
    full, ok_ag = ring_all_gather(owned, compression, True)
    return full, ok_rs & ok_ag


def wire_bytes_per_device(L: int, n: int, compression=None,
                          dtype_bytes: int = 4) -> int:
    """Bytes each rank puts on the ring for one all-reduce of L elements."""
    elems = 2 * (n - 1) * (L // n)
    codec = as_codec(compression)
    if codec is None:
        return elems * dtype_bytes
    return codec.wire_bytes(elems)

