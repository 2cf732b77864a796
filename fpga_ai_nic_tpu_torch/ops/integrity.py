"""Exact checksums over the bits that cross a wire or sit in a KV page — the
port of the JAX package's ``ops/integrity.py``.

The checksum is an odd-weighted wraparound word sum,

    chk(x) = sum_i (2*i + 1) * word_i(x)      (mod 2^32),

where ``word_i`` enumerates the array's elements as uint32 words (4-byte
dtypes reinterpreted, 1-/2-byte dtypes zero-extended).  The weights are
odd, hence invertible mod 2^32, so no single corrupted word can vanish from
the sum; checksums of distinct messages add, so a ring verifies by
conservation (every frame checksummed once at send and once at receive,
``conservation_ok``) and a replicating collective by agreement
(``replica_consistent``).  Checksums are int64 tensors holding the uint32
value (0 .. 2^32-1), bit for bit the JAX package's ``uint32`` results.

The n ranks are virtual (``parallel.mesh.VirtualRanks``): a per-rank
quantity is a row of a stacked tensor, so what JAX computes once per device
is computed here once per row.  ``row_checksums`` is the shared primitive:
one checksum per leading-axis row, summed over several arrays with odd
per-array multipliers (the per-page ledger, the per-rank payload checksums,
the replica agreement).  On a CUDA tensor it is one launch of
``csrc/checksum.cu`` (``ROW_CHECKSUMS``), which reads each byte once; on a
CPU tensor it is the plain version (``row_checksums_plain``), which widens
each block to int64 (a product or sum that overflows int64 wraps in two's
complement, which keeps the low 32 bits exact) and masks with
``& 0xFFFFFFFF``.  No fallback between the two.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from ._build import Kernel

__all__ = ["words_u32", "word_checksum", "row_checksums",
           "row_checksums_plain", "payload_checksum",
           "hop_weight", "conservation_ok", "replica_consistent",
           "page_checksums", "page_checksums_plain",
           "gathered_page_checksums", "zero_carry", "ROW_CHECKSUMS"]

MASK32 = 0xFFFFFFFF
_VIEW = {4: torch.int32, 2: torch.int16, 1: torch.uint8}
# arrays a launch takes: its table rides in the kernel's parameters (4 KB)
MAX_ARRAYS = 96


class _Entry(ctypes.Structure):
    """One array of a launch (``csrc/checksum.cu`` ``Entry``)."""
    _fields_ = [("ptr", ctypes.c_void_p), ("row_stride", ctypes.c_longlong),
                ("words", ctypes.c_longlong), ("esize", ctypes.c_int),
                ("mult", ctypes.c_uint)]


ROW_CHECKSUMS = Kernel("row_checksums", "checksum.cu", "row_checksums_launch",
                       [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                        ctypes.c_longlong, ctypes.c_void_p])


def _esize(x: torch.Tensor) -> int:
    size = x.element_size()
    if size not in _VIEW:
        raise TypeError(f"no checksummed payload may have itemsize {size} "
                        f"(dtype {x.dtype})")
    return size


def words_u32(x: torch.Tensor) -> torch.Tensor:
    """A tensor as a flat int64 vector of its uint32 words (values
    0 .. 2^32-1).  8-byte dtypes are rejected, as in the JAX package."""
    size = _esize(x)
    w = x.reshape(-1).view(_VIEW[size]).to(torch.int64)
    return w & ((1 << (8 * size)) - 1)


def _weights(n: int, device: torch.device) -> torch.Tensor:
    """(2*i + 1) mod 2^32 for i < n, as int64."""
    return ((torch.arange(n, dtype=torch.int64, device=device) << 1) | 1
            ) & MASK32


def _rows(blocks: Sequence[torch.Tensor]) -> int:
    if not blocks:
        raise ValueError("no blocks to checksum")
    rows = blocks[0].shape[0]
    for b in blocks:
        _esize(b)
        if b.dim() == 0 or b.shape[0] != rows:
            raise ValueError(f"every block needs {rows} leading-axis rows, "
                             f"got {tuple(b.shape)}")
    return rows


def row_checksums_plain(blocks: Sequence[torch.Tensor],
                        mults: Optional[Sequence[int]] = None
                        ) -> torch.Tensor:
    """[rows] int64 (uint32 values): ``sum_j mults[j] * chk(blocks[j][r])``
    for each leading-axis row r (word weights restart per row per block;
    ``mults`` default to 2j + 1).  One block at a time, so no int64 copy of
    more than one block is ever formed."""
    _rows(blocks)
    acc = None
    for j, arr in enumerate(blocks):
        mult = 2 * j + 1 if mults is None else mults[j]
        w = words_u32(arr).reshape(arr.shape[0], -1)
        per_row = (w * _weights(w.shape[1], w.device)[None, :]).sum(
            dim=1) & MASK32
        term = (mult * per_row) & MASK32
        acc = term if acc is None else (acc + term) & MASK32
    return acc


def _launch_rows(blocks: Sequence[torch.Tensor],
                 mults: Sequence[int]) -> torch.Tensor:
    rows = blocks[0].shape[0]
    dev = blocks[0].device
    out = torch.zeros(rows, dtype=torch.int32, device=dev)
    views = []
    for b in blocks:
        if b.device != dev:
            raise ValueError("every block must lie on one CUDA device")
        v = b.reshape(rows, -1)
        if v.shape[1] > 1 and v.stride(1) != 1:
            v = v.contiguous()
        views.append(v)
    for g in range(0, len(views), MAX_ARRAYS):
        group = views[g:g + MAX_ARRAYS]
        table = (_Entry * len(group))()
        seg = 0
        for e, v, mult in zip(table, group, mults[g:g + MAX_ARRAYS]):
            size = v.element_size()
            e.ptr, e.words, e.esize = v.data_ptr(), v.shape[1], size
            e.row_stride = v.stride(0) * size
            e.mult = mult & MASK32
            seg = max(seg, v.shape[1] * size)
        if seg == 0 or rows == 0:
            continue
        ROW_CHECKSUMS(ctypes.cast(table, ctypes.c_void_p), len(group), rows,
                      seg, ctypes.c_void_p(out.data_ptr()))
    return out.to(torch.int64) & MASK32


def row_checksums(blocks: Union[torch.Tensor, Sequence[torch.Tensor]],
                  mults: Optional[Sequence[int]] = None) -> torch.Tensor:
    """[rows] int64 (uint32 values): one checksum per leading-axis row of a
    tensor, or summed over a sequence of tensors with the same number of
    rows with odd per-block multipliers (default 2j + 1; a single tensor
    gets 1, its plain word checksum per row).  A CUDA tensor takes the
    kernel (one launch for up to ``MAX_ARRAYS`` blocks), a CPU tensor the
    plain version."""
    if isinstance(blocks, torch.Tensor):
        blocks, mults = [blocks], [1]
    blocks = list(blocks)
    _rows(blocks)
    if mults is None:
        mults = [2 * j + 1 for j in range(len(blocks))]
    if blocks[0].device.type == "cpu":
        return row_checksums_plain(blocks, mults)
    return _launch_rows(blocks, mults)


def word_checksum(x: torch.Tensor) -> torch.Tensor:
    """int64 scalar holding the uint32 checksum of one tensor."""
    return row_checksums(x.reshape(1, -1))[0]


def payload_checksum(payload: Sequence[torch.Tensor]) -> torch.Tensor:
    """int64 scalar over a hop's payload tuple (a codec's encode output,
    or a 1-tuple of the raw array): per-element odd multipliers keep a
    mantissa <-> scale swap from aliasing.  ``row_checksums`` of the
    payload arrays as rank rows ``[n, ...]`` is each rank's."""
    return row_checksums([p.reshape(1, -1) for p in payload])[0]


def hop_weight(s) -> Union[int, torch.Tensor]:
    """Odd per-message weight ``(2s + 1) mod 2^32`` (odd, hence invertible
    mod 2^32: a weighted single-word corruption can never vanish)."""
    return ((s << 1) | 1) & MASK32


def zero_carry(n: int, device: Union[str, torch.device] = "cpu"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(send_acc [n], recv_acc [n]) accumulator pair of a collective."""
    z = torch.zeros(n, dtype=torch.int64, device=device)
    return z, z.clone()


def conservation_ok(send_acc: torch.Tensor,
                    recv_acc: torch.Tensor) -> torch.Tensor:
    """Bool scalar: every message sent on the ring arrived bit-identical.
    ``send_acc`` / ``recv_acc`` [n]: each rank's weighted checksums of what
    it sent and what it received; the ring delivers every message once,
    so ``sum_r (send_r - recv_r) mod 2^32`` is 0 iff no frame changed."""
    return ((send_acc - recv_acc).sum() & MASK32) == 0


def replica_consistent(replicas: torch.Tensor) -> torch.Tensor:
    """Bool scalar: every rank's row of ``replicas [n, ...]`` is
    bit-identical (all row checksums equal).  The exact check of a
    replicating collective whose wire lives inside a kernel: a frame
    corrupted in flight damages its receiver's copy, never the
    contributor's."""
    chk = row_checksums(replicas.reshape(replicas.shape[0], -1))
    return (chk == chk[0]).all()


# ---------------------------------------------------------------------------
# per-page KV-pool checksums (the serving tick's exact tier)
# ---------------------------------------------------------------------------

def gathered_page_checksums(blocks: Sequence[torch.Tensor]) -> torch.Tensor:
    """[n_pages] int64 (uint32 values) — one checksum per leading-axis
    page, summed over the blocks with per-block odd multipliers 2j + 1
    (weights restart per page per block)."""
    return row_checksums(list(blocks))


def _pool_blocks(pool: List[Dict[str, torch.Tensor]]) -> List[torch.Tensor]:
    return [layer[key] for layer in pool for key in ("k", "v")]


def page_checksums(pool: List[Dict[str, torch.Tensor]]) -> torch.Tensor:
    """[n_pages] int64 (uint32 values) — one exact checksum per KV-pool
    page over every layer's K and V bytes of that page, layer-major, K
    before V (the JAX package's block order).  A zero-filled pool
    checksums to all zeros, so a fresh ledger is zeros.  On the card: one
    launch over the whole pool."""
    return gathered_page_checksums(_pool_blocks(pool))


def page_checksums_plain(pool: List[Dict[str, torch.Tensor]]
                         ) -> torch.Tensor:
    """The plain version of ``page_checksums``, on any device."""
    return row_checksums_plain(_pool_blocks(pool))
