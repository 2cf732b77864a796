"""Paged gather-attend: the serving plane's attention over the shared K/V
page pool — the port of the JAX package's ``ops/paged_attend_pallas.py``.

``paged_gather_attend`` keeps the JAX signature.  For tensors on the CPU it
takes the plain version, ``paged_gather_attend_plain`` (the gathered
``[R, kv, P*page_size, hd]`` view and ``llama_decode._cached_attend``, the
reference path of ``forward_paged``).  For tensors on CUDA it launches the
kernel of ``csrc/paged_attend.cu``, which walks the page table and reads
only the live pages, so the gathered view is never formed; it takes the
serving path's bfloat16 pools at head_dim 128 and raises on anything
else.  There is no fallback between the two.  ``PAGED_ATTEND.launches``
counts kernel launches, one per call.

The one C entry holds two designs, picked here by the regime:

- decode (T == 1, at most ``DECODE_MAX_ROWS`` query heads a KV head): the
  live keys of each (slot, KV head) split into chunks of
  ``DECODE_CHUNK_KEYS`` keys (whole pages) over blocks, f32 on the CUDA
  cores, the chunks' partial softmax states combined in chunk order by the
  last block to finish (``_decode_counters`` are its per-(slot, head)
  arrival counters, which the kernel leaves at zero);
- prefill (everything else): the flash forward's tensor-core mainloop
  (``csrc/attn_fwd.cuh``) over 64-key tiles gathered through the table.
  q enters the products as bf16 terms hi + lo (``q_terms`` 2), or hi alone
  where q came in as bf16 (its lo term is exactly zero), and p as hi + lo.
  Emulated on the CPU (``tests/test_torch_paged_attend.py``) at the
  serving path's prefill shapes, the two terms stay within about 2e-6 of
  the plain version, against ``PAGED_TOL`` = 5e-5.

The kernels sum in another order than the plain version (online softmax
over key tiles; bf16 terms on the tensor cores), so the two agree within
that limit, not bit for bit.  Two launches on the same inputs give the
same bits: no sum depends on the order in which blocks finish.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from ._build import Kernel, ptr
from .bfp_cuda import check_cuda

KERNEL_HEAD_DIM = 128          # Llama-3's; the kernel is built for it alone

PAGED_ATTEND = Kernel(
    "paged_attend", "paged_attend.cu", "paged_attend_launch",
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 + [ctypes.c_float])

DECODE_CHUNK_KEYS = 256        # keys a decode block streams (whole pages)
DECODE_MAX_ROWS = 8            # query heads a KV head the decode kernel takes

_COUNTERS: Dict[torch.device, torch.Tensor] = {}


def decode_split(T: int, G: int, page_size: int, P: int) -> int:
    """Pages per decode chunk, or 0 where the call takes the prefill
    kernel (T > 1, or more than ``DECODE_MAX_ROWS`` rows a KV head)."""
    if T != 1 or G > DECODE_MAX_ROWS:
        return 0
    return min(P, max(1, DECODE_CHUNK_KEYS // page_size))


def _decode_counters(device: torch.device, n: int) -> torch.Tensor:
    """n int32 zeros on the device, kept between calls (the kernel resets
    each counter it uses)."""
    c = _COUNTERS.get(device)
    if c is None or c.numel() < n:
        c = torch.zeros(n, dtype=torch.int32, device=device)
        _COUNTERS[device] = c
    return c


def _validate(q: torch.Tensor, pool_k: torch.Tensor, pool_v: torch.Tensor,
              page_table: torch.Tensor, pos: torch.Tensor,
              page_size: int) -> None:
    """The JAX wrapper's checks, without its 128-lane rule (a TPU tiling
    constraint the CUDA kernel does not have)."""
    if q.ndim != 4:
        raise ValueError(f"paged_gather_attend: q must be [R, H, T, hd], "
                         f"got {tuple(q.shape)}")
    R, H, _T, hd = q.shape
    if pool_k.shape != pool_v.shape or pool_k.ndim != 4:
        raise ValueError(
            "paged_gather_attend: K/V pools must share one "
            f"[n_pages, kv, page_size, hd] shape, got k={tuple(pool_k.shape)} "
            f"v={tuple(pool_v.shape)}")
    n_kv = pool_k.shape[1]
    if pool_k.shape[2] != page_size or pool_k.shape[3] != hd:
        raise ValueError(
            f"paged_gather_attend: pool pages {tuple(pool_k.shape)} do not "
            f"match page_size={page_size}, head_dim={hd}")
    if n_kv == 0 or H % n_kv != 0:
        raise ValueError(
            f"paged_gather_attend: n_heads={H} must be a multiple of "
            f"the pool's kv heads={n_kv} (GQA head-group mapping)")
    if page_table.ndim != 2 or page_table.shape[0] != R:
        raise ValueError(
            f"paged_gather_attend: page_table must be [R={R}, P], got "
            f"{tuple(page_table.shape)}")
    if page_table.dtype != torch.int32:
        raise ValueError(
            "paged_gather_attend: page_table must be int32 (the walked "
            f"table), got {page_table.dtype}")
    if tuple(pos.shape) != (R,):
        raise ValueError(
            f"paged_gather_attend: pos must be [R={R}], got "
            f"{tuple(pos.shape)}")


def paged_gather_attend_plain(q: torch.Tensor, pool_k: torch.Tensor,
                              pool_v: torch.Tensor, page_table: torch.Tensor,
                              pos: torch.Tensor, *, page_size: int,
                              sm_scale: Optional[float] = None
                              ) -> torch.Tensor:
    """The gathered view plus ``_cached_attend``: f32 [R, H, T, hd]."""
    from ..models.llama_decode import _cached_attend
    pos = torch.as_tensor(pos, dtype=torch.int32, device=q.device)
    _validate(q, pool_k, pool_v, page_table, pos, page_size)
    R, H, _T, hd = q.shape
    n_kv = pool_k.shape[1]
    P = page_table.shape[1]
    if sm_scale is None:
        sm_scale = hd ** -0.5
    idx = page_table.long()
    ck = pool_k[idx].transpose(1, 2).reshape(R, n_kv, P * page_size, hd)
    cv = pool_v[idx].transpose(1, 2).reshape(R, n_kv, P * page_size, hd)
    return _cached_attend(q, ck, cv, pos, H, n_kv, sm_scale)


def paged_gather_attend(q: torch.Tensor, pool_k: torch.Tensor,
                        pool_v: torch.Tensor, page_table: torch.Tensor,
                        pos: torch.Tensor, *, page_size: int,
                        sm_scale: Optional[float] = None) -> torch.Tensor:
    """Paged-KV attention without the gathered view.

    q: [R, H, T, hd] (post-rope, any float dtype — scored in f32);
    pool_k/pool_v: [n_pages, kv, page_size, hd] (the pool AFTER this
    call's K/V writes); page_table: [R, P] int32; pos: [R] int32, each
    slot's position of its first token this call.  Returns f32
    [R, H, T, hd]: row g*T + t of KV head kh (head kh*G + g) sees key j iff
    j <= pos + t."""
    if q.device.type == "cpu":
        return paged_gather_attend_plain(q, pool_k, pool_v, page_table, pos,
                                         page_size=page_size,
                                         sm_scale=sm_scale)
    pos = torch.as_tensor(pos, dtype=torch.int32, device=q.device
                          ).contiguous()
    _validate(q, pool_k, pool_v, page_table, pos, page_size)
    R, H, T, hd = q.shape
    n_pages, n_kv = pool_k.shape[:2]
    if hd != KERNEL_HEAD_DIM:
        raise ValueError(f"the paged_attend kernel takes head_dim "
                         f"{KERNEL_HEAD_DIM}, got {hd}")
    if sm_scale is None:
        sm_scale = hd ** -0.5
    qf = q.to(torch.float32).contiguous()
    table = page_table.contiguous()
    check_cuda(qf, torch.float32, "q")
    check_cuda(pool_k, torch.bfloat16, "pool_k")
    check_cuda(pool_v, torch.bfloat16, "pool_v")
    for t, name in ((table, "page_table"), (pos, "pos")):
        if not (t.is_cuda and t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous CUDA tensor")
    out = torch.empty((R, H, T, hd), dtype=torch.float32, device=q.device)
    P = table.shape[1]
    G = H // n_kv
    chunk_pages = decode_split(T, G, page_size, P)
    if chunk_pages:
        n_chunks = -(-P // chunk_pages)
        part = torch.empty(R * n_kv * n_chunks * G * (hd + 2),
                           dtype=torch.float32, device=q.device)
        counters = _decode_counters(q.device, R * n_kv)
    else:
        part = counters = out              # unread by the prefill kernel
    q_terms = 1 if q.dtype == torch.bfloat16 else 2
    PAGED_ATTEND(ptr(qf), ptr(pool_k), ptr(pool_v), ptr(table), ptr(pos),
                 ptr(out), ptr(part), ptr(counters), R, H, n_kv, T, hd, P,
                 page_size, n_pages, q_terms, chunk_pages, float(sm_scale))
    return out
