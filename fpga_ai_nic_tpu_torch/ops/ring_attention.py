"""Exact attention in plain torch, its sequence-parallel forms and the
route to the flash kernels — the port of the JAX package's
``ops/ring_attention.py``.

``full_attention`` is the direct softmax; ``flash_attention`` the same
online-softmax accumulation over key blocks that the ring variants use
(peak score memory O(S * k_block)); ``flash_attention_remat`` picks the
fused flash kernels (``ops.flash_attention``) or the blocked torch path
under ``torch.utils.checkpoint``, as the JAX function picks Pallas or
``jax.checkpoint``.  ``pallas_route`` is that choice; "pallas" names the
port's CUDA kernels, as ``BFPConfig(codec="pallas")`` does.

Sequence parallelism (``ring_attention``, ``gathered_attention``) runs
over n sp ranks stacked as the leading dimension of q, k and v (the port's
virtual ranks, as ``parallel.mesh.VirtualRanks`` stacks dp): q [n, B, H,
Sl, dh], k/v [n, B, Hkv, Sl, dh], rank i holding global positions
[i Sl, (i + 1) Sl); ``axis_name`` names that axis, as JAX's names the mesh
axis.  A ring hop is ``flash_attention.rotate``, JAX's ``lax.ppermute``;
the all-gather is one [B, Hkv, n Sl, dh] copy every rank reads.  The plain
route takes repeat-expanded K/V (Hkv = H), the kernels grouped ones.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from . import flash_attention as flash_ops

_NEG = -1e30


def _init_acc(B: int, H: int, S: int, dh: int, device):
    """Fresh online-softmax accumulators: running max, normalizer, output."""
    return (torch.full((B, H, S, 1), _NEG, dtype=torch.float32,
                       device=device),
            torch.zeros((B, H, S, 1), dtype=torch.float32, device=device),
            torch.zeros((B, H, S, dh), dtype=torch.float32, device=device))


def _finish(o: torch.Tensor, l: torch.Tensor,
            out_dtype: torch.dtype) -> torch.Tensor:
    """Normalize the accumulated output; rows with no visible keys keep a
    zero output."""
    return (o / torch.where(l == 0, torch.ones_like(l), l)).to(out_dtype)


def _block_attend(q, k, v, q_pos, k_pos, m, l, o, sm_scale, causal):
    """One online-softmax step against a K/V block.  q, k: f32
    [B,H,Sq,dh] / [B,H,Sk,dh]; positions [Sq] / [Sk]; m, l [B,H,Sq,1]."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * sm_scale
    if causal:
        s = s.masked_fill(k_pos[None, :] > q_pos[:, None], _NEG)
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new)
    l_new = l * alpha + p.sum(dim=-1, keepdim=True)
    o_new = o * alpha + torch.einsum("bhqk,bhkd->bhqd", p,
                                     v.to(torch.float32))
    return m_new, l_new, o_new


def _attend_chunk(qf, k, v, q_pos, k_pos0: int, m, l, o, sm_scale, causal,
                  k_block: Optional[int]):
    """Online-softmax accumulation against one K/V chunk in blocks of
    ``k_block`` keys (the largest divisor of the chunk <= k_block; None or
    >= S takes it whole).  Past four blocks each block's scores are
    recomputed in the backward instead of kept, as ``jax.checkpoint`` of
    the scan step does."""
    S = k.shape[2]
    if k_block is not None and S % k_block:
        k_block = next(d for d in range(min(k_block, S), 0, -1) if S % d == 0)
    if k_block is None or k_block >= S:
        k_pos = k_pos0 + torch.arange(S, device=k.device)
        return _block_attend(qf, k.to(torch.float32), v, q_pos, k_pos,
                             m, l, o, sm_scale, causal)

    def step(m, l, o, ks, vs, kp):
        return _block_attend(qf, ks.to(torch.float32), vs, q_pos, kp,
                             m, l, o, sm_scale, causal)

    remat_blocks = S // k_block > 4
    for j in range(S // k_block):
        sl = slice(j * k_block, (j + 1) * k_block)
        kp = k_pos0 + j * k_block + torch.arange(k_block, device=k.device)
        args = (m, l, o, k[:, :, sl], v[:, :, sl], kp)
        if remat_blocks:
            m, l, o = checkpoint(step, *args, use_reentrant=False)
        else:
            m, l, o = step(*args)
    return m, l, o


def pallas_route(impl: str, q: torch.Tensor,
                 kv_seq_len: Optional[int] = None) -> bool:
    """Attention-backend dispatch: the flash kernels when pinned
    ("pallas") or, for "auto", on a CUDA tensor whose shape tiles
    (``flash_attention.kernels_take``), as the JAX route takes Pallas
    under "auto" on a TPU with tiling shapes.  The dtype and head_dim pick
    the kernel family inside ``flash_attention``, never the route.
    Pinned-but-unsupported raises; a CUDA tensor no kernel takes (a dtype
    outside float32, bfloat16 and float16) raises in the kernel wrapper:
    nothing falls back."""
    shape = tuple(q.shape)
    if impl not in ("auto", "pallas", "xla"):
        raise ValueError(f"attn impl {impl!r}: want auto|pallas|xla")
    if impl == "pallas" and not flash_ops.supported(shape,
                                                    kv_seq_len=kv_seq_len):
        raise ValueError(
            f"impl='pallas' pinned but q shape {shape} / kv_seq_len="
            f"{kv_seq_len} does not tile (need S % 128 == 0, "
            "head_dim % 8 == 0, head_dim <= 256, Sk % 128 == 0)")
    return impl == "pallas" or (impl == "auto" and flash_ops.kernels_take(
        shape, q.device.type, kv_seq_len=kv_seq_len))


def full_attention(q, k, v, *, causal=True, sm_scale=None):
    """Unsharded direct-softmax reference, f32 scores; q's dtype out."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) * sm_scale
    S = q.shape[2]
    if causal:
        pos = torch.arange(S, device=q.device)
        s = s.masked_fill(pos[None, :] > pos[:, None], _NEG)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p,
                        v.to(torch.float32)).to(q.dtype)


def flash_attention(q, k, v, *, causal=True, sm_scale=None,
                    k_block: Optional[int] = 512):
    """Single-device flash-blocked exact attention in torch: the
    ``_attend_chunk`` accumulation with no collectives; differs from
    ``full_attention`` by f32 summation order only."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    B, H, S, dh = q.shape
    pos = torch.arange(S, device=q.device)
    m0, l0, o0 = _init_acc(B, H, S, dh, q.device)
    m, l, o = _attend_chunk(q.to(torch.float32), k, v, pos, 0, m0, l0, o0,
                            sm_scale, causal, k_block)
    return _finish(o, l, q.dtype)


def flash_attention_remat(q, k, v, *, causal=True, sm_scale=None,
                          k_block: Optional[int] = 512, impl: str = "auto"):
    """Memory-bounded exact attention for model code: the flash kernels
    (their backward recomputes p from the saved lse, so no checkpoint is
    needed), or the blocked torch path under attention-only
    ``torch.utils.checkpoint``."""
    if pallas_route(impl, q, kv_seq_len=k.shape[2]):
        b = k_block or flash_ops._DEF_BLOCK
        return flash_ops.flash_attention(q, k, v, causal=causal,
                                         sm_scale=sm_scale, block_q=b,
                                         block_k=b)
    return checkpoint(
        lambda q2, k2, v2: flash_attention(q2, k2, v2, causal=causal,
                                           sm_scale=sm_scale,
                                           k_block=k_block),
        q, k, v, use_reentrant=False)


def _positions(i: int, S: int, device) -> torch.Tensor:
    """Global positions of sp rank i's S rows."""
    return i * S + torch.arange(S, device=device)


def ring_attention(q, k, v, axis_name: str, *, causal: bool = True,
                   sm_scale: Optional[float] = None,
                   k_block: Optional[int] = 512, unroll: bool = False,
                   impl: str = "auto"):
    """Sequence-parallel exact attention over the stacked sp ranks: q, k,
    v [n, B, H, Sl, dh] (k/v grouped, [n, B, Hkv, Sl, dh], on the kernel
    route) -> [n, B, H, Sl, dh] in q's dtype.

    "auto" takes ``flash_attention.ring_flash_attention`` where
    ``pallas_route`` takes the kernels (the same K/V rotation, per-hop
    flash calls with offsets, logsumexp merge); "xla" pins the plain ring:
    each hop's visiting chunk goes through ``_attend_chunk`` in blocks of
    ``k_block`` keys against global positions, the accumulators in f32,
    one cast at the end; a chunk wholly in a rank's future (src > i) is
    skipped under ``causal``.  ``unroll`` and ``k_block=None`` are the
    plain ring's schedules (JAX's knob rules): "auto" keeps the plain ring
    when either is set, pinned "pallas" rejects them."""
    xla_only_knobs = unroll or k_block is None
    if impl == "pallas" and xla_only_knobs:
        raise ValueError(
            "impl='pallas' cannot honor unroll=True / k_block=None: the "
            "kernel ring is a loop of blocked kernels; drop the knob or use "
            "impl='xla'")
    if not xla_only_knobs and pallas_route(impl, q[0],
                                           kv_seq_len=k.shape[-2]):
        return flash_ops.ring_flash_attention(
            q, k, v, axis_name, causal=causal, sm_scale=sm_scale,
            block_q=k_block, block_k=k_block)
    n, B, H, S, dh = q.shape
    if sm_scale is None:
        sm_scale = dh ** -0.5
    qf = q.to(torch.float32)
    pos = [_positions(i, S, q.device) for i in range(n)]
    acc = [_attend_chunk(qf[i], k[i], v[i], pos[i], i * S,
                         *_init_acc(B, H, S, dh, q.device), sm_scale, causal,
                         k_block) for i in range(n)]
    kc, vc = k, v
    for s in range(1, n):
        kc, vc = flash_ops.rotate(kc), flash_ops.rotate(vc)
        for i in range(n):
            src = (i - s) % n
            if causal and src > i:
                continue
            acc[i] = _attend_chunk(qf[i], kc[i], vc[i], pos[i], src * S,
                                   *acc[i], sm_scale, causal, k_block)
    return torch.stack([_finish(o, l, q.dtype) for _, l, o in acc])


def _all_gather(t: torch.Tensor) -> torch.Tensor:
    """[n, B, h, Sl, dh] stacked shards -> [B, h, n Sl, dh], the sequence
    gathered in rank order (``lax.all_gather(..., axis=2, tiled=True)``;
    every rank reads the one copy, and its gradient sums theirs)."""
    n, B, h, Sl, dh = t.shape
    return t.permute(1, 2, 0, 3, 4).reshape(B, h, n * Sl, dh)


def gathered_attention(q, k, v, axis_name: str, *, causal: bool = True,
                       sm_scale: Optional[float] = None,
                       k_block: Optional[int] = 512, impl: str = "auto"):
    """Sequence-parallel attention by a K/V all-gather over the stacked sp
    ranks: queries stay sharded, K/V are gathered once, and each rank's
    local attention runs against the whole sequence: on the kernel route
    one flash call a rank with ``q_offset = i Sl`` (global-position
    causality), on the plain one ``_attend_chunk`` from position 0.
    Shapes as ``ring_attention``'s."""
    n, B, H, Sl, dh = q.shape
    if sm_scale is None:
        sm_scale = dh ** -0.5
    kf, vf = _all_gather(k), _all_gather(v)
    if pallas_route(impl, q[0], kv_seq_len=kf.shape[2]):
        b = k_block or flash_ops._DEF_BLOCK
        return torch.stack([flash_ops.flash_attention(
            q[i], kf, vf, causal=causal, sm_scale=sm_scale,
            q_offset=i * Sl, block_q=b, block_k=b) for i in range(n)])
    qf = q.to(torch.float32)
    outs = []
    for i in range(n):
        _, l, o = _attend_chunk(qf[i], kf, vf, _positions(i, Sl, q.device),
                                0, *_init_acc(B, H, Sl, dh, q.device),
                                sm_scale, causal, k_block)
        outs.append(_finish(o, l, q.dtype))
    return torch.stack(outs)
