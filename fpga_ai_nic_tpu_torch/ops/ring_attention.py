"""Exact attention in plain torch and the route to the flash kernels — the
single-device part of the JAX package's ``ops/ring_attention.py``.

``full_attention`` is the direct softmax; ``flash_attention`` the same
online-softmax accumulation over key blocks that the ring variants use
(peak score memory O(S * k_block)); ``flash_attention_remat`` picks the
fused flash kernels (``ops.flash_attention``) or the blocked torch path
under ``torch.utils.checkpoint``, as the JAX function picks Pallas or
``jax.checkpoint``.  ``pallas_route`` is that choice; "pallas" names the
port's CUDA kernels, as ``BFPConfig(codec="pallas")`` does.

Sequence parallelism (``ring_attention``, ``gathered_attention``) needs a
mesh the port does not have yet and raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from . import flash_attention as flash_ops

_NEG = -1e30
_SP_ITEM = ("sequence parallelism (sp) is not ported yet: ROADMAP A.6 "
            "(ring_flash_attention and the sp mesh axis)")


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


def ring_attention(q, k, v, axis_name: str, **kw):
    """Sequence-parallel ring attention: not ported."""
    raise NotImplementedError(_SP_ITEM)


def gathered_attention(q, k, v, axis_name: str, **kw):
    """Sequence-parallel attention by K/V all-gather: not ported."""
    raise NotImplementedError(_SP_ITEM)
