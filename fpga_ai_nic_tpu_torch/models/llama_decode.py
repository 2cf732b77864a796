"""Incremental (KV-cache) decoding for the Llama family — the port of the
JAX package's ``models/llama_decode.py``.  A MoE layer runs the MoE FFN on
the call's tokens, no ep: capacity is over all ``B T`` tokens of the call,
idle and padded rows included, in token-major order, as JAX's does at the
same shapes.

With ``tp_axis`` (JAX's tp branches) ``params`` is the list of the tp
ranks' trees (``llama.param_specs(cfg, tp_axis="tp", ep_axis=None,
tp_size=tp)``); as in training, the tp ranks' heads attend in one call
(rank r's kv heads, or under kv-head replication its one sliced head,
``llama._kv_rep_slice``), ``wo`` and ``w2`` are row-parallel with the
partials added in rank order, and the logits are gathered over tp, so
every rank would argmax the same rows.  A cache or pool then holds every
rank's kv heads on its heads axis, ``kv_local_heads(cfg, tp) * tp`` of
them, rank r's the r-th block: JAX's global pool, sharded on that axis.

Two caches: ``init_cache`` allocates a contiguous ``[B, kv, max_seq, hd]``
cache per layer for ``forward``/``generate``; the serving plane's
``forward_paged`` reads and writes one shared page pool per layer
(``serve.paged.init_pool``) through a per-slot page table.  PyTorch runs
eagerly, so ``generate``'s decode loop is a Python loop of ``forward``
calls, and both forwards update their cache IN PLACE where the JAX
versions return a new one.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from ..device import DeviceLike, resolve_device
from ..ops import moe as moe_ops
from . import llama
from .llama import LlamaConfig

Cache = List[Dict[str, torch.Tensor]]


def kv_local_heads(cfg: LlamaConfig, tp_size: int = 1) -> int:
    """Per-rank KV head count: n_kv/tp, or 1 under kv-head replication
    (tp > n_kv)."""
    if cfg.n_kv_heads % tp_size == 0:
        return cfg.n_kv_heads // tp_size
    if tp_size % cfg.n_kv_heads == 0:
        return 1
    raise ValueError(
        f"tp={tp_size} must divide n_kv_heads={cfg.n_kv_heads}, or be "
        f"a multiple of it (kv-head replication)")


def init_cache(cfg: LlamaConfig, batch: int, max_seq: int, *,
               dtype: Optional[str] = None, device: DeviceLike = "cuda",
               tp_size: int = 1) -> Cache:
    """Per-layer K/V cache [B, kv, max_seq, head_dim], zero-filled; with
    ``tp_size`` every tp rank's kv heads, ``kv_local_heads(cfg, tp) * tp``
    (JAX's per-rank cache, ``init_cache(tp_size=)``, is one block of it).
    The whole extent is allocated up front for every layer, K and V: the
    right trade for one fixed-shape ``generate()`` call, the wrong one for
    a serving plane (see ``serve.paged.init_pool``)."""
    dev = resolve_device(device)
    dt = getattr(torch, dtype or cfg.dtype)
    shape = (batch, kv_local_heads(cfg, tp_size) * tp_size, max_seq,
             cfg.head_dim)
    return [{"k": torch.zeros(shape, dtype=dt, device=dev),
             "v": torch.zeros(shape, dtype=dt, device=dev)}
            for _ in range(cfg.n_layers)]


def _cached_attend(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                   pos: Union[int, torch.Tensor], n_heads: int, n_kv: int,
                   sm_scale: float) -> torch.Tensor:
    """q: [B,H,T,hd] (T tokens this call, ending at position pos+T-1);
    ck/cv: [B,Hkv,Smax,hd] cache AFTER this call's keys were written.
    Scores the whole cache with a mask: key j is visible to query t iff
    j <= pos + t.  ``pos`` is a scalar (the whole batch at one position)
    or a [B] vector (each sequence at its own position).  GQA goes through
    a grouped contraction, so the cache is read once per KV head.
    Returns f32 [B,H,T,hd]."""
    B, H, T, hd = q.shape
    Smax = ck.shape[2]
    G = n_heads // n_kv
    qg = q.to(torch.float32).reshape(B, n_kv, G, T, hd)
    s = torch.einsum("bkgtd,bkjd->bkgtj", qg,
                     ck.to(torch.float32)) * sm_scale
    j = torch.arange(Smax, dtype=torch.int32, device=q.device)
    t = torch.arange(T, dtype=torch.int32, device=q.device)
    pos = torch.as_tensor(pos, dtype=torch.int32, device=q.device)
    if pos.ndim == 0:
        visible = j[None, :] <= (pos + t)[:, None]               # [T,Smax]
    else:
        visible = (j[None, None, :]
                   <= (pos[:, None] + t[None, :])[:, :, None])   # [B,T,Smax]
        visible = visible[:, None, None]
    s = torch.where(visible, s, torch.tensor(-1e30, dtype=torch.float32,
                                             device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgtj,bkjd->bkgtd", p, cv.to(torch.float32))
    return out.reshape(B, H, T, hd)


def _ffn(lyr: Any, h: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    """SwiGLU (silu in f32, back to the activation dtype), or the MoE FFN
    over h's tokens (its aux is training's, dropped here); ``lyr`` the
    layer or its tp ranks' layers, whose partials are summed."""
    lyrs = llama._units(lyr)
    if "moe" in lyrs[0]:
        y, _ = moe_ops.moe_ranks(lyrs[0]["moe"]["wr"],
                                 llama._moe_shards([lyrs]), h[None],
                                 cfg.moe, len(lyrs))
        return y[0]
    return llama._dense_ffn(lyr, h)


def _heads(params: Any, tp_axis: Optional[str], cfg: LlamaConfig
           ) -> Tuple[int, int, int]:
    """(tp, the per-rank kv heads of ``_shard_counts`` (0: replicated),
    every rank's query heads, every rank's kv heads)."""
    tp = llama._check_tp(params, tp_axis)
    n_heads, n_kv = llama._shard_counts(cfg, tp)
    return n_kv, n_heads * tp, max(n_kv, 1) * tp


def _logits(params: Any, x: torch.Tensor, cfg: LlamaConfig,
            tp_axis: Optional[str]) -> torch.Tensor:
    """The head; with tp, the vocab shards gathered (JAX's all_gather)."""
    logits = llama._head(params, x, cfg)
    return torch.cat(logits, dim=-1) if tp_axis is not None else logits


def forward(params: Any, tokens: torch.Tensor, cache: Cache,
            pos: int, cfg: LlamaConfig, *, tp_axis: Optional[str] = None
            ) -> Tuple[torch.Tensor, Cache]:
    """Run ``tokens [B, T]`` (positions pos..pos+T-1) through the decoder,
    writing their K/V into ``cache`` in place and reading it back.
    Returns (logits [B, T, vocab], cache).  ``tp_axis``: params the tp
    ranks' trees, the cache every rank's kv heads (``init_cache(...,
    tp_size=)``)."""
    B, T = tokens.shape
    Hd = cfg.head_dim
    n_kv_rank, n_heads, n_kv = _heads(params, tp_axis, cfg)
    sm_scale = Hd ** -0.5
    pos = int(pos)
    positions = pos + llama._positions(T, device=tokens.device)

    x = llama._units(params)[0]["tok_emb"][tokens.long()]
    for i, c in enumerate(cache):
        lyr = llama._layer(params, i)
        lyrs = llama._units(lyr)
        h = llama._rmsnorm(x, lyrs[0]["attn_norm"], cfg.norm_eps)
        q, k, v = llama._qkv(lyrs, h, cfg, n_kv_rank)
        q = q.reshape(B, T, n_heads, Hd).transpose(1, 2)
        k = k.reshape(B, T, n_kv, Hd).transpose(1, 2)
        v = v.reshape(B, T, n_kv, Hd).transpose(1, 2)
        q = llama._rope(q, positions, cfg)
        k = llama._rope(k, positions, cfg)
        c["k"][:, :, pos:pos + T] = k.to(c["k"].dtype)
        c["v"][:, :, pos:pos + T] = v.to(c["v"].dtype)
        att = _cached_attend(q, c["k"], c["v"], pos, n_heads, n_kv, sm_scale)
        att = att.to(x.dtype).transpose(1, 2).reshape(B, T, n_heads * Hd)
        x = x + llama._out_proj(att, lyrs)
        h = llama._rmsnorm(x, lyrs[0]["mlp_norm"], cfg.norm_eps)
        x = x + _ffn(lyr, h, cfg)
    return _logits(params, x, cfg, tp_axis), cache


def _rope_rows(x: torch.Tensor, pos: torch.Tensor,
               cfg: LlamaConfig) -> torch.Tensor:
    """Rotate-half rope with per-sequence positions: x [B,H,T,dh], pos
    [B,T].  The same elementwise formula as ``llama._rope``, so a
    row-constant grid gives the same bits."""
    half = x.shape[-1] // 2
    freqs = llama._rope_freqs(cfg, half, x.device)
    ang = pos.to(torch.float32)[:, :, None] * freqs[None, None, :]
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]  # [B,1,T,h]
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


ATTEND_IMPLS = ("kernel", "reference")


def forward_paged(params: Any, tokens: torch.Tensor, pool: Cache,
                  page_table: torch.Tensor, pos: torch.Tensor,
                  cfg: LlamaConfig, *, page_size: int,
                  tp_axis: Optional[str] = None,
                  active: Optional[torch.Tensor] = None,
                  attend_impl: str = "kernel") -> Tuple[torch.Tensor, Cache]:
    """Paged-KV forward — the serving plane's prefill and decode path.

    ``tokens [R, T]``: R request slots, T tokens each (1 for decode, the
    chunk for chunked prefill); ``pos [R]``: each slot's position of its
    first token this call; ``pool``: per-layer ``{"k","v"}`` pages
    ``[n_pages, kv, page_size, hd]`` shared by every slot;
    ``page_table [R, P]`` int32: page ``page_table[r, i]`` holds slot r's
    positions ``[i*page_size, (i+1)*page_size)``; ``active [R]`` bool
    (None = all) gates K/V writes — inactive slots write zeros into the
    null page 0 and their logits are garbage the host ignores.

    The pool is updated IN PLACE (``index_put_``), where the JAX version
    returns a new pool (``.at[...].set``); the returned pool is the one
    passed in.  Two classes of writes are redirected to the null page:
    inactive slots, and positions past the table's span (a final prefill
    chunk's padding), which would otherwise alias onto a live page.

    ``attend_impl``: ``"kernel"`` (default) calls
    ``ops.paged_attend.paged_gather_attend``, which launches the CUDA
    kernel for card tensors and takes its plain version for CPU tensors;
    ``"reference"`` forms the gathered ``[R, kv, P*page_size, hd]`` view
    and runs ``_cached_attend`` on it — an explicit request (tests, the
    card smoke's comparison), never a fallback.  With ``"reference"`` the
    logits are bit-equal to ``forward()`` over a contiguous cache of
    ``P*page_size`` positions for the same token stream and chunk
    schedule, for any page assignment and a dirty pool: masked positions
    score exactly -1e30 in both, their softmax weights are exactly 0, and
    0 times a finite value never moves an f32 sum.  ``tp_axis``: params
    the tp ranks' trees and the pool every rank's kv heads
    (``serve.paged.init_pool(..., tp_size=)``), which one kernel call
    attends."""
    if attend_impl not in ATTEND_IMPLS:
        raise ValueError(f"forward_paged: unknown attend_impl="
                         f"{attend_impl!r}; expected one of {ATTEND_IMPLS}")
    from ..ops import paged_attend

    R, T = tokens.shape
    Hd = cfg.head_dim
    P = page_table.shape[1]
    n_kv_rank, n_heads, n_kv = _heads(params, tp_axis, cfg)
    sm_scale = Hd ** -0.5
    dev = tokens.device
    pos = torch.as_tensor(pos, dtype=torch.int32, device=dev)
    pos_grid = pos[:, None] + torch.arange(T, dtype=torch.int32,
                                           device=dev)[None, :]
    page_of = torch.gather(page_table, 1,
                           torch.clamp(pos_grid // page_size,
                                       max=P - 1).long())
    if active is None:
        act = torch.ones((R,), dtype=torch.bool, device=dev)
    else:
        act = torch.as_tensor(active, dtype=torch.bool, device=dev)
    in_range = pos_grid < P * page_size
    page_of = torch.where(act[:, None] & in_range, page_of,
                          torch.zeros_like(page_of))
    flat_pages = page_of.reshape(-1).long()
    flat_offs = (pos_grid % page_size).reshape(-1).long()
    gate = act[:, None, None, None]

    x = llama._units(params)[0]["tok_emb"][tokens.long()]
    for i, pl in enumerate(pool):
        lyr = llama._layer(params, i)
        lyrs = llama._units(lyr)
        h = llama._rmsnorm(x, lyrs[0]["attn_norm"], cfg.norm_eps)
        q, k, v = llama._qkv(lyrs, h, cfg, n_kv_rank)
        q = q.reshape(R, T, n_heads, Hd).transpose(1, 2)
        k = k.reshape(R, T, n_kv, Hd).transpose(1, 2)
        v = v.reshape(R, T, n_kv, Hd).transpose(1, 2)
        q = _rope_rows(q, pos_grid, cfg)
        k = _rope_rows(k, pos_grid, cfg)
        pk, pv = pl["k"], pl["v"]
        zero = torch.zeros((), dtype=k.dtype, device=dev)
        kw = torch.where(gate, k, zero).to(pk.dtype).transpose(1, 2)
        vw = torch.where(gate, v, zero).to(pv.dtype).transpose(1, 2)
        # [n_pages, page_size, kv, hd] views: one (page, offset) pair per
        # (slot, token) row
        pk.transpose(1, 2).index_put_((flat_pages, flat_offs),
                                      kw.reshape(R * T, n_kv, Hd))
        pv.transpose(1, 2).index_put_((flat_pages, flat_offs),
                                      vw.reshape(R * T, n_kv, Hd))
        if attend_impl == "kernel":
            att = paged_attend.paged_gather_attend(
                q, pk, pv, page_table, pos, page_size=page_size,
                sm_scale=sm_scale)
        else:
            idx = page_table.long()
            ck = pk[idx].transpose(1, 2).reshape(R, n_kv, P * page_size, Hd)
            cv = pv[idx].transpose(1, 2).reshape(R, n_kv, P * page_size, Hd)
            att = _cached_attend(q, ck, cv, pos, n_heads, n_kv, sm_scale)
        att = att.to(x.dtype).transpose(1, 2).reshape(R, T, n_heads * Hd)
        x = x + llama._out_proj(att, lyrs)
        h = llama._rmsnorm(x, lyrs[0]["mlp_norm"], cfg.norm_eps)
        x = x + _ffn(lyr, h, cfg)
    return _logits(params, x, cfg, tp_axis), pool


def generate(params: Any, prompt: torch.Tensor, n_new: int,
             cfg: LlamaConfig, *, max_seq: Optional[int] = None,
             tp_axis: Optional[str] = None, temperature: float = 0.0,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Greedy (temperature=0) or sampled generation over a contiguous
    cache.  prompt: [B, S0] int; returns int32 [B, S0 + n_new].  One
    prefill call, then one ``forward`` per new token.  Sampling draws from
    ``generator`` (torch's, so the samples are not JAX's).  ``tp_axis``:
    params the tp ranks' trees, the cache every rank's kv heads."""
    B, S0 = prompt.shape
    if n_new <= 0:
        return prompt
    max_seq = max_seq or (S0 + n_new)
    if max_seq < S0 + n_new:
        raise ValueError(f"max_seq={max_seq} < prompt {S0} + n_new {n_new}")
    tp = llama._check_tp(params, tp_axis)
    llama._shard_counts(cfg, tp)
    cache = init_cache(cfg, B, max_seq, device=prompt.device, tp_size=tp)

    def pick(logits_last: torch.Tensor) -> torch.Tensor:
        if temperature == 0.0:
            return torch.argmax(logits_last, dim=-1).to(torch.int32)
        probs = torch.softmax(logits_last.to(torch.float32) / temperature,
                              dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
            torch.int32)

    logits, cache = forward(params, prompt, cache, 0, cfg, tp_axis=tp_axis)
    toks = [pick(logits[:, -1])]
    for i in range(n_new - 1):
        logits, cache = forward(params, toks[-1][:, None], cache, S0 + i,
                                cfg, tp_axis=tp_axis)
        toks.append(pick(logits[:, -1]))
    return torch.cat([prompt.to(torch.int32), torch.stack(toks, 1)], 1)
