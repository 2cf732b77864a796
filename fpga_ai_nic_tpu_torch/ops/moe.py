"""Mixture-of-experts FFN with expert parallelism over stacked virtual ep
ranks — the port of the JAX package's ``ops/moe.py``.

The semantics are JAX's (GShard/Switch-style, static shapes):

- routing: softmax of f32 logits, top-k, gates renormalised over the k;
- a fixed capacity ``C = ceil(T k / E * capacity_factor)`` a rank, over
  each rank's LOCAL tokens; assignments past it are dropped in token-major
  priority (``cumsum(onehot) - onehot`` over the flattened ``[T k]``), sent
  to slot 0 with weight 0;
- dispatch a scatter-add into ``[E, C, D]``, the SwiGLU per expert (silu in
  f32), combine a gather times ``gates * keep`` in the activation dtype,
  summed over k;
- the load-balance aux ``w E f.p`` over the GLOBAL token set: the counts
  and probability sums of every rank whose tokens the caller pools.

Expert parallelism (JAX: ``moe_ffn(ep_axis=...)`` inside ``shard_map``)
runs over ranks stacked as a leading dimension, as ``parallel.mesh``
stacks every virtual rank: tokens ``[n, B, S, D]``, each rank its own
router copy, expert shard r holding experts ``[r E/ep, (r + 1) E/ep)``
(with sp, the sources are the (ep, sp) devices of a dp rank, ep major).
JAX's two ``lax.all_to_all(split_axis=0, concat_axis=0)`` become a
transpose of the stacked ``[n_src, ep_dst, E/ep, C, D]`` buffer: shard r's
experts see ``[E/ep, n C, D]``, source-major, exactly as JAX reshapes its
received buffer, and the way back is the inverse transpose.  With one
shard (``ep = 1``) the same code runs every rank's buffer through all the
experts in one product.

No hand-written kernel: JAX runs these as XLA scatter, gather and einsums
(no ``pl.pallas_call``), and so does the port (``index_put``, advanced
indexing and ``torch.bmm``).  The router product must be true f32: the
entry points leave ``torch.backends.cuda.matmul.allow_tf32`` off.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Union

import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device
from ..parallel.mesh import Spec

Params = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 2.0   # C = ceil(T*k/E * cf) per rank
    aux_weight: float = 0.01       # load-balance loss weight

    def __post_init__(self):
        if not 1 <= self.top_k <= self.num_experts:
            raise ValueError(f"top_k={self.top_k} must be in [1, "
                             f"num_experts={self.num_experts}]")

    def capacity(self, tokens: int) -> int:
        return max(1, math.ceil(tokens * self.top_k / self.num_experts
                                * self.capacity_factor))


def init_ffn(generator: torch.Generator, dim: int, ffn_dim: int,
             cfg: MoEConfig, dtype: torch.dtype = torch.float32,
             device: DeviceLike = "cuda") -> Params:
    """Router + E SwiGLU experts, drawn in JAX's order of use (wr, w1, w3,
    w2) with its fan-in scaling.  ``wr`` stays f32 (routing logits are
    precision-sensitive); the experts take ``dtype``."""
    dev = resolve_device(device)
    E, D, Fd = cfg.num_experts, dim, ffn_dim

    def normal(fan_in, shape):
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        return w * math.sqrt(1.0 / fan_in)

    wr = normal(D, (D, E)).to(dev)
    w1 = normal(D, (E, D, Fd)).to(dev, dtype)
    w3 = normal(D, (E, D, Fd)).to(dev, dtype)
    w2 = normal(Fd, (E, Fd, D)).to(dev, dtype)
    return {"wr": wr, "w1": w1, "w3": w3, "w2": w2}


def param_specs(ep_axis: Optional[str] = "ep",
                tp_axis: Optional[str] = None) -> Dict[str, Any]:
    """JAX's ``param_specs``: the experts shard over ep on their leading
    (expert) axis, the router replicates (``P("ep", None, None)`` and
    ``P()``).  With ``tp_axis`` each expert's SwiGLU splits its hidden
    over tp as the dense FFN does, ``w1``/``w3`` by column
    (``Spec(ep, None, "tp")``), ``w2`` by row (``Spec(ep, "tp", None)``):
    each tp rank computes a partial expert output over its hidden slice,
    which the layer sums over tp; routing and dispatch are the same on
    every tp rank."""
    if tp_axis is None:
        return {"wr": None, "w1": ep_axis, "w3": ep_axis, "w2": ep_axis}
    col = Spec(ep_axis, None, tp_axis)
    return {"wr": None, "w1": col, "w3": col,
            "w2": Spec(ep_axis, tp_axis, None)}


def _expert_ffn(params: Params, h: torch.Tensor) -> torch.Tensor:
    """h: [E_local, C', D] -> [E_local, C', D], SwiGLU per expert."""
    g = torch.bmm(h, params["w1"])
    u = torch.bmm(h, params["w3"])
    g = F.silu(g.to(torch.float32)).to(h.dtype)
    return torch.bmm(g * u, params["w2"])


class Routing(NamedTuple):
    gates: torch.Tensor    # [n, T, k] renormalised, f32
    e_flat: torch.Tensor   # [n, T k] expert of each assignment
    onehot: torch.Tensor   # [n, T k, E] int32
    keep: torch.Tensor     # [n, T k] bool
    slot: torch.Tensor     # [n, T k] capacity slot (0 where dropped)
    probs: torch.Tensor    # [n, T, E] f32


def _route(wr: torch.Tensor, xf: torch.Tensor, cfg: MoEConfig,
           C: int) -> Routing:
    """Top-k routing and token-major capacity assignment for each rank's
    local tokens ``xf [n, T, D]``; ``wr`` [D, E] shared or [n, D, E] one
    router a rank.  ``torch.sort(stable=True)`` picks ``lax.top_k``'s
    experts: the larger probability first, the lower index on a tie."""
    k = cfg.top_k
    logits = xf.to(torch.float32) @ wr                          # [n, T, E]
    probs = torch.softmax(logits, dim=-1)
    srt, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, eidx = srt[..., :k], order[..., :k]
    gates = gates / gates.sum(dim=-1, keepdim=True)
    e_flat = eidx.reshape(eidx.shape[0], -1)                    # [n, T*k]
    return Routing(gates, e_flat, *assign(e_flat, cfg.num_experts, C),
                   probs)


def assign(e_flat: torch.Tensor, E: int, C: int):
    """Token-major capacity assignment of each rank's ``e_flat [n, T k]``:
    ``(onehot [n, T k, E] int32, keep, slot)``, an assignment kept while
    fewer than C earlier ones chose its expert."""
    onehot = F.one_hot(e_flat, E).to(torch.int32)               # [n,T*k,E]
    prio = torch.cumsum(onehot, dim=1, dtype=torch.int32) - onehot
    pos = (prio * onehot).sum(dim=-1)                           # [n, T*k]
    keep = pos < C
    slot = torch.where(keep, pos, torch.zeros_like(pos))
    return onehot, keep, slot


class AuxParts(NamedTuple):
    """The statistics a rank set contributes to the global aux and to the
    expert stats; ``pool`` sums them over rank sets (JAX's psum over the
    token-sharding axes)."""
    counts: torch.Tensor     # [E] f32 routed assignments per expert
    psum_p: torch.Tensor     # [E] f32 sum of router probabilities
    kept: torch.Tensor       # [E] f32 kept assignments per expert
    n_tok: int               # tokens
    n_ranks: int             # ranks (capacity slots scale with them)
    capacity: int            # C a rank


def pool(parts: Sequence[AuxParts]) -> AuxParts:
    return AuxParts(sum(p.counts for p in parts),
                    sum(p.psum_p for p in parts),
                    sum(p.kept for p in parts),
                    sum(p.n_tok for p in parts),
                    sum(p.n_ranks for p in parts), parts[0].capacity)


def aux_loss(parts: AuxParts, cfg: MoEConfig) -> torch.Tensor:
    """GShard load balance ``w E sum_i f_i p_i``: f from the hard
    assignments (no gradient), p the mean router probability."""
    f = parts.counts / (parts.n_tok * cfg.top_k)
    p = parts.psum_p / parts.n_tok
    return cfg.aux_weight * cfg.num_experts * torch.dot(f, p)


def _stats_from_routing(parts: AuxParts, top_k: int) -> Dict:
    """load_frac [E], capacity_frac [E], drop_frac [], capacity []: JAX's
    ``_stats_from_routing`` over the pooled rank set."""
    kept_total = parts.kept.sum()
    total = float(parts.n_tok * top_k)
    return {"load_frac": parts.kept / torch.clamp(kept_total, min=1.0),
            "capacity_frac": parts.kept / (parts.capacity * parts.n_ranks),
            "drop_frac": 1.0 - kept_total / total,
            "capacity": torch.tensor(parts.capacity, dtype=torch.int32)}


def _parts(r: Routing, C: int) -> AuxParts:
    n, Tk = r.keep.shape
    kept = (r.onehot * r.keep[..., None].to(torch.int32)).sum(dim=(0, 1))
    return AuxParts(r.onehot.sum(dim=(0, 1)).to(torch.float32),
                    r.probs.sum(dim=(0, 1)), kept.to(torch.float32),
                    n * r.probs.shape[1], n, C)


def moe_ranks(wr: torch.Tensor, shards: Sequence[Params], x: torch.Tensor,
              cfg: MoEConfig, tp: int = 1):
    """The MoE FFN over ``n`` stacked source devices: ``x [n, B, S, D]``
    each device's local tokens (capacity and drop priority over its ``B
    S``), ``wr`` [D, E] or [n, D, E], ``shards`` the ep expert shards
    (``len(shards)`` = ep; ep = n, one shard a rank, ep = 1, every rank
    all experts, or n = ep m: the m sp devices of each ep rank, ep major).
    Shard j's experts see every source's rows for them: with sp, the m
    (dp, sp) groups' all_to_alls of JAX side by side, which give the same
    rows since an expert acts on each row alone.  With ``tp`` > 1,
    ``shards`` holds every tp rank's ep shards, tp major (``shards[t ep +
    j]``, each expert's hidden slice t): each tp rank's experts give their
    partial outputs, which are combined a rank at a time and summed in
    rank order (JAX's ``psum`` over tp after the combine).  Returns ``(y
    [n, B, S, D], AuxParts)``."""
    n, B, S, D = x.shape
    if len(shards) % tp:
        raise ValueError(f"{len(shards)} expert shards do not split over "
                         f"tp={tp}")
    ep = len(shards) // tp
    if n % ep:
        raise ValueError(f"{ep} expert shards for {n} source devices: "
                         "one a rank, one for all, or one a rank's sp "
                         "devices")
    E, k = cfg.num_experts, cfg.top_k
    if E % ep:
        raise ValueError(f"num_experts={E} does not split over ep={ep}")
    El = E // ep
    T = B * S
    C = cfg.capacity(T)
    xf = x.reshape(n, T, D)
    r = _route(wr, xf, cfg, C)
    rank = torch.arange(n, device=x.device)[:, None].expand(n, T * k)
    toks = xf.repeat_interleave(k, dim=1)                       # [n, T*k, D]
    # scatter-ADD, as JAX's ``.at[].add``: kept (expert, slot) pairs are
    # unique, and a dropped assignment adds an exact zero to slot 0 of a
    # buffer that starts at +0, so any order gives JAX's finite values
    # and the same signed zeros as a masked copy would
    idx = (rank, r.e_flat, r.slot.long())
    buf = torch.zeros((n, E, C, D), dtype=x.dtype, device=x.device).index_put(
        idx, toks * r.keep[..., None].to(x.dtype), accumulate=True)
    # the exchange: shard j's rows of every source, source-major
    h = buf.reshape(n, ep, El, C, D).permute(1, 2, 0, 3, 4).reshape(
        ep, El, n * C, D)
    w = (r.gates.reshape(n, T * k) * r.keep.to(torch.float32)).to(x.dtype)
    ys = []
    for t in range(tp):
        out = torch.stack([_expert_ffn(shards[t * ep + j], h[j])
                           for j in range(ep)])
        ybuf = out.reshape(ep, El, n, C, D).permute(2, 0, 1, 3, 4).reshape(
            n, E, C, D)
        ytok = ybuf[idx] * w[..., None]          # [n,T*k,D]
        ys.append(ytok.reshape(n, T, k, D).sum(dim=2).reshape(n, B, S, D))
    y = ys[0]
    for part in ys[1:]:
        y = y + part
    return y, _parts(r, C)


def moe_ffn(params: Union[Params, List[Params]], x: torch.Tensor,
            cfg: MoEConfig, *, ep_axis: Optional[str] = None,
            with_stats: bool = False):
    """x [B, S, D] one rank's tokens -> ``(y [B, S, D], aux)``, params one
    ``{wr, w1, w3, w2}`` tree with all E experts.

    With ``ep_axis``: ``params`` the ep ranks' trees (a list; each its own
    router copy and its ``[E/ep, ...]`` expert shard), ``x [ep, B, S, D]``
    their tokens stacked; y is ``[ep, B, S, D]`` and the aux and stats are
    over every rank's tokens (JAX's ``batch_axes=(ep,)``).  With
    ``with_stats`` the stats dict of ``expert_stats`` comes third."""
    if ep_axis is None:
        y, parts = moe_ranks(params["wr"], [params], x[None], cfg)
        y = y[0]
    else:
        if isinstance(params, dict) or len(params) != x.shape[0]:
            raise ValueError("with ep_axis, params is one tree a rank of "
                             "the stacked x [ep, B, S, D]")
        wr = torch.stack([p["wr"] for p in params])
        y, parts = moe_ranks(wr, params, x, cfg)
    aux = aux_loss(parts, cfg)
    if with_stats:
        return y, aux, _stats_from_routing(parts, cfg.top_k)
    return y, aux


def expert_stats(params: Params, x: torch.Tensor, cfg: MoEConfig) -> Dict:
    """Expert utilisation of one batch ``x [B, S, D]`` (reruns the router):
    load_frac [E] (kept assignments per expert, summing to 1),
    capacity_frac [E] (kept / capacity slots), drop_frac [] (dropped /
    routed assignments) and capacity [] (C)."""
    B, S, D = x.shape
    C = cfg.capacity(B * S)
    with torch.no_grad():
        r = _route(params["wr"], x.reshape(1, B * S, D), cfg, C)
        return _stats_from_routing(_parts(r, C), cfg.top_k)
