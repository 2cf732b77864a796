"""Llama-3-family decoder: configuration, parameters, the layer math and
the training loss — the port of the JAX package's ``models/llama.py``
with its sequence-parallel axis (serving composes the shared pieces in
``models/llama_decode.py``; training differentiates ``loss_fn``).

The parameter tree keeps the JAX layout, so weights carry across unchanged
(``params_from_jax``): ``{"tok_emb": [V, D], "final_norm": [D],
"lm_head": [D, V], "layers": [{"attn_norm", "wq" [D, H*hd], "wk"/"wv"
[D, kv*hd], "wo" [H*hd, D], "mlp_norm", "w1"/"w3" [D, F], "w2" [F, D]}]}``
and a projection is ``h @ w``; a MoE layer (``moe_experts > 0``) holds
``"moe": {"wr" [D, E] f32, "w1"/"w3" [E, D, F], "w2" [E, F, D]}`` in
place of ``w1``/``w3``/``w2`` (``ops.moe``).  ``tp_axis`` and ``dp_axis``
raise ``NotImplementedError``.  ``remat=True`` recomputes each decoder
block in the backward (``torch.utils.checkpoint``, JAX's
``jax.checkpoint`` of the block): a layer keeps only its input, on every
route (the dense and sp blocks, and a layer of the joint-ranks graph as
one unit, since the ep exchange couples its ranks).  Attention follows
``attn_block`` / ``attn_impl``:
``None`` is the direct softmax, a block size routes through
``ops.ring_attention.flash_attention_remat`` (the flash CUDA kernels for
"pallas", or "auto" on the card; the checkpointed blocked torch path for
"xla", or "auto" on the CPU).

``sp_axis`` (sequence parallelism): the tokens are ``[n_sp, B, S_local]``,
the n_sp contiguous sequence shards stacked (``parallel.mesh``'s virtual
sp ranks), and shard i holds global positions [i S_local, (i + 1)
S_local).  Every per-token op runs on the stacked shards at once; only
attention couples them, through ``ops.ring_attention.ring_attention``
over the stack (the flash kernels' ring with q/k offsets where the route
takes the kernels), and the loss sums the shards' token sums and counts
(JAX's psum over sp).

``ep_axis`` (expert parallelism): ``params`` is a list of the ep ranks'
trees (each its replicated leaves and its ``[E/ep, ...]`` expert shard,
``parallel.sharded.split_ep``), tokens ``[n_ep, B, S]``; the dense parts run a rank at a
time on its own tree, each MoE layer over the stacked ranks
(``ops.moe.moe_ranks``: the ep exchange is a transpose of the stack),
and the loss and the aux are over every rank's tokens.  With both
``ep_axis`` and ``sp_axis`` the tokens are ``[n_ep, n_sp, B, S_local]``:
each ep rank runs its sp ring over its own shards, and each (ep, sp)
device routes its own tokens (capacity over ``B S_local``).
``dp_loss_fn`` is the trainers' MoE loss over dp x ep (x sp) ranks at
once (``joint_ranks``): the aux is taken once over the global
statistics, as JAX's is under ``dp_axis``, which a per-dp-rank loss
cannot do.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import DeviceLike, resolve_device
from ..ops import moe as moe_ops
from ..parallel import pipeline
from ..ops.ring_attention import (flash_attention_remat, full_attention,
                                  pallas_route, ring_attention)

Params = Dict[str, Any]


@dataclass(frozen=True)
class LlamaConfig:
    vocab: int = 128256
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    ffn_dim: int = 14336
    rope_theta: float = 500000.0
    # Llama-3.1 rope scaling for context extension; 1.0 disables it
    rope_scaling: float = 1.0
    rope_old_context: int = 8192
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    # flash-blocked single-device attention: score memory O(S * attn_block)
    # instead of full_attention's O(S^2); None keeps the direct softmax
    attn_block: Optional[int] = None
    # which flash implementation backs attn_block: "auto" = the CUDA
    # kernels on the card, the blocked torch path on the CPU;
    # "pallas" / "xla" pin one (pallas_route)
    attn_impl: str = "auto"
    # MoE: when moe_experts > 0 every FFN is a top-k routed expert layer
    # (ops.moe); dense SwiGLU otherwise
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 2.0
    moe_aux_weight: float = 0.01

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def moe(self) -> Optional[moe_ops.MoEConfig]:
        if self.moe_experts == 0:
            return None
        return moe_ops.MoEConfig(
            num_experts=self.moe_experts, top_k=self.moe_top_k,
            capacity_factor=self.moe_capacity_factor,
            aux_weight=self.moe_aux_weight)

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @staticmethod
    def llama3_8b() -> "LlamaConfig":
        return LlamaConfig()

    @staticmethod
    def tiny(vocab: int = 256, dim: int = 64, n_layers: int = 2,
             n_heads: int = 4, n_kv_heads: int = 2, ffn_dim: int = 128,
             dtype: str = "float32") -> "LlamaConfig":
        return LlamaConfig(vocab=vocab, dim=dim, n_layers=n_layers,
                           n_heads=n_heads, n_kv_heads=n_kv_heads,
                           ffn_dim=ffn_dim, dtype=dtype)


def init(generator: torch.Generator, cfg: LlamaConfig,
         device: DeviceLike = "cuda") -> Params:
    """Random weights with the JAX package's fan-in scaling (normal times
    sqrt(1 / fan_in), drawn in f32, cast to ``cfg.dtype``), norms at one.
    Drawn on ``generator``'s device — give it the card's device for the
    full-size model — then placed on ``device``.  Torch's generator is not
    JAX's: the same seed gives other weights (carry JAX's across with
    ``params_from_jax``).  A MoE layer draws its router and experts
    after ``wo``, in JAX's order of use (``ops.moe.init_ffn``)."""
    dev = resolve_device(device)
    dt = cfg.torch_dtype
    D, Hd = cfg.dim, cfg.head_dim

    def dense(fan_in: int, shape: Tuple[int, ...]) -> torch.Tensor:
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        return (w * math.sqrt(1.0 / fan_in)).to(dev, dt)

    def ones() -> torch.Tensor:
        return torch.ones((D,), dtype=dt, device=dev)

    params: Params = {"tok_emb": dense(D, (cfg.vocab, D)),
                      "final_norm": ones(),
                      "lm_head": dense(D, (D, cfg.vocab)),
                      "layers": []}
    for _ in range(cfg.n_layers):
        lyr = {
            "attn_norm": ones(),
            "wq": dense(D, (D, cfg.n_heads * Hd)),
            "wk": dense(D, (D, cfg.n_kv_heads * Hd)),
            "wv": dense(D, (D, cfg.n_kv_heads * Hd)),
            "wo": dense(cfg.n_heads * Hd, (cfg.n_heads * Hd, D)),
            "mlp_norm": ones(),
        }
        if cfg.moe is not None:
            lyr["moe"] = moe_ops.init_ffn(generator, D, cfg.ffn_dim,
                                          cfg.moe, dt, dev)
        else:
            lyr.update({
                "w1": dense(D, (D, cfg.ffn_dim)),
                "w3": dense(D, (D, cfg.ffn_dim)),
                "w2": dense(cfg.ffn_dim, (cfg.ffn_dim, D)),
            })
        params["layers"].append(lyr)
    return params


def param_specs(cfg: LlamaConfig) -> Params:
    """Which leaves shard over ep on their leading axis (``"ep"``) and
    which replicate (None): JAX's ``param_specs(cfg, tp_axis=None,
    ep_axis="ep")`` reduced to the ep axis, the trainer's layout
    (``parallel.sharded.split_ep``)."""
    layer: Dict[str, Any] = {k: None for k in (
        "attn_norm", "wq", "wk", "wv", "wo", "mlp_norm")}
    if cfg.moe is not None:
        layer["moe"] = moe_ops.param_specs()
    else:
        layer.update(w1=None, w3=None, w2=None)
    return {"tok_emb": None, "final_norm": None, "lm_head": None,
            "layers": [{k: dict(v) if isinstance(v, dict) else v
                        for k, v in layer.items()}
                       for _ in range(cfg.n_layers)]}


def params_from_jax(tree: Params, device: DeviceLike = "cuda") -> Params:
    """The JAX package's parameter pytree, with numpy arrays at its leaves
    (``jax.tree_util.tree_map(np.asarray, params)``), as this port's tree:
    same keys, layout and values (bfloat16 leaves keep their bits).  The
    stacked tree of JAX's ``stack_params`` (``"layers"`` a dict of
    ``[n_layers, ...]`` leaves, in model or ``interleave_layers`` order)
    comes across stacked."""
    dev = resolve_device(device)

    def leaf(a: Any) -> torch.Tensor:
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":       # numpy's ml_dtypes bfloat16
            bits = torch.from_numpy(np.array(a).view(np.int16))
            return bits.view(torch.bfloat16).to(dev)
        return torch.from_numpy(np.array(a)).to(dev)

    def node(v: Any) -> Any:
        return ({k: leaf(a) for k, a in v.items()} if isinstance(v, dict)
                else leaf(v))

    out: Params = {k: leaf(v) for k, v in tree.items() if k != "layers"}
    layers = tree["layers"]
    out["layers"] = ({k: node(v) for k, v in layers.items()}
                     if isinstance(layers, dict) else
                     [{k: node(v) for k, v in lyr.items()} for lyr in layers])
    return out


def _rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in f32, cast back to ``x.dtype`` BEFORE the weight multiply
    (as the JAX code does)."""
    xf = x.to(torch.float32)
    scale = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * scale).to(x.dtype) * w


def _rope_freqs(cfg: LlamaConfig, half: int,
                device: DeviceLike = "cpu") -> torch.Tensor:
    """Inverse frequencies, NTK-scaled by the Llama-3.1 recipe when
    ``rope_scaling != 1``: wavelengths longer than old_context/low_factor
    are divided by rope_scaling, shorter than old_context/high_factor are
    kept, the band between interpolates linearly in 1/wavelength."""
    freqs = cfg.rope_theta ** (
        -torch.arange(half, dtype=torch.float32, device=device) / half)
    if cfg.rope_scaling == 1.0:
        return freqs
    wavelen = 2.0 * math.pi / freqs
    low = cfg.rope_old_context / cfg.rope_low_freq_factor     # long cutoff
    high = cfg.rope_old_context / cfg.rope_high_freq_factor   # short cutoff
    if cfg.rope_low_freq_factor == cfg.rope_high_freq_factor:
        smooth = torch.zeros_like(wavelen)
    else:
        smooth = torch.clamp(
            (cfg.rope_old_context / wavelen - cfg.rope_low_freq_factor)
            / (cfg.rope_high_freq_factor - cfg.rope_low_freq_factor),
            0.0, 1.0)
    scaled = freqs / cfg.rope_scaling
    mid = (1.0 - smooth) * scaled + smooth * freqs
    return torch.where(wavelen > low, scaled,
                       torch.where(wavelen < high, freqs, mid))


def _rope(x: torch.Tensor, pos: torch.Tensor,
          cfg: LlamaConfig) -> torch.Tensor:
    """Rotate-half rope. x: [B, H, S, dh]; pos: [S] global positions (or
    x [n_sp, B, H, S, dh] and pos [n_sp, S], each shard's own)."""
    half = x.shape[-1] // 2
    freqs = _rope_freqs(cfg, half, x.device)
    ang = pos.to(torch.float32)[..., None] * freqs              # [.., S, half]
    if pos.dim() == 2:
        ang = ang[:, None, None]                     # [n_sp, 1, 1, S, half]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


def _shard_counts(cfg: LlamaConfig,
                  tp_axis: Optional[str] = None) -> Tuple[int, int]:
    """(n_heads, n_kv) per rank; only ``tp_axis=None`` (one rank) is
    ported."""
    if tp_axis is not None:
        raise NotImplementedError(
            "tensor parallelism (tp_axis) is not ported yet")
    return cfg.n_heads, cfg.n_kv_heads


def _positions(S: int, sp_axis: Optional[str] = None,
               device: DeviceLike = "cpu", n_sp: int = 1) -> torch.Tensor:
    """int32 [S] positions 0..S-1; with ``sp_axis``, [n_sp, S]: shard i's
    global positions i S .. (i + 1) S - 1 (JAX's ``axis_index * S``
    offset)."""
    pos = torch.arange(S, dtype=torch.int32, device=device)
    if sp_axis is None:
        return pos
    return S * torch.arange(n_sp, dtype=torch.int32,
                            device=device)[:, None] + pos


def _attention(lyr: Params, x: torch.Tensor, pos: torch.Tensor,
               cfg: LlamaConfig, n_heads: int, n_kv: int,
               sp_axis: Optional[str] = None) -> torch.Tensor:
    """The attention half of a decoder layer with its residual: pre-norm
    attention, ``x + att @ wo``.  x: [B, S, D], or [n_sp, B, S, D] with
    ``sp_axis``."""
    lead, S = x.shape[:-2], x.shape[-2]
    Hd = cfg.head_dim
    h = _rmsnorm(x, lyr["attn_norm"], cfg.norm_eps)
    q = (h @ lyr["wq"]).reshape(*lead, S, n_heads, Hd).transpose(-3, -2)
    k = (h @ lyr["wk"]).reshape(*lead, S, n_kv, Hd).transpose(-3, -2)
    v = (h @ lyr["wv"]).reshape(*lead, S, n_kv, Hd).transpose(-3, -2)
    q = _rope(q, pos, cfg)
    k = _rope(k, pos, cfg)
    # GQA: the flash kernels read grouped K/V (on the sp ring: 1/G of the
    # rotated bytes); the torch paths' einsums take the repeat-expanded
    # copy (head h reads KV h // G).  Grouped K/V only reach the branches
    # that can take the kernels, by the route the ops themselves take.
    kernel_branch = sp_axis is not None or cfg.attn_block is not None
    q_shard = q if sp_axis is None else q[0]
    if n_kv != n_heads and not (kernel_branch
                                and pallas_route(cfg.attn_impl, q_shard,
                                                 kv_seq_len=S)):
        k = k.repeat_interleave(n_heads // n_kv, dim=-3)
        v = v.repeat_interleave(n_heads // n_kv, dim=-3)
    if sp_axis is not None:
        att = ring_attention(q, k, v, sp_axis, causal=True,
                             impl=cfg.attn_impl)
    elif cfg.attn_block is not None:
        att = flash_attention_remat(q, k, v, causal=True,
                                    k_block=cfg.attn_block,
                                    impl=cfg.attn_impl)
    else:
        att = full_attention(q, k, v, causal=True)
    att = att.transpose(-3, -2).reshape(*lead, S, n_heads * Hd)
    return x + att @ lyr["wo"]


def _dense_ffn(lyr: Params, h: torch.Tensor) -> torch.Tensor:
    """SwiGLU: silu in f32, back to the activation dtype."""
    gate = F.silu((h @ lyr["w1"]).to(torch.float32)).to(h.dtype)
    return (gate * (h @ lyr["w3"])) @ lyr["w2"]


def _block(lyr: Params, x: torch.Tensor, pos: torch.Tensor,
           cfg: LlamaConfig, n_heads: int, n_kv: int,
           sp_axis: Optional[str] = None
           ) -> Tuple[torch.Tensor, Optional[moe_ops.AuxParts]]:
    """One decoder layer: pre-norm attention + SwiGLU or MoE FFN.  x:
    [B, S, D], or [n_sp, B, S, D] with ``sp_axis`` (each sp shard routes
    its own tokens, as a JAX sp rank does).  Returns ``(x, parts)``:
    the MoE layer's aux statistics over its tokens, None when dense."""
    x = _attention(lyr, x, pos, cfg, n_heads, n_kv, sp_axis)
    h = _rmsnorm(x, lyr["mlp_norm"], cfg.norm_eps)
    if "moe" not in lyr:
        return x + _dense_ffn(lyr, h), None
    hs = h if sp_axis is not None else h[None]
    ff, parts = moe_ops.moe_ranks(lyr["moe"]["wr"], [lyr["moe"]], hs,
                                  cfg.moe)
    return x + (ff if sp_axis is not None else ff[0]), parts


def _aux(layer_parts: Sequence[moe_ops.AuxParts], cfg: LlamaConfig,
         device: torch.device) -> torch.Tensor:
    """The layers' load-balance terms summed (0 without MoE layers)."""
    return sum((moe_ops.aux_loss(p, cfg.moe) for p in layer_parts),
               torch.zeros((), dtype=torch.float32, device=device))


def _moe_group(lyrs: Sequence[Params], hs: Sequence[torch.Tensor],
               cfg: LlamaConfig
               ) -> Tuple[torch.Tensor, moe_ops.AuxParts]:
    """One ep group's MoE layer: ``hs`` its ranks' normed activations,
    ``[B, S, D]`` each, or ``[n_sp, B, S_local, D]`` with sp.  Every (ep,
    sp) device is a source of the exchange, routing its own tokens with
    its ep rank's router copy; returns the outputs stacked as ``hs``."""
    x = torch.stack(hs)
    wr = torch.stack([lyr["moe"]["wr"] for lyr in lyrs])
    if x.dim() == 5:                            # [n_ep, n_sp, B, S, D]
        wr = wr.repeat_interleave(x.shape[1], dim=0)
    ff, parts = moe_ops.moe_ranks(wr, [lyr["moe"] for lyr in lyrs],
                                  x.flatten(0, x.dim() - 4), cfg.moe)
    return ff.reshape(x.shape), parts


def _layer_groups(lyrs: Sequence[Sequence[Params]], sizes: Sequence[int],
                  pos: torch.Tensor, cfg: LlamaConfig,
                  sp_axis: Optional[str], *flat: torch.Tensor
                  ) -> Tuple[List[torch.Tensor], Optional[moe_ops.AuxParts]]:
    """One decoder layer over every group's ranks, ``flat`` their
    activations in group order (``sizes`` ranks a group): attention a
    rank at a time on its own tree (its sp ring with ``sp_axis``), the
    FFN dense a rank or MoE over the group.  Returns the new activations
    in the same order and the MoE statistics pooled over the groups
    (None when dense)."""
    n_heads, n_kv = cfg.n_heads, cfg.n_kv_heads
    out, parts, at = [], [], 0
    for g_lyrs, k in zip(lyrs, sizes):
        xg = [_attention(lyr, x, pos, cfg, n_heads, n_kv, sp_axis)
              for lyr, x in zip(g_lyrs, flat[at:at + k])]
        at += k
        hs = [_rmsnorm(x, lyr["mlp_norm"], cfg.norm_eps)
              for lyr, x in zip(g_lyrs, xg)]
        if "moe" in g_lyrs[0]:
            ff, p = _moe_group(g_lyrs, hs, cfg)
            parts.append(p)
        else:
            ff = [_dense_ffn(lyr, h) for lyr, h in zip(g_lyrs, hs)]
        out += [x + f for x, f in zip(xg, ff)]
    return out, (moe_ops.pool(parts) if parts else None)


def _forward_groups(groups: Sequence[Sequence[Params]],
                    tokens: Sequence[torch.Tensor], cfg: LlamaConfig,
                    sp_axis: Optional[str] = None, remat: bool = False
                    ) -> Tuple[List[torch.Tensor],
                               List[moe_ops.AuxParts]]:
    """Expert-parallel forward: ``groups`` the ep groups' rank trees (ep
    trees each, rank e holding expert shard e), ``tokens`` a ``[n_ep, B,
    S]`` stack a group (``[n_ep, n_sp, B, S_local]`` with ``sp_axis``).
    The dense parts run a rank at a time on its own tree, each MoE layer
    over the group's stacked ranks; with ``remat`` each layer, all groups
    at once, is recomputed in the backward.  Returns the logits, shaped
    as the tokens plus ``V`` a group, and each MoE layer's statistics
    pooled over every group (JAX's psum over all token axes)."""
    S = tokens[0].shape[-1]
    pos = _positions(S, sp_axis, tokens[0].device,
                     n_sp=tokens[0].shape[1] if sp_axis else 1)
    xs = [t["tok_emb"][tok.long()] for trees, toks in zip(groups, tokens)
          for t, tok in zip(trees, toks)]
    sizes = [len(trees) for trees in groups]
    layer_parts = []
    for i in range(cfg.n_layers):
        args = ([[t["layers"][i] for t in trees] for trees in groups],
                sizes, pos, cfg, sp_axis, *xs)
        xs, parts = (checkpoint(_layer_groups, *args, use_reentrant=False)
                     if remat else _layer_groups(*args))
        if parts is not None:
            layer_parts.append(parts)
    it = iter(xs)
    xs = [[next(it) for _ in range(k)] for k in sizes]
    logits = [torch.stack([_rmsnorm(x, t["final_norm"], cfg.norm_eps)
                           @ t["lm_head"] for t, x in zip(trees, xg)])
              for trees, xg in zip(groups, xs)]
    return logits, layer_parts


def _check_ep(params: Any, tokens: torch.Tensor,
              sp_axis: Optional[str]) -> None:
    dims = 4 if sp_axis is not None else 3
    if isinstance(params, dict) or tokens.dim() != dims \
            or len(params) != tokens.shape[0]:
        raise ValueError("with ep_axis, params is the list of the ep "
                         "ranks' trees and tokens [n_ep, B, S] ([n_ep, "
                         "n_sp, B, S_local] with sp_axis)")


def apply(params: Any, tokens: torch.Tensor, cfg: LlamaConfig, *,
          tp_axis: Optional[str] = None, sp_axis: Optional[str] = None,
          ep_axis: Optional[str] = None, with_aux: bool = False,
          remat: bool = False):
    """tokens [B, S] -> logits [B, S, vocab] in the model dtype; with
    ``sp_axis``, tokens [n_sp, B, S_local] -> [n_sp, B, S_local, vocab];
    with ``ep_axis``, params the ep ranks' trees and tokens [n_ep, B, S]
    -> [n_ep, B, S, vocab] (with both, [n_ep, n_sp, B, S_local] ->
    [n_ep, n_sp, B, S_local, vocab]).  ``with_aux``: ``(logits, aux)``,
    the MoE load-balance term over every token of the call (0 when
    dense).  ``remat``: each block recomputed in the backward."""
    if ep_axis is not None:
        _check_ep(params, tokens, sp_axis)
        _shard_counts(cfg, tp_axis)
        logits, layer_parts = _forward_groups([params], [tokens], cfg,
                                              sp_axis, remat)
        logits = logits[0]
    else:
        if tokens.dim() != (2 if sp_axis is None else 3):
            raise ValueError(f"tokens must be [B, S] (or [n_sp, B, S_local] "
                             f"with sp_axis), got {tuple(tokens.shape)}")
        S = tokens.shape[-1]
        n_heads, n_kv = _shard_counts(cfg, tp_axis)
        pos = _positions(S, sp_axis, tokens.device, n_sp=tokens.shape[0])
        x = params["tok_emb"][tokens.long()]                # [.., S, D]
        layer_parts = []
        for lyr in params["layers"]:
            args = (lyr, x, pos, cfg, n_heads, n_kv, sp_axis)
            x, parts = (checkpoint(_block, *args, use_reentrant=False)
                        if remat else _block(*args))
            if parts is not None:
                layer_parts.append(parts)
        x = _rmsnorm(x, params["final_norm"], cfg.norm_eps)
        logits = x @ params["lm_head"]
    if not with_aux:
        return logits
    return logits, _aux(layer_parts, cfg, logits.device)


def _token_nll(logits: torch.Tensor,
               safe_labels: torch.Tensor) -> torch.Tensor:
    """Per-token NLL [B, S] from f32 log-softmax."""
    logz = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return -logz.gather(-1, safe_labels.long()[..., None])[..., 0]


def _masked_nll(logits: torch.Tensor,
                labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(per-token NLL with -100 labels zeroed, the valid mask)."""
    valid = labels >= 0
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    nll = torch.where(valid, _token_nll(logits, safe),
                      torch.zeros((), dtype=torch.float32,
                                  device=logits.device))
    return nll, valid


def _weighted_loss(local_sum: torch.Tensor,
                   count: torch.Tensor) -> torch.Tensor:
    """Token-weighted mean: the sums and counts are over every token the
    call holds, all its sp shards with ``sp_axis`` (JAX's psum over the
    token-sharding axes), so the value is the global mean over them and
    its gradient sums the shards' contributions."""
    return local_sum / torch.clamp(count, min=1)


def _grad_scale(x: torch.Tensor, n: float) -> torch.Tensor:
    """Value-preserving gradient scale by n (JAX's ``_grad_scale``)."""
    return x.detach() + n * (x - x.detach())


def loss_fn(params: Any, batch, cfg: LlamaConfig, *,
            tp_axis: Optional[str] = None, sp_axis: Optional[str] = None,
            dp_axis: Optional[str] = None, ep_axis: Optional[str] = None,
            remat: bool = False) -> torch.Tensor:
    """Next-token cross-entropy plus the MoE load-balance term.  batch =
    (tokens, labels), both [B, S] (or [n_sp, B, S_local] with
    ``sp_axis``: the stacked shards, labels the globally shifted targets,
    so the shift crosses shard boundaries; or [n_ep, B, S] with
    ``ep_axis``, params the ep ranks' trees; [n_ep, n_sp, B, S_local]
    with both); -100 entries are ignored.
    With ``sp_axis`` or ``ep_axis`` the value is the token-weighted mean
    over all the shards, as each JAX rank's.  ``dp_axis`` raises: a dense
    model's per-rank loss and the trainer's uniform dp average equal the
    JAX dp_axis weighting when every label is valid, as in
    ``train_llama``; a MoE model trains through ``dp_loss_fn``."""
    if dp_axis is not None:
        raise NotImplementedError(
            "dp_axis (the masked-label dp weighting inside a sharded "
            "program) is not ported; ShardedTrainer averages per-rank "
            "gradients (a MoE model takes llama.dp_loss_fn)")
    tokens, labels = batch
    out = apply(params, tokens, cfg, tp_axis=tp_axis, sp_axis=sp_axis,
                ep_axis=ep_axis, with_aux=cfg.moe is not None, remat=remat)
    logits = out[0] if cfg.moe is not None else out
    nll, valid = _masked_nll(logits, labels)
    loss = _weighted_loss(nll.sum(), valid.sum())
    return loss + out[1] if cfg.moe is not None else loss


def dp_loss_fn(cfg: LlamaConfig, n_dp: int, n_ep: int = 1, *,
               n_sp: int = 1, remat: bool = False) -> Callable:
    """The trainers' loss of a MoE Llama over n_dp x n_ep ranks at once,
    marked ``joint_ranks`` (``parallel.train.joint_grads``):
    ``(params_per_rank, batch) -> [n_dp n_ep]`` losses, rank (d, e) at
    index ``e n_dp + d`` (JAX's master layout, ep major), its batch
    ``batch[d, e]`` (``[n_dp, n_ep, B, S]``, JAX's ``P((dp, ep))``; or
    ``[n_dp, B, S]`` without ep).  With ``n_sp > 1`` the batch is
    ``[n_dp, n_ep, n_sp, B, S_local]`` (JAX's ``P((dp, ep), sp)``,
    ``parallel.mesh.VirtualRanks.shard``) and each rank runs its sp ring
    over its shards; a rank's loss then sums its shards' tokens (JAX's
    psum over sp).  ``remat``: each layer recomputed in the backward.

    JAX's ``loss_fn(dp_axis="dp", ep_axis="ep"[, sp_axis="sp"])``: every
    value is the global token-weighted cross-entropy plus the aux over
    the global routing statistics; the gradient of the losses' sum is
    n_dp times the unsharded one (the CE through each rank's own tokens,
    the aux once), which the trainer's ep sum of the replicated leaves
    and its dp average (sum / n_dp) turn into the single-device
    gradient."""
    n = n_dp * n_ep
    sp_axis = "sp" if n_sp > 1 else None
    lead = (n_dp, n_ep) + ((n_sp,) if n_sp > 1 else ())

    def loss(params_per_rank, batch):
        toks, labels = (b.reshape(*lead, *b.shape[-2:]) for b in batch)
        groups = [[params_per_rank[e * n_dp + d] for e in range(n_ep)]
                  for d in range(n_dp)]
        logits, layer_parts = _forward_groups(groups, list(toks), cfg,
                                              sp_axis, remat)
        sums, counts = [], []
        for d in range(n_dp):
            nll, valid = _masked_nll(logits[d], labels[d])
            sums.append(nll.reshape(n_ep, -1).sum(dim=1))
            counts.append(valid.reshape(n_ep, -1).sum(dim=1))
        local = torch.stack(sums, dim=1).reshape(n)       # [ep, dp] order
        denom = torch.clamp(torch.stack(counts, dim=1).reshape(n).sum(),
                            min=1).to(torch.float32)
        ce = (local.sum() / denom).detach() + n_dp * (
            local - local.detach()) / denom
        aux = _aux(layer_parts, cfg, local.device)
        return ce + aux.detach() + n_dp * (aux - aux.detach()) / n

    loss.joint_ranks = True
    return loss


# -- the pipeline-parallel path ---------------------------------------------


def stack_params(params: Params) -> Params:
    """The list-of-layers tree with its layers stacked into ``[n_layers,
    ...]`` leaves, the axis pp splits (``parallel.pipeline.stack_layers``)."""
    out = dict(params)
    out["layers"] = pipeline.stack_layers(params["layers"])
    return out


def stacked_param_specs(cfg: LlamaConfig) -> Params:
    """JAX's ``stacked_param_specs(cfg, tp_axis=None)`` reduced to the pp
    axis: ``"pp"`` at the stacked layer leaves (split on their leading
    axis, one slice a stage), None at ``tok_emb``, ``final_norm`` and
    ``lm_head`` (every stage holds them; ``parallel.sharded``)."""
    _check_pp(cfg)
    return {"tok_emb": None, "final_norm": None, "lm_head": None,
            "layers": {k: "pp" for k in param_specs(cfg)["layers"][0]}}


def _check_pp(cfg: LlamaConfig, tp_axis: Optional[str] = None,
              sp_axis: Optional[str] = None, dp_axis: Optional[str] = None,
              ep_axis: Optional[str] = None) -> None:
    if tp_axis is not None:
        raise NotImplementedError("pp with tp is not ported: ROADMAP A.5")
    if sp_axis is not None or ep_axis is not None or cfg.moe is not None:
        raise NotImplementedError("pp with sp, ep or MoE layers is not "
                                  "ported: ROADMAP A.6 item 4b")
    if dp_axis is not None:
        raise NotImplementedError(
            "dp_axis is a JAX mesh axis; the port's dp ranks carry the "
            "global label count in the batch (models.bert."
            "with_global_count) and pass dp_size=n")


def _pp_weight(batch, dp_size: Optional[int]
               ) -> Tuple[int, torch.Tensor]:
    """``(numerator, denominator)`` of JAX's ``_weighted_loss`` for one
    dp rank: ``(1, this batch's valid labels)``, or with the global count
    as a third batch leaf, ``(dp_size, the global count)`` (JAX's
    ``dp_axis`` weighting: the ranks' mean is the global value and each
    rank's gradient carries the n_dp that cancels the trainer's /n)."""
    labels = batch[1]
    if len(batch) == 2:
        if dp_size is not None:
            raise ValueError("dp_size needs the global count in the batch "
                             "(models.bert.with_global_count)")
        return 1, torch.clamp((labels >= 0).sum(), min=1).to(torch.float32)
    if dp_size is None:
        raise ValueError("a batch with the global count needs dp_size")
    return dp_size, torch.clamp(batch[2].reshape(()), min=1).to(
        torch.float32)


def _pp_block(cfg: LlamaConfig, S: int, device) -> Callable:
    pos = _positions(S, None, device)

    def block(lyr: Params, h: torch.Tensor) -> torch.Tensor:
        return _block(lyr, h, pos, cfg, cfg.n_heads, cfg.n_kv_heads)[0]
    return block


def _pp_body(params: Sequence[Params], tokens: torch.Tensor,
             cfg: LlamaConfig, num_microbatches: int,
             remat: bool) -> torch.Tensor:
    """Stage 0's embedding, then GPipe over the stages' layer slices:
    the last stage's output ``[B, S, D]``."""
    block = _pp_block(cfg, tokens.shape[-1], tokens.device)
    x = params[0]["tok_emb"][tokens.long()]
    return pipeline.pipeline_apply(
        lambda p, h: pipeline.scan_layers(block, p["layers"], h,
                                          remat=remat),
        params, x, num_microbatches)


def apply_pp(params: Sequence[Params], tokens: torch.Tensor,
             cfg: LlamaConfig, *, num_microbatches: int,
             tp_axis: Optional[str] = None, sp_axis: Optional[str] = None,
             ep_axis: Optional[str] = None,
             remat: bool = False) -> torch.Tensor:
    """The pipelined forward: ``params`` the pp stages' trees (stage s's
    stacked layer slice and its copies of ``tok_emb``, ``final_norm``
    and ``lm_head``; ``parallel.sharded.split_ep`` of ``stack_params``
    over ``stacked_param_specs``), tokens [B, S] -> logits [B, S, vocab]:
    stage 0's embedding, GPipe over ``num_microbatches``, the last
    stage's head.  ``remat``: each layer recomputed in the backward."""
    _check_pp(cfg, tp_axis, sp_axis, None, ep_axis)
    x = _pp_body(params, tokens, cfg, num_microbatches, remat)
    x = _rmsnorm(x, params[-1]["final_norm"], cfg.norm_eps)
    return x @ params[-1]["lm_head"]


def _head_nll_sum(hp: Params, h: torch.Tensor, labels: torch.Tensor,
                  cfg: LlamaConfig) -> torch.Tensor:
    """The head on one microbatch: the NLL summed over its valid labels."""
    logits = _rmsnorm(h, hp["final_norm"], cfg.norm_eps) @ hp["lm_head"]
    return _masked_nll(logits, labels)[0].sum()


def loss_fn_pp(params: Sequence[Params], batch, cfg: LlamaConfig, *,
               num_microbatches: int, dp_size: Optional[int] = None,
               tp_axis: Optional[str] = None, sp_axis: Optional[str] = None,
               dp_axis: Optional[str] = None, ep_axis: Optional[str] = None,
               remat: bool = False) -> torch.Tensor:
    """Next-token cross-entropy through GPipe (``apply_pp``'s forward) for
    one dp rank: ``batch = (tokens, labels)`` [B, S], -100 labels
    ignored; the NLL summed over the batch (the head a microbatch at a
    time: at most ``num_microbatches`` microbatches' log-softmax held for
    the backward) over the valid count.  With ``batch = (tokens, labels,
    count)`` (a rank's shard of ``models.bert.with_global_count``) and
    ``dp_size=n``: ``n * local_sum / count``, JAX's ``dp_axis``
    weighting.  ``remat``: each layer recomputed in the backward, as
    JAX's driver runs its pp losses."""
    _check_pp(cfg, tp_axis, sp_axis, dp_axis, ep_axis)
    tokens, labels = batch[0], batch[1]
    num, denom = _pp_weight(batch, dp_size)
    x = _pp_body(params, tokens, cfg, num_microbatches, remat)
    mb = x.shape[0] // num_microbatches
    local_sum = sum(_head_nll_sum(params[-1], h, lab, cfg)
                    for h, lab in zip(x.split(mb), labels.split(mb)))
    return num * local_sum / denom


def loss_and_grads_pp_1f1b(params: Sequence[Params], batch,
                           cfg: LlamaConfig, *, num_microbatches: int,
                           dp_size: Optional[int] = None,
                           virtual_stages: int = 1, remat: bool = False,
                           tp_axis: Optional[str] = None,
                           sp_axis: Optional[str] = None,
                           dp_axis: Optional[str] = None,
                           ep_axis: Optional[str] = None,
                           out: Optional[List[Params]] = None):
    """``loss_fn_pp``'s loss and its gradients under the 1F1B schedule
    (``parallel.pipeline.pipeline_train_1f1b``; with ``virtual_stages`` >
    1 the interleaved one, the stacked layers then in
    ``pipeline.interleave_layers`` order and num_microbatches a multiple
    of pp).  As JAX's: the head returns the microbatch's NLL sum, the
    schedule their mean, so ``M * mean`` is ``loss_fn_pp``'s local sum;
    the schedule seeds each unit's loss 1/M, so every gradient is scaled
    by ``M * num / denom`` at the end; the embedding is differentiated
    outside the schedule through its d_x.

    Returns ``(loss, grads)``: one f32 tree a stage, the layer slice's
    gradients its own, the replicated leaves' the same in every stage
    (summed over the stages: the embedding's from stage 0, the head's
    from the last).  ``out``: per-stage f32 trees to write the gradients
    into (zeroed, e.g. views of the trainer's flat rows), returned as
    ``grads``."""
    _check_pp(cfg, tp_axis, sp_axis, dp_axis, ep_axis)
    tokens, labels = batch[0], batch[1]
    M, v = num_microbatches, virtual_stages
    num, denom = _pp_weight(batch, dp_size)
    block = _pp_block(cfg, tokens.shape[-1], tokens.device)

    def stage_fn(sp, hp, x_in, c_in):
        h = pipeline.scan_layers(block, sp, x_in, remat=remat)
        return h, torch.zeros((), dtype=torch.float32, device=h.device)

    def loss_head_fn(hp, h, c_in):
        return _head_nll_sum(hp, h, c_in, cfg)

    def chunks(tree):
        return {k: t.reshape(v, t.shape[0] // v, *t.shape[1:])
                for k, t in tree.items()}
    layers = [p["layers"] if v == 1 else chunks(p["layers"])
              for p in params]
    d_out = None if out is None else [
        o["layers"] if v == 1 else chunks(o["layers"]) for o in out]
    head = {k: params[-1][k] for k in ("final_norm", "lm_head")}
    emb = params[0]["tok_emb"].detach().requires_grad_()
    with torch.enable_grad():
        x_full = emb[tokens.long()]
    sched = ((lambda *a, **kw: pipeline.pipeline_train_1f1b_interleaved(
        *a, virtual_stages=v, **kw)) if v > 1
        else pipeline.pipeline_train_1f1b)
    mean_nll_sum, d_layers, d_head, d_x = sched(
        stage_fn, loss_head_fn, layers, head, x_full.detach(), labels, M,
        out=d_out)
    loss = num * (M * mean_nll_sum) / denom
    scale = M * num / denom
    d_emb, = torch.autograd.grad(x_full, emb, d_x.to(x_full.dtype))
    del x_full
    if out is None:
        out = [{"layers": {k: t.reshape(-1, *t.shape[2:]) if v > 1 else t
                           for k, t in d.items()}} for d in d_layers]
        rep = {"tok_emb": d_emb.to(torch.float32), **d_head}
        for o in out:
            o.update(rep)
        for t in [rep["tok_emb"], *d_head.values()] + [
                t for o in out for t in o["layers"].values()]:
            t.mul_(scale)
        return loss, out
    for o, d in zip(out, d_layers):
        for t in d.values():
            t.mul_(scale)
        o["tok_emb"].copy_(d_emb).mul_(scale)
        for k, g in d_head.items():
            o[k].copy_(g).mul_(scale)
    return loss, out


def num_params(cfg: LlamaConfig) -> int:
    D, Hd = cfg.dim, cfg.head_dim
    if cfg.moe is not None:
        ffn = D * cfg.moe_experts + 3 * cfg.moe_experts * D * cfg.ffn_dim
    else:
        ffn = 3 * D * cfg.ffn_dim
    per_layer = (2 * D + D * cfg.n_heads * Hd + 2 * D * cfg.n_kv_heads * Hd
                 + cfg.n_heads * Hd * D + ffn)
    return cfg.vocab * D * 2 + D + cfg.n_layers * per_layer


def active_params(cfg: LlamaConfig) -> int:
    """Parameters a token's products touch: of a MoE layer's experts only
    the top_k routed (plus the router), so 6 P tokens/s stays an honest
    FLOP model.  ``num_params`` for a dense config."""
    if cfg.moe is None:
        return num_params(cfg)
    per_expert = 3 * cfg.dim * cfg.ffn_dim
    return num_params(cfg) - cfg.n_layers * per_expert * (
        cfg.moe_experts - cfg.moe_top_k)


def param_bytes(params: Params) -> int:
    """Bytes the parameter tree holds."""
    from ..ops.fused_update import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(params))
