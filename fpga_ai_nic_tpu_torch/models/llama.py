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
place of ``w1``/``w3``/``w2`` (``ops.moe``).  ``dp_axis`` raises
``NotImplementedError``.  ``remat=True`` recomputes each decoder
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

The pipeline (``stack_params``, ``stacked_param_specs``, ``apply_pp``,
``loss_fn_pp``, ``loss_and_grads_pp_1f1b``; ``parallel.pipeline``) takes
the same layouts with every axis: a stage's ranks run its layer slice
together, the sp shards on the ring attention under GPipe and on the
gathered one in the 1F1B schedules (JAX's choice), and a MoE stage
routes each microbatch of every rank at once.  ``pp_dp_loss_fn`` and
``pp_dp_loss_and_grads_fn`` are the trainers' MoE pipeline losses over
all dp x ep ranks.

``tp_axis`` (tensor parallelism, JAX's Megatron split): ``params`` is the
list of the tp ranks' trees (``param_specs(cfg, tp_axis="tp",
tp_size=tp)``, ``parallel.sharded.split_ep``; with ``ep_axis`` each ep
rank's entry is such a list), rank r holding query heads ``r H/tp`` on,
its kv heads (or, when tp exceeds the kv heads, the one kv head ``r
n_kv // tp`` sliced from replicated ``wk``/``wv``: ``_kv_rep_slice``),
its slice of the FFN hidden (of each expert's with MoE) and of the vocab.
The replicated leaves (the embedding, the norms, the router) are read
from rank 0's tree.  The column products run a rank at a time and their
heads are concatenated in rank order, which is the unsharded head order,
so attention is one call over every rank's heads (one flash launch a
layer, as at tp = 1); the row-parallel products (``wo``, ``w2``) give
each rank's partial, added in rank order in the activation dtype (JAX's
``psum`` over tp).  The loss takes the tp ranks' vocab shards of the
logits without gathering them (``_vocab_parallel_nll``), and a dp rank's
loss is one value whatever its tp, so it is differentiated once.  Under
pp a rank's tree of a stage is likewise the list of its tp ranks' trees
of that stage (Megatron's 3-D layout: ``stacked_param_specs(cfg,
tp_axis="tp", tp_size=tp)``).
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
from ..ops.fused_update import tree_leaves, tree_map
from ..ops.ring_attention import (flash_attention_remat, full_attention,
                                  gathered_attention, pallas_route,
                                  ring_attention)
from ..parallel import pipeline
from ..parallel.mesh import Spec, spec_dims

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


def param_specs(cfg: LlamaConfig, tp_axis: Optional[str] = None,
                ep_axis: Optional[str] = "ep",
                tp_size: Optional[int] = None) -> Params:
    """JAX's ``param_specs``: how each leaf splits over the mesh, the
    trainer's layout (``parallel.sharded.split_ep``).  Megatron's column
    split over ``tp_axis`` (``Spec(None, "tp")``: ``wq``, ``wk``, ``wv``,
    ``w1``, ``w3``, ``lm_head``) and row split (``Spec("tp", None)``:
    ``wo``, ``w2``); the norms and the embedding replicate (None).  MoE
    experts split over ``ep_axis`` on their leading axis and their hidden
    over tp (``ops.moe.param_specs``); the router replicates.  ``tp_size``
    (the tp extent): where it does not divide ``n_kv_heads``, ``wk`` and
    ``wv`` replicate and each rank slices its kv head
    (``_kv_rep_slice``).  Without tp the specs are the shorthand strings
    (``"ep"`` at the experts) of the ep layout.  Where the port's default
    differs from JAX's (``ep_axis="ep"``, JAX's None), an ep extent of 1
    makes it the same layout."""
    col = Spec(None, tp_axis) if tp_axis is not None else None
    row = Spec(tp_axis, None) if tp_axis is not None else None
    kv = col
    if (tp_axis is not None and tp_size is not None
            and cfg.n_kv_heads % tp_size != 0):
        kv = None   # kv-head replication: sliced a rank in _kv_rep_slice
    layer: Dict[str, Any] = {"attn_norm": None, "wq": col, "wk": kv,
                             "wv": kv, "wo": row, "mlp_norm": None}
    if cfg.moe is not None:
        layer["moe"] = moe_ops.param_specs(ep_axis, tp_axis)
    else:
        layer.update(w1=col, w3=col, w2=row)
    return {"tok_emb": None, "final_norm": None, "lm_head": col,
            "layers": [{k: dict(v) if isinstance(v, dict) else v
                        for k, v in layer.items()}
                       for _ in range(cfg.n_layers)]}


def params_from_jax(tree: Params, device: DeviceLike = "cuda", *,
                    specs: Any = None, grid: Any = None) -> Any:
    """The JAX package's parameter pytree, with numpy arrays at its leaves
    (``jax.tree_util.tree_map(np.asarray, params)``), as this port's tree:
    same keys, layout and values (bfloat16 leaves keep their bits).  The
    stacked tree of JAX's ``stack_params`` (``"layers"`` a dict of
    ``[n_layers, ...]`` leaves, in model or ``interleave_layers`` order)
    comes across stacked.  With ``specs`` (``param_specs(cfg,
    tp_axis="tp", tp_size=tp)``) and ``grid`` (``{"tp": tp}``, or an int
    for the one axis the specs name): the shards' trees instead, in grid
    order (``shard_params``: what JAX's ``NamedSharding`` of the
    unsharded tree puts on each device; ``parallel.sharded.join_ep``
    gives the tree back)."""
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
    return out if specs is None else shard_params(out, specs, grid)


def shard_params(params: Params, specs: Any, grid: Any) -> List[Params]:
    """The whole tree as the shards' trees (``parallel.sharded.split_ep``
    over ``specs`` and ``grid``), each leaf a contiguous tensor of its
    own (a replicated leaf copied into every shard)."""
    from ..parallel.sharded import split_ep
    return [tree_map(lambda t: t.clone(memory_format=torch.contiguous_format),
                     t)
            for t in split_ep(params, specs, grid)]


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


def _shard_counts(cfg: LlamaConfig, tp: int = 1) -> Tuple[int, int]:
    """Per-rank (n_heads, n_kv) head counts over ``tp`` ranks, with JAX's
    errors; n_kv == 0 flags kv-head replication (tp > n_kv: wk/wv
    replicate and each rank slices ONE kv head, its query group's)."""
    n_heads, n_kv = cfg.n_heads, cfg.n_kv_heads
    if tp == 1:
        return n_heads, n_kv
    if n_heads % tp:
        raise ValueError(f"tp={tp} must divide n_heads={n_heads}")
    n_heads //= tp
    if n_kv % tp == 0:
        n_kv //= tp
    elif tp % n_kv == 0:
        n_kv = 0            # replicated-kv mode: 1 sliced head a rank
    else:
        raise ValueError(
            f"tp={tp} must divide n_kv_heads={cfg.n_kv_heads}, or be a "
            f"multiple of it (kv-head replication)")
    return n_heads, n_kv


def _units(p: Any) -> List[Params]:
    """One rank's trees: its tp ranks' (a list) or the one tree."""
    return p if isinstance(p, list) else [p]


def _layer(p: Any, i: int) -> Any:
    """Layer i of one rank's tree, or of each of its tp ranks' trees."""
    return ([u["layers"][i] for u in p] if isinstance(p, list)
            else p["layers"][i])


def _check_tp(params: Any, tp_axis: Optional[str]) -> int:
    """The tp extent of ``params``: the length of its list of the tp
    ranks' trees with ``tp_axis``, 1 without."""
    if tp_axis is None:
        return 1
    if not isinstance(params, list) or not params or not all(
            isinstance(p, dict) for p in params):
        raise ValueError("with tp_axis, params is the list of the tp ranks' "
                         "trees (param_specs(cfg, tp_axis='tp', tp_size=tp), "
                         "parallel.sharded.split_ep)")
    return len(params)


def _kv_rep_slice(lyr: Params, cfg: LlamaConfig, r: int, tp: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """kv-head replication (tp > n_kv): wk/wv arrive replicated; rank r
    slices the ONE kv head serving its query group, ``g = r n_kv // tp``
    (its n_heads/tp query heads all map to it because n_kv | tp).  The
    slice's backward adds the rank's cotangent into that head's columns;
    the trainer's sum over the tp rows ties the replicas (JAX's psum).
    Shared by training and decoding.  Returns (wk, wv), ONE head each."""
    Hd = cfg.head_dim
    if lyr["wk"].shape[1] != cfg.n_kv_heads * Hd:
        raise ValueError(
            f"tp={tp} > n_kv_heads={cfg.n_kv_heads} needs wk/wv "
            f"REPLICATED over tp (local width {lyr['wk'].shape[1]}, "
            f"expected {cfg.n_kv_heads * Hd}) — pass tp_size to "
            f"param_specs/stacked_param_specs")
    g = (r * cfg.n_kv_heads) // tp
    return (lyr["wk"][:, g * Hd:(g + 1) * Hd],
            lyr["wv"][:, g * Hd:(g + 1) * Hd])


def _col(h: torch.Tensor, ws: Sequence[torch.Tensor]) -> torch.Tensor:
    """Column-parallel product: each tp rank's ``h @ w``, concatenated in
    rank order on the last axis (for the heads, the unsharded order)."""
    if len(ws) == 1:
        return h @ ws[0]
    return torch.cat([h @ w for w in ws], dim=-1)


def _row_sum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The tp ranks' row-parallel partials added in rank order, in their
    dtype (JAX's ``psum`` over tp)."""
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def _qkv(lyrs: Sequence[Params], h: torch.Tensor, cfg: LlamaConfig,
         n_kv: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q, k, v ``[.., S, heads Hd]`` of every tp rank of ``lyrs``, heads in
    rank order; ``n_kv`` the per-rank kv heads (0: replicated, one sliced
    head a rank)."""
    tp = len(lyrs)
    if n_kv == 0:
        wk, wv = zip(*(_kv_rep_slice(lyr, cfg, r, tp)
                       for r, lyr in enumerate(lyrs)))
    else:
        wk = [lyr["wk"] for lyr in lyrs]
        wv = [lyr["wv"] for lyr in lyrs]
    return (_col(h, [lyr["wq"] for lyr in lyrs]), _col(h, wk),
            _col(h, wv))


def _out_proj(att: torch.Tensor, lyrs: Sequence[Params]) -> torch.Tensor:
    """``att @ wo``, row-parallel over the tp ranks: rank r's columns of
    ``att`` (its heads) times its rows of ``wo``, the partials summed."""
    if len(lyrs) == 1:
        return att @ lyrs[0]["wo"]
    w = att.shape[-1] // len(lyrs)
    return _row_sum([att[..., r * w:(r + 1) * w] @ lyr["wo"]
                     for r, lyr in enumerate(lyrs)])


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


def _attention(lyr: Any, x: torch.Tensor, pos: torch.Tensor,
               cfg: LlamaConfig, n_heads: int, n_kv: int,
               sp_axis: Optional[str] = None,
               sp_attn: str = "ring") -> torch.Tensor:
    """The attention half of a decoder layer with its residual: pre-norm
    attention, ``x + att @ wo``.  x: [B, S, D], or [n_sp, B, S, D] with
    ``sp_axis``, the shards attending through ``ring_attention``
    (``sp_attn="ring"``) or ``gathered_attention`` (``"gather"``, JAX's
    form inside the 1F1B schedules).  ``lyr`` is the layer, or its tp
    ranks' layers (a list; ``n_heads``/``n_kv`` per rank, ``_shard_counts``):
    every rank's heads then attend in one call, and ``wo`` is
    row-parallel."""
    lead, S = x.shape[:-2], x.shape[-2]
    Hd = cfg.head_dim
    lyrs = _units(lyr)
    h = _rmsnorm(x, lyrs[0]["attn_norm"], cfg.norm_eps)
    q, k, v = _qkv(lyrs, h, cfg, n_kv)
    n_heads, n_kv = n_heads * len(lyrs), max(n_kv, 1) * len(lyrs)
    q = q.reshape(*lead, S, n_heads, Hd).transpose(-3, -2)
    k = k.reshape(*lead, S, n_kv, Hd).transpose(-3, -2)
    v = v.reshape(*lead, S, n_kv, Hd).transpose(-3, -2)
    q = _rope(q, pos, cfg)
    k = _rope(k, pos, cfg)
    # GQA: the flash kernels read grouped K/V (on the sp ring: 1/G of the
    # rotated bytes); the torch paths' einsums take the repeat-expanded
    # copy (head h reads KV h // G).  Grouped K/V only reach the branches
    # that can take the kernels, by the route the ops themselves take.
    kernel_branch = sp_axis is not None or cfg.attn_block is not None
    q_shard = q if sp_axis is None else q[0]
    gather = sp_axis is not None and sp_attn == "gather"
    kv_len = S * x.shape[0] if gather else S
    if n_kv != n_heads and not (kernel_branch
                                and pallas_route(cfg.attn_impl, q_shard,
                                                 kv_seq_len=kv_len)):
        k = k.repeat_interleave(n_heads // n_kv, dim=-3)
        v = v.repeat_interleave(n_heads // n_kv, dim=-3)
    if gather:
        att = gathered_attention(q, k, v, sp_axis, causal=True,
                                 impl=cfg.attn_impl)
    elif sp_axis is not None:
        att = ring_attention(q, k, v, sp_axis, causal=True,
                             impl=cfg.attn_impl)
    elif cfg.attn_block is not None:
        att = flash_attention_remat(q, k, v, causal=True,
                                    k_block=cfg.attn_block,
                                    impl=cfg.attn_impl)
    else:
        att = full_attention(q, k, v, causal=True)
    att = att.transpose(-3, -2).reshape(*lead, S, n_heads * Hd)
    return x + _out_proj(att, lyrs)


def _dense_ffn(lyr: Any, h: torch.Tensor) -> torch.Tensor:
    """SwiGLU: silu in f32, back to the activation dtype.  ``lyr`` a list
    of the tp ranks' layers: each rank's SwiGLU over its hidden slice,
    the row-parallel partials summed (``_row_sum``)."""
    if isinstance(lyr, list):
        return _row_sum([_dense_ffn(one, h) for one in lyr])
    gate = F.silu((h @ lyr["w1"]).to(torch.float32)).to(h.dtype)
    return (gate * (h @ lyr["w3"])) @ lyr["w2"]


def _moe_shards(units: Sequence[List[Params]]) -> List[Params]:
    """The expert shards of the ep ranks' layer units for
    ``ops.moe.moe_ranks``: tp major, ``shards[t n_ep + e]``."""
    return [u[t]["moe"] for t in range(len(units[0])) for u in units]


def _block(lyr: Any, x: torch.Tensor, pos: torch.Tensor,
           cfg: LlamaConfig, n_heads: int, n_kv: int,
           sp_axis: Optional[str] = None
           ) -> Tuple[torch.Tensor, Optional[moe_ops.AuxParts]]:
    """One decoder layer: pre-norm attention + SwiGLU or MoE FFN.  x:
    [B, S, D], or [n_sp, B, S, D] with ``sp_axis`` (each sp shard routes
    its own tokens, as a JAX sp rank does); ``lyr`` the layer or its tp
    ranks' layers.  Returns ``(x, parts)``: the MoE layer's aux
    statistics over its tokens, None when dense."""
    x = _attention(lyr, x, pos, cfg, n_heads, n_kv, sp_axis)
    lyrs = _units(lyr)
    h = _rmsnorm(x, lyrs[0]["mlp_norm"], cfg.norm_eps)
    if "moe" not in lyrs[0]:
        return x + _dense_ffn(lyr, h), None
    hs = h if sp_axis is not None else h[None]
    ff, parts = moe_ops.moe_ranks(lyrs[0]["moe"]["wr"], _moe_shards([lyrs]),
                                  hs, cfg.moe, len(lyrs))
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
    ``[B, S, D]`` each, or ``[n_sp, B, S_local, D]`` with sp; ``lyrs``
    its ranks' layers (each a list of its tp ranks' with tp).  Every (ep,
    sp) device is a source of the exchange, routing its own tokens with
    its ep rank's router copy (tp rank 0's); returns the outputs stacked
    as ``hs``, each expert's tp partials summed."""
    units = [_units(lyr) for lyr in lyrs]
    x = torch.stack(hs)
    wr = torch.stack([u[0]["moe"]["wr"] for u in units])
    if x.dim() == 5:                            # [n_ep, n_sp, B, S, D]
        wr = wr.repeat_interleave(x.shape[1], dim=0)
    ff, parts = moe_ops.moe_ranks(wr, _moe_shards(units),
                                  x.flatten(0, x.dim() - 4), cfg.moe,
                                  len(units[0]))
    return ff.reshape(x.shape), parts


def _layer_groups(lyrs: Sequence[Sequence[Params]], sizes: Sequence[int],
                  pos: torch.Tensor, cfg: LlamaConfig,
                  sp_axis: Optional[str], sp_attn: str, *flat: torch.Tensor
                  ) -> Tuple[List[torch.Tensor], Optional[moe_ops.AuxParts]]:
    """One decoder layer over every group's ranks, ``flat`` their
    activations in group order (``sizes`` ranks a group): attention a
    rank at a time on its own tree (its sp shards with ``sp_axis``, by
    ``sp_attn``), the FFN dense a rank or MoE over the group.  Returns
    the new activations in the same order and the MoE statistics pooled
    over the groups (None when dense)."""
    n_heads, n_kv = _shard_counts(cfg, len(_units(lyrs[0][0])))
    out, parts, at = [], [], 0
    for g_lyrs, k in zip(lyrs, sizes):
        xg = [_attention(lyr, x, pos, cfg, n_heads, n_kv, sp_axis, sp_attn)
              for lyr, x in zip(g_lyrs, flat[at:at + k])]
        at += k
        hs = [_rmsnorm(x, _units(lyr)[0]["mlp_norm"], cfg.norm_eps)
              for lyr, x in zip(g_lyrs, xg)]
        if "moe" in _units(g_lyrs[0])[0]:
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
    as the tokens plus ``V`` a group (where a rank is the list of its tp
    ranks' trees, a list of the tp ranks' vocab shards a group), and each
    MoE layer's statistics pooled over every group (JAX's psum over all
    token axes)."""
    S = tokens[0].shape[-1]
    pos = _positions(S, sp_axis, tokens[0].device,
                     n_sp=tokens[0].shape[1] if sp_axis else 1)
    xs = [_units(t)[0]["tok_emb"][tok.long()]
          for trees, toks in zip(groups, tokens)
          for t, tok in zip(trees, toks)]
    sizes = [len(trees) for trees in groups]
    layer_parts = []
    for i in range(cfg.n_layers):
        args = ([[_layer(t, i) for t in trees] for trees in groups],
                sizes, pos, cfg, sp_axis, "ring", *xs)
        xs, parts = (checkpoint(_layer_groups, *args, use_reentrant=False)
                     if remat else _layer_groups(*args))
        if parts is not None:
            layer_parts.append(parts)
    it = iter(xs)
    xs = [[next(it) for _ in range(k)] for k in sizes]
    logits = [_stack_heads([_head(t, x, cfg) for t, x in zip(trees, xg)])
              for trees, xg in zip(groups, xs)]
    return logits, layer_parts


def _head(p: Any, x: torch.Tensor, cfg: LlamaConfig) -> Any:
    """The final norm and the head of one rank: logits ``[.., V]``, or with
    its tp ranks' trees their vocab shards, a list of ``[.., V/tp]``."""
    units = _units(p)
    x = _rmsnorm(x, units[0]["final_norm"], cfg.norm_eps)
    if isinstance(p, dict):
        return x @ p["lm_head"]
    return [x @ u["lm_head"] for u in units]


def _stack_heads(outs: Sequence[Any]) -> Any:
    """The ranks' ``_head`` outputs stacked: one tensor, or a list of one
    a tp rank's vocab shard."""
    if isinstance(outs[0], list):
        return [torch.stack(col) for col in zip(*outs)]
    return torch.stack(outs)


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
          ep_axis: Optional[str] = None, gather_logits: bool = True,
          with_aux: bool = False, remat: bool = False):
    """tokens [B, S] -> logits [B, S, vocab] in the model dtype; with
    ``sp_axis``, tokens [n_sp, B, S_local] -> [n_sp, B, S_local, vocab];
    with ``ep_axis``, params the ep ranks' trees and tokens [n_ep, B, S]
    -> [n_ep, B, S, vocab] (with both, [n_ep, n_sp, B, S_local] ->
    [n_ep, n_sp, B, S_local, vocab]).  With ``tp_axis``, params the tp
    ranks' trees (with ``ep_axis``, each ep rank's a list of them): the
    logits are gathered over tp, or with ``gather_logits=False`` stay the
    tp ranks' vocab shards, a list of ``[.., vocab/tp]``.  ``with_aux``:
    ``(logits, aux)``, the MoE load-balance term over every token of the
    call (0 when dense).  ``remat``: each block recomputed in the
    backward."""
    if ep_axis is not None:
        _check_ep(params, tokens, sp_axis)
        for p in params:
            tp = _check_tp(p, tp_axis)
        _shard_counts(cfg, tp)
        logits, layer_parts = _forward_groups([params], [tokens], cfg,
                                              sp_axis, remat)
        logits = logits[0]
    else:
        tp = _check_tp(params, tp_axis)
        if tokens.dim() != (2 if sp_axis is None else 3):
            raise ValueError(f"tokens must be [B, S] (or [n_sp, B, S_local] "
                             f"with sp_axis), got {tuple(tokens.shape)}")
        S = tokens.shape[-1]
        n_heads, n_kv = _shard_counts(cfg, tp)
        pos = _positions(S, sp_axis, tokens.device, n_sp=tokens.shape[0])
        x = _units(params)[0]["tok_emb"][tokens.long()]     # [.., S, D]
        layer_parts = []
        for i in range(cfg.n_layers):
            args = (_layer(params, i), x, pos, cfg, n_heads, n_kv, sp_axis)
            x, parts = (checkpoint(_block, *args, use_reentrant=False)
                        if remat else _block(*args))
            if parts is not None:
                layer_parts.append(parts)
        logits = _head(params, x, cfg)
    if tp_axis is not None and gather_logits:
        logits = torch.cat(logits, dim=-1)
    if not with_aux:
        return logits
    dev = (logits[0] if isinstance(logits, list) else logits).device
    return logits, _aux(layer_parts, cfg, dev)


def _vocab_parallel_nll(logits: Sequence[torch.Tensor],
                        labels: torch.Tensor, tp_axis: str) -> torch.Tensor:
    """Per-token NLL from the tp ranks' vocab shards of the logits
    ``[.., V/tp]`` each, without gathering them — JAX's Megatron-style
    distributed softmax cross-entropy: the max (a stability shift, no
    gradient) over the ranks, the exp-sums and the target logit summed
    over them in rank order (JAX's pmax and psums over ``tp_axis``).  One
    value a token, so each shard's gradient is counted once."""
    lfs = [lg.to(torch.float32) for lg in logits]
    Vl = lfs[0].shape[-1]
    m = lfs[0].detach().amax(dim=-1)
    for lf in lfs[1:]:
        m = torch.maximum(m, lf.detach().amax(dim=-1))
    z = _row_sum([torch.exp(lf - m[..., None]).sum(dim=-1) for lf in lfs])
    zero = torch.zeros((), dtype=torch.float32, device=m.device)
    tgt = []
    for r, lf in enumerate(lfs):
        local = labels.long() - r * Vl
        in_range = (local >= 0) & (local < Vl)
        safe = torch.clamp(local, 0, Vl - 1)
        t = lf.gather(-1, safe[..., None])[..., 0]
        tgt.append(torch.where(in_range, t, zero))
    return torch.log(z) + m - _row_sum(tgt)


def _token_nll(logits: Any, safe_labels: torch.Tensor,
               tp_axis: Optional[str] = None) -> torch.Tensor:
    """Per-token NLL [B, S] from f32 log-softmax; with ``tp_axis`` the
    logits are the tp ranks' vocab shards (``_vocab_parallel_nll``)."""
    if tp_axis is not None:
        return _vocab_parallel_nll(logits, safe_labels, tp_axis)
    logz = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return -logz.gather(-1, safe_labels.long()[..., None])[..., 0]


def _masked_nll(logits: Any, labels: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(per-token NLL with -100 labels zeroed, the valid mask); logits a
    list are the tp ranks' vocab shards."""
    valid = labels >= 0
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    tp_axis = "tp" if isinstance(logits, list) else None
    nll = torch.where(valid, _token_nll(logits, safe, tp_axis),
                      torch.zeros((), dtype=torch.float32,
                                  device=labels.device))
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
            remat: bool = False,
            dp_size: Optional[int] = None) -> torch.Tensor:
    """Next-token cross-entropy plus the MoE load-balance term.  batch =
    (tokens, labels), both [B, S] (or [n_sp, B, S_local] with
    ``sp_axis``: the stacked shards, labels the globally shifted targets,
    so the shift crosses shard boundaries; or [n_ep, B, S] with
    ``ep_axis``, params the ep ranks' trees; [n_ep, n_sp, B, S_local]
    with both); -100 entries are ignored.
    With ``sp_axis`` or ``ep_axis`` the value is the token-weighted mean
    over all the shards, as each JAX rank's.  With ``tp_axis`` params is
    the tp ranks' trees (``apply``) and the NLL comes from the vocab
    shards (``_vocab_parallel_nll``): one value, whatever the tp.
    ``dp_axis`` raises: a dense model's per-rank loss and the trainer's
    uniform dp average equal the JAX dp_axis weighting when every label
    is valid; with masked labels a dp rank's batch carries the global
    count, ``(tokens, labels, count)`` (``models.bert.with_global_count``)
    and ``dp_size=n`` gives ``n * local_sum / count``, JAX's ``dp_axis``
    weighting (dense models; a MoE model trains through ``dp_loss_fn``)."""
    if dp_axis is not None:
        raise NotImplementedError(
            "dp_axis (the masked-label dp weighting inside a sharded "
            "program) is not ported; a dp rank's batch carries the global "
            "count (models.bert.with_global_count) with dp_size=n (a MoE "
            "model takes llama.dp_loss_fn)")
    tokens, labels = batch[0], batch[1]
    if len(batch) == 3 or dp_size is not None:
        _check_moe_dp(cfg, dp_size)
    out = apply(params, tokens, cfg, tp_axis=tp_axis, sp_axis=sp_axis,
                ep_axis=ep_axis, gather_logits=False,
                with_aux=cfg.moe is not None, remat=remat)
    logits = out[0] if cfg.moe is not None else out
    nll, valid = _masked_nll(logits, labels)
    if len(batch) == 3 or dp_size is not None:
        num, denom = _pp_weight(batch, dp_size)
        return num * nll.sum() / denom
    loss = _weighted_loss(nll.sum(), valid.sum())
    return loss + out[1] if cfg.moe is not None else loss


def dp_loss_fn(cfg: LlamaConfig, n_dp: int, n_ep: int = 1, *,
               n_sp: int = 1, tp_axis: Optional[str] = None,
               remat: bool = False) -> Callable:
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
    With ``tp_axis`` the trees come as ``ShardedTrainer`` gives them at
    tp > 1, ``params[t][e n_dp + d]`` (its ``P((tp, ep, dp))`` rows), rank
    (d, e)'s tp trees ``[params[t][e n_dp + d] for t]``; the losses are
    still one a (dp, ep) rank.

    JAX's ``loss_fn(dp_axis="dp", ep_axis="ep"[, sp_axis="sp"])``: every
    value is the global token-weighted cross-entropy plus the aux over
    the global routing statistics; the gradient of the losses' sum is
    n_dp times the unsharded one (the CE through each rank's own tokens,
    the aux once), which the trainer's ep sum of the replicated leaves
    and its dp average (sum / n_dp) turn into the single-device
    gradient.

    A batch with a third leaf, the global label count of each microbatch
    (``models.bert.with_global_count``, ``[n_dp, (n_ep,) a]`` as
    ``VirtualRanks.shard_count`` lays it), divides by that count
    (``_joint_denom``); the ranks of one call pool the same labels, so
    the value and the bits are those of the pooled count."""
    n = n_dp * n_ep
    sp_axis = "sp" if n_sp > 1 else None
    lead = (n_dp, n_ep) + ((n_sp,) if n_sp > 1 else ())

    def loss(params_per_rank, batch):
        toks, labels = (b.reshape(*lead, *b.shape[-2:]) for b in batch[:2])
        if tp_axis is not None:
            groups = [[[p[e * n_dp + d] for p in params_per_rank]
                       for e in range(n_ep)] for d in range(n_dp)]
        else:
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
        denom = _joint_denom(batch, torch.stack(counts).sum())
        ce = (local.sum() / denom).detach() + n_dp * (
            local - local.detach()) / denom
        aux = _aux(layer_parts, cfg, local.device)
        return ce + aux.detach() + n_dp * (aux - aux.detach()) / n

    loss.joint_ranks = True
    return loss


# -- the pipeline-parallel path ---------------------------------------------
#
# The pp losses run over a set of batch ranks at once: ``stages[s]`` the
# ranks' trees of stage s (a rank's row of the trainer's ``P((pp, ep,
# dp))`` layout) in group order, ``sizes`` the ranks of each MoE
# exchange group (a dp rank's ep ranks).  The ranks' activations go batch
# first into one ``[b, R, ...]`` tensor (``_batch_first``), so the
# schedules cut every rank's batch into the same microbatches: microbatch
# m is the m-th of every rank, and a stage's MoE layers route it over all
# the ranks at once (the statistics pooled per microbatch and layer,
# JAX's psum over the batch axes).  A dense model's trainer runs one dp
# rank at a time (R = 1); a MoE model's runs every rank in one graph.


def stack_params(params: Params) -> Params:
    """The list-of-layers tree with its layers stacked into ``[n_layers,
    ...]`` leaves, the axis pp splits (``parallel.pipeline.stack_layers``)."""
    out = dict(params)
    out["layers"] = pipeline.stack_layers(params["layers"])
    return out


def stacked_param_specs(cfg: LlamaConfig, ep_axis: Optional[str] = None,
                        tp_axis: Optional[str] = None,
                        tp_size: Optional[int] = None) -> Params:
    """JAX's ``stacked_param_specs(cfg, tp_axis=..., ep_axis=...,
    tp_size=...)``: ``"pp"`` at the stacked layer leaves (split on their
    layer axis, one slice a stage); with ``ep_axis``, ``"pp,ep"`` at a MoE
    layer's experts (JAX's ``P("pp", "ep")``: the layer axis over pp, then
    the expert axis over ep) and ``"pp"`` at its router, which replicates
    over ep; with ``tp_axis``, a layer leaf's ``param_specs`` behind its
    layer axis (``Spec("pp", None, "tp")``); ``tok_emb``, ``final_norm``
    and ``lm_head`` as ``param_specs`` gives them (every stage holds
    them; ``parallel.sharded.split_ep``)."""
    base = param_specs(cfg, tp_axis, ep_axis, tp_size)

    def one(spec):
        dims = spec_dims(spec)
        if not dims:
            return "pp"
        if tp_axis is None:
            return ",".join(("pp",) + dims)
        return Spec("pp", *dims)
    return {"tok_emb": base["tok_emb"], "final_norm": base["final_norm"],
            "lm_head": base["lm_head"],
            "layers": {k: ({kk: one(vv) for kk, vv in v.items()}
                           if isinstance(v, dict) else one(v))
                       for k, v in base["layers"][0].items()}}


def _joint_denom(batch, pooled: torch.Tensor) -> torch.Tensor:
    """The CE denominator of a loss over every rank at once: the global
    label count the batch carries as its third leaf (every entry of a
    microbatch the same), else the labels the call pools."""
    count = batch[2].reshape(-1)[0] if len(batch) == 3 else pooled
    return torch.clamp(count, min=1).to(torch.float32)


def _check_pp(dp_axis: Optional[str] = None) -> None:
    if dp_axis is not None:
        raise NotImplementedError(
            "dp_axis is a JAX mesh axis; the port's dp ranks carry the "
            "global label count in the batch (models.bert."
            "with_global_count) and pass dp_size=n")


def _check_moe_dp(cfg: LlamaConfig, dp_size: Optional[int]) -> None:
    if cfg.moe is not None and dp_size is not None:
        raise NotImplementedError(
            "a MoE model's dp ranks share the aux of their pooled routing "
            "statistics, which a loss of one dp rank cannot take: train "
            "through llama.pp_dp_loss_fn / pp_dp_loss_and_grads_fn")


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


def _pp_ranks(params: Sequence[Any], tokens: torch.Tensor,
              labels: torch.Tensor, sp_axis: Optional[str],
              ep_axis: Optional[str], tp_axis: Optional[str] = None):
    """One dp rank's call as the ranks the pp cores take: ``(stages,
    tokens, labels, sizes)``, one rank, or with ``ep_axis`` its ep ranks
    (``params[s]`` their trees of stage s, tokens ``[n_ep, ...]``) as one
    group.  With ``tp_axis`` a rank's tree of a stage is the list of its
    tp ranks' trees (``_check_tp``)."""
    dims = 2 + (sp_axis is not None) + (ep_axis is not None)
    if tokens.dim() != dims:
        raise ValueError(
            f"tokens must be [B, S] ([n_sp, B, S_local] with sp_axis; "
            f"[n_ep, ...] ahead with ep_axis), got {tuple(tokens.shape)}")
    if ep_axis is None:
        stages = [[p] for p in params]
    elif any(isinstance(p, dict) or len(p) != tokens.shape[0]
             for p in params):
        raise ValueError("with ep_axis, params[s] is the list of the ep "
                         "ranks' trees of stage s")
    else:
        stages = [list(p) for p in params]
    for st in stages:
        for unit in st:
            if tp_axis is None and not isinstance(unit, dict):
                raise ValueError("a list of a rank's trees needs tp_axis")
            _check_tp(unit, tp_axis)
    if ep_axis is None:
        return stages, [tokens], [labels], [1]
    return stages, list(tokens), list(labels), [tokens.shape[0]]


def _stage_layers(unit: Any) -> Any:
    """A rank's stacked layer slice: its tree's, or its tp ranks' (a
    list)."""
    return [u["layers"] for u in unit] if isinstance(unit, list) \
        else unit["layers"]


def _unstack_unit(layers: Any) -> List[Any]:
    """A rank's stacked slice as its layers, each the layer's tree or its
    tp ranks' layer trees (a list)."""
    if isinstance(layers, list):
        return [list(z) for z in zip(*(pipeline.unstack_layers(u)
                                       for u in layers))]
    return pipeline.unstack_layers(layers)


def _head_params(unit: Any) -> Any:
    """The head's leaves of a rank's tree (or of each of its tp ranks')."""
    if isinstance(unit, list):
        return [_head_params(u) for u in unit]
    return {k: unit[k] for k in ("final_norm", "lm_head")}


def _batch_first(xs: Sequence[torch.Tensor], sp: bool) -> torch.Tensor:
    """The ranks' ``[b, ...]`` tensors (``[n_sp, b, ...]`` with sp)
    stacked batch first: ``[b, R, ...]`` (``[b, R, n_sp, ...]``)."""
    return torch.stack([x.transpose(0, 1) if sp else x for x in xs], 1)


def _rank_view(X: torch.Tensor, r: int, sp: bool) -> torch.Tensor:
    """Rank r's slice of a ``_batch_first`` stack in the model's layout."""
    x = X[:, r]
    return x.transpose(0, 1) if sp else x


def _pp_stage(cfg: LlamaConfig, sizes: Sequence[int], pos: torch.Tensor,
              sp_axis: Optional[str], sp_attn: str, remat: bool) -> Callable:
    """``stage(layers, X) -> (X, aux)``: a stage's layer slice over the
    ranks (``layers[r]`` rank r's stacked layers, group order; X ``[b,
    R, ...]``),
    aux its MoE layers' load-balance terms summed (None when dense).
    ``remat``: each layer, all ranks at once, recomputed in the
    backward."""
    R, sp = sum(sizes), sp_axis is not None

    def stage(layers, X):
        per_rank = [_unstack_unit(layers[r]) for r in range(R)]
        xs = [_rank_view(X, r, sp) for r in range(R)]
        aux = None
        for i in range(len(per_rank[0])):
            lyrs, at = [], 0
            for k in sizes:
                lyrs.append([per_rank[r][i] for r in range(at, at + k)])
                at += k
            xs, parts = pipeline._maybe_remat(
                _layer_groups, remat, lyrs, sizes, pos, cfg, sp_axis,
                sp_attn, *xs)
            if parts is not None:
                a = moe_ops.aux_loss(parts, cfg.moe)
                aux = a if aux is None else aux + a
        return _batch_first(xs, sp), aux
    return stage


def _pp_pos(tokens: Sequence[torch.Tensor],
            sp_axis: Optional[str]) -> torch.Tensor:
    t = tokens[0]
    return _positions(t.shape[-1], sp_axis, t.device,
                      n_sp=t.shape[0] if sp_axis is not None else 1)


def _pp_forward(stages, tokens, cfg: LlamaConfig, M: int,
                sizes: Sequence[int], sp_axis: Optional[str], sp_attn: str,
                remat: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stage 0's embedding, then GPipe over the stages: the last stage's
    output ``[b, R, ...]`` and the aux (summed over the stages, a mean
    over the microbatches; 0 when dense)."""
    sp = sp_axis is not None
    X = _batch_first([_units(t)[0]["tok_emb"][tok.long()]
                      for t, tok in zip(stages[0], tokens)], sp)
    return pipeline.pipeline_apply_aux(
        _pp_stage(cfg, sizes, _pp_pos(tokens, sp_axis), sp_axis, sp_attn,
                  remat), [[_stage_layers(t) for t in st] for st in stages],
        X, M)


def _pp_gpipe(stages, tokens, labels, cfg: LlamaConfig, M: int,
              sizes: Sequence[int], sp_axis: Optional[str], sp_attn: str,
              remat: bool):
    """GPipe over the ranks: ``(NLL sums [R], valid counts [R], aux)``,
    the head a microbatch at a time on the last stage (at most M
    microbatches' log-softmax held for the backward)."""
    sp = sp_axis is not None
    X, aux = _pp_forward(stages, tokens, cfg, M, sizes, sp_axis, sp_attn,
                         remat)
    mb = X.shape[0] // M
    sums = []
    for r, (hp, lab) in enumerate(zip(stages[-1], labels)):
        lab = lab.transpose(0, 1) if sp else lab
        sums.append(sum(_head_nll_sum(hp, h, lb, cfg) for h, lb in
                        zip(X[:, r].split(mb), lab.split(mb))))
    counts = torch.stack([(lab >= 0).sum() for lab in labels])
    return torch.stack(sums), counts, aux


def apply_pp(params: Sequence[Any], tokens: torch.Tensor,
             cfg: LlamaConfig, *, num_microbatches: int,
             tp_axis: Optional[str] = None, sp_axis: Optional[str] = None,
             ep_axis: Optional[str] = None, sp_attn: str = "ring",
             with_aux: bool = False, remat: bool = False):
    """The pipelined forward: ``params`` the pp stages' trees (stage s's
    stacked layer slice and its copies of ``tok_emb``, ``final_norm``
    and ``lm_head``; ``parallel.sharded.split_ep`` of ``stack_params``
    over ``stacked_param_specs``), tokens [B, S] -> logits [B, S, vocab]:
    stage 0's embedding, GPipe over ``num_microbatches``, the last
    stage's head.  ``apply``'s layouts: with ``sp_axis`` tokens [n_sp, B,
    S_local], the shards attending by ``sp_attn``; with ``ep_axis``
    ``params[s]`` the ep ranks' trees of stage s and tokens [n_ep, ...].
    With ``tp_axis`` each rank's tree of a stage is its tp ranks' list
    and the logits are their vocab shards gathered.  ``with_aux``:
    ``(logits, aux)``, the MoE term (summed over the stages, a mean over
    the microbatches).  ``remat``: each layer recomputed in the
    backward."""
    stages, toks, _, sizes = _pp_ranks(params, tokens, tokens, sp_axis,
                                       ep_axis, tp_axis)
    sp = sp_axis is not None
    X, aux = _pp_forward(stages, toks, cfg, num_microbatches, sizes,
                         sp_axis, sp_attn, remat)
    heads = [_head(hp, _rank_view(X, r, sp), cfg)
             for r, hp in enumerate(stages[-1])]
    logits = torch.stack([torch.cat(h, dim=-1) if isinstance(h, list)
                          else h for h in heads])
    logits = logits if ep_axis is not None else logits[0]
    return (logits, aux) if with_aux else logits


def _head_nll_sum(hp: Any, h: torch.Tensor, labels: torch.Tensor,
                  cfg: LlamaConfig) -> torch.Tensor:
    """The head on one microbatch: the NLL summed over its valid labels
    (``hp`` a rank's head leaves, or its tp ranks': the vocab-parallel
    NLL of ``_masked_nll``)."""
    return _masked_nll(_head(hp, h, cfg), labels)[0].sum()


def loss_fn_pp(params: Sequence[Any], batch, cfg: LlamaConfig, *,
               num_microbatches: int, dp_size: Optional[int] = None,
               tp_axis: Optional[str] = None, sp_axis: Optional[str] = None,
               dp_axis: Optional[str] = None, ep_axis: Optional[str] = None,
               sp_attn: str = "ring", remat: bool = False) -> torch.Tensor:
    """Next-token cross-entropy plus the MoE term through GPipe
    (``apply_pp``'s forward) for one dp rank: ``batch = (tokens,
    labels)`` in ``apply_pp``'s layouts, -100 labels ignored; the NLL
    summed over every token of the call (the head a microbatch at a
    time: at most ``num_microbatches`` microbatches' log-softmax held for
    the backward) over the valid count, plus the aux.  With ``batch =
    (tokens, labels, count)`` (a rank's shard of
    ``models.bert.with_global_count``) and ``dp_size=n``: ``n * local_sum
    / count``, JAX's ``dp_axis`` weighting (dense models; a MoE model's
    dp ranks train through ``pp_dp_loss_fn``).  With ``tp_axis`` each
    rank's tree of a stage is its tp ranks' list, the head's NLL the
    vocab-parallel one.  ``remat``: each layer recomputed in the
    backward, as JAX's driver runs its pp losses."""
    _check_pp(dp_axis)
    _check_moe_dp(cfg, dp_size)
    stages, toks, labs, sizes = _pp_ranks(params, batch[0], batch[1],
                                          sp_axis, ep_axis, tp_axis)
    num, denom = _pp_weight(batch, dp_size)
    local, _, aux = _pp_gpipe(stages, toks, labs, cfg, num_microbatches,
                              sizes, sp_axis, sp_attn, remat)
    return num * local.sum() / denom + aux


def _rank_order(n_dp: int, n_ep: int) -> List[int]:
    """Each rank's row (``e n_dp + d``, JAX's ``P((ep, dp))`` within a
    stage group) in group order (a dp rank's ep ranks together)."""
    return [e * n_dp + d for d in range(n_dp) for e in range(n_ep)]


def _rank_batch(x: torch.Tensor, n: int, n_sp: int) -> List[torch.Tensor]:
    """A ``[n_dp, (n_ep,) (n_sp,) B, S]`` batch leaf as the ranks' leaves
    in group order."""
    tail = 3 if n_sp > 1 else 2
    return list(x.reshape(n, *x.shape[x.dim() - tail:]).unbind(0))


def pp_dp_loss_fn(cfg: LlamaConfig, n_dp: int, n_ep: int = 1, *,
                  num_microbatches: int, n_sp: int = 1, remat: bool = False,
                  sp_attn: str = "ring") -> Callable:
    """The trainers' GPipe loss of a MoE Llama over n_dp x n_ep ranks at
    once, marked ``joint_ranks``: ``(stage_trees, batch) -> [n_dp n_ep]``
    losses, ``stage_trees[s][e n_dp + d]`` rank (d, e)'s tree of stage s
    (its row of ``P((pp, ep, dp))``), the batch ``[n_dp, n_ep, (n_sp,)
    B, S]`` (``VirtualRanks.shard``; ``[n_dp, ...]`` without ep).
    ``dp_loss_fn``'s weighting: every value the global token-weighted
    cross-entropy plus the aux (each stage's MoE layers routing every
    rank's microbatch at once, summed over the stages, a mean over the
    microbatches: JAX's ``loss_fn_pp`` over the batch axes), the
    gradient of the values' sum n_dp times the unsharded one."""
    n = n_dp * n_ep
    sp_axis = "sp" if n_sp > 1 else None
    order = _rank_order(n_dp, n_ep)
    inv = np.argsort(order).tolist()

    def loss(stage_trees, batch):
        toks, labels = (_rank_batch(b, n, n_sp) for b in batch[:2])
        stages = [[st[r] for r in order] for st in stage_trees]
        local, counts, aux = _pp_gpipe(stages, toks, labels, cfg,
                                       num_microbatches, [n_ep] * n_dp,
                                       sp_axis, sp_attn, remat)
        local = torch.stack([local[i] for i in inv])     # row order
        denom = _joint_denom(batch, counts.sum())
        ce = (local.sum() / denom).detach() + n_dp * (
            local - local.detach()) / denom
        return ce + aux.detach() + n_dp * (aux - aux.detach()) / n

    loss.joint_ranks = True
    return loss


def _pp_1f1b(stages, tokens, labels, cfg: LlamaConfig, M: int, v: int,
             sizes: Sequence[int], sp_axis: Optional[str], remat: bool,
             num: int, denom: torch.Tensor, aux_w: float,
             out: Optional[List[List[Params]]]):
    """The 1F1B schedules (interleaved when v > 1) over the ranks: a unit
    is stage s on microbatch m across every rank, the sp shards on the
    gathered attention (JAX's form inside the schedules).  As JAX's: the
    head returns the microbatch's NLL sum over the ranks, the schedule
    the mean over M, and every gradient is scaled by ``M num / denom`` at
    the end; a MoE stage adds its aux times ``c = aux_w denom / (M
    num)`` to the differentiated channel, so the scaled gradient is
    ``aux_w`` times the aux's (JAX's ``c_aux = 1 / (M w n_rep)`` holds
    one aux copy a device; the one graph here holds one copy), and the
    report channel carries the raw NLL and aux sums.  The embedding is
    differentiated outside the schedule through its d_x.  Returns
    ``(NLL sum, aux, grads)``: aux summed over the stages, a mean over M
    (0 when dense); ``grads[s][r]`` f32 trees (``out``'s when given),
    the replicated leaves' the same in every stage."""
    sp, moe = sp_axis is not None, cfg.moe is not None
    R = len(stages[0])
    zero = torch.zeros((), dtype=torch.float32, device=tokens[0].device)
    block = _pp_stage(cfg, sizes, _pp_pos(tokens, sp_axis), sp_axis,
                      "gather" if sp else "ring", remat)
    scale = M * num / denom
    c_aux = aux_w / scale

    def stage_fn(sp_, hp, x_in, c_in):
        h, aux = block(sp_, x_in)
        if moe:
            return h, c_aux * aux, torch.stack([zero, aux.detach()])
        return h, zero

    def loss_head_fn(hp, h, lab):
        tot = sum(_head_nll_sum(hp[r], h[:, r], lab[:, r], cfg)
                  for r in range(R))
        return (tot, torch.stack([tot.detach(), zero])) if moe else tot

    def chunks(tree):
        return tree if v == 1 else tree_map(
            lambda t: t.reshape(v, t.shape[0] // v, *t.shape[1:]), tree)
    layers = [[chunks(_stage_layers(t)) for t in st] for st in stages]
    d_out = None if out is None else [[chunks(_stage_layers(o)) for o in os]
                                      for os in out]
    head = [_head_params(t) for t in stages[-1]]
    embs = [_units(t)[0]["tok_emb"].detach().requires_grad_()
            for t in stages[0]]
    with torch.enable_grad():
        x_full = _batch_first([e[tok.long()] for e, tok in zip(embs, tokens)],
                              sp)
    sched = ((lambda *a, **kw: pipeline.pipeline_train_1f1b_interleaved(
        *a, virtual_stages=v, **kw)) if v > 1
        else pipeline.pipeline_train_1f1b)
    res = sched(stage_fn, loss_head_fn, layers, head, x_full.detach(),
                _batch_first(labels, sp), M, report_len=2 if moe else 0,
                out=d_out)
    if moe:
        _, d_layers, d_head, d_x, report = res
        nll_sum, aux = report[0], report[1] / M
    else:
        mean_nll_sum, d_layers, d_head, d_x = res
        nll_sum, aux = M * mean_nll_sum, zero
    d_embs = torch.autograd.grad(x_full, embs, d_x.to(x_full.dtype))
    del x_full, d_x
    tp = isinstance(stages[0][0], list)
    if out is None:
        embs = [d_embs[r].to(torch.float32).mul_(scale) for r in range(R)]
        for t in tree_leaves(d_head):
            t.mul_(scale)

        def unit(layers, emb, hd):
            return {"layers": tree_map(
                lambda t: t.reshape(-1, *t.shape[2:]) if v > 1 else t,
                layers), "tok_emb": emb, **hd}
        # with tp, the embedding's copies past tp rank 0 stay zero until
        # the trainer's tp sum (the head's leaves are each tp rank's own)
        out = [[unit(d_layers[s][r], embs[r], d_head[r]) if not tp else
                [unit(ly, embs[r] if t == 0 else torch.zeros_like(embs[r]),
                      hd) for t, (ly, hd) in enumerate(zip(d_layers[s][r],
                                                           d_head[r]))]
                for r in range(R)] for s in range(len(stages))]
    else:
        for row in out:
            for r, o in enumerate(row):
                _units(o)[0]["tok_emb"].copy_(d_embs[r]).mul_(scale)
                for u, g in zip(_units(o), _units(d_head[r])):
                    for k, gk in g.items():
                        u[k].copy_(gk).mul_(scale)
    for row in d_layers:
        for r in range(R):
            for t in tree_leaves(row[r]):
                t.mul_(scale)
    return nll_sum, aux, out


def loss_and_grads_pp_1f1b(params: Sequence[Any], batch,
                           cfg: LlamaConfig, *, num_microbatches: int,
                           dp_size: Optional[int] = None,
                           virtual_stages: int = 1, remat: bool = False,
                           tp_axis: Optional[str] = None,
                           sp_axis: Optional[str] = None,
                           dp_axis: Optional[str] = None,
                           ep_axis: Optional[str] = None,
                           out: Optional[List[Any]] = None):
    """``loss_fn_pp``'s loss and its gradients under the 1F1B schedule
    (``parallel.pipeline.pipeline_train_1f1b``; with ``virtual_stages`` >
    1 the interleaved one, the stacked layers then in
    ``pipeline.interleave_layers`` order and num_microbatches a multiple
    of pp), with sp on the gathered attention (JAX's form inside the
    schedules) and ``apply_pp``'s layouts; the arithmetic is
    ``_pp_1f1b``'s.

    Returns ``(loss, grads)``: one f32 tree a stage (with ``ep_axis``, a
    list of the ep ranks' trees a stage), the layer slice's gradients
    its own, the replicated leaves' the same in every stage (summed over
    the stages: the embedding's from stage 0, the head's from the last).
    ``out``: f32 trees of that structure to write the gradients into
    (zeroed, e.g. views of the trainer's flat rows), returned as
    ``grads``.  With ``tp_axis`` each rank's tree (and gradient tree)
    of a stage is its tp ranks' list; a leaf that replicates over tp
    gets its gradient in tp rank 0's tree, zero in the others' (the
    trainer's tp sum completes them)."""
    _check_pp(dp_axis)
    _check_moe_dp(cfg, dp_size)
    stages, toks, labs, sizes = _pp_ranks(params, batch[0], batch[1],
                                          sp_axis, ep_axis, tp_axis)
    num, denom = _pp_weight(batch, dp_size)
    one = ep_axis is None
    if one and out is not None:
        out = [[o] for o in out]
    nll_sum, aux, grads = _pp_1f1b(
        stages, toks, labs, cfg, num_microbatches, virtual_stages, sizes,
        sp_axis, remat, num, denom, 1.0, out)
    loss = num * nll_sum / denom + aux
    return loss, [g[0] for g in grads] if one else grads


def pp_dp_loss_and_grads_fn(cfg: LlamaConfig, n_dp: int, n_ep: int = 1, *,
                            num_microbatches: int, n_sp: int = 1,
                            virtual_stages: int = 1,
                            remat: bool = False) -> Callable:
    """``pp_dp_loss_fn`` under the 1F1B schedules (interleaved when
    ``virtual_stages`` > 1), marked ``joint_ranks``: ``(stage_trees,
    batch, out=None) -> (loss, grads)``, ``grads[s][e n_dp + d]`` rank
    (d, e)'s f32 gradient tree of stage s (into ``out`` of that shape
    when given), the replicated leaves' already summed over the stages;
    the gradient of the summed losses of ``pp_dp_loss_fn``, the loss its
    common value."""
    n = n_dp * n_ep
    sp_axis = "sp" if n_sp > 1 else None
    order = _rank_order(n_dp, n_ep)
    inv = np.argsort(order).tolist()

    def loss_and_grads(stage_trees, batch, out=None):
        toks, labels = (_rank_batch(b, n, n_sp) for b in batch[:2])
        stages = [[st[r] for r in order] for st in stage_trees]
        outs = None if out is None else [[os[r] for r in order]
                                         for os in out]
        denom = _joint_denom(batch, sum((lab >= 0).sum() for lab in labels))
        nll_sum, aux, grads = _pp_1f1b(
            stages, toks, labels, cfg, num_microbatches, virtual_stages,
            [n_ep] * n_dp, sp_axis, remat, n_dp, denom, float(n_dp), outs)
        return nll_sum / denom + aux, [[g[inv[r]] for r in range(n)]
                                       for g in grads]

    loss_and_grads.joint_ranks = True
    return loss_and_grads


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
    return sum(t.numel() * t.element_size() for t in tree_leaves(params))
