"""Llama-3-family decoder: configuration, parameters, the layer math and
the training loss — the port of the JAX package's ``models/llama.py``
with its sequence-parallel axis (serving composes the shared pieces in
``models/llama_decode.py``; training differentiates ``loss_fn``).

The parameter tree keeps the JAX layout, so weights carry across unchanged
(``params_from_jax``): ``{"tok_emb": [V, D], "final_norm": [D],
"lm_head": [D, V], "layers": [{"attn_norm", "wq" [D, H*hd], "wk"/"wv"
[D, kv*hd], "wo" [H*hd, D], "mlp_norm", "w1"/"w3" [D, F], "w2" [F, D]}]}``
and a projection is ``h @ w``.  ``tp_axis``, ``ep_axis`` and ``dp_axis``
raise ``NotImplementedError``, as do MoE layers (``moe_experts > 0``) and
``remat=True``.  Attention follows ``attn_block`` / ``attn_impl``:
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
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device
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
    moe_experts: int = 0               # > 0 raises NotImplementedError

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

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


def _no_moe(cfg: LlamaConfig) -> None:
    if cfg.moe_experts > 0:
        raise NotImplementedError(
            "MoE layers (moe_experts > 0) are not ported yet")


def init(generator: torch.Generator, cfg: LlamaConfig,
         device: DeviceLike = "cuda") -> Params:
    """Random weights with the JAX package's fan-in scaling (normal times
    sqrt(1 / fan_in), drawn in f32, cast to ``cfg.dtype``), norms at one.
    Drawn on ``generator``'s device — give it the card's device for the
    full-size model — then placed on ``device``.  Torch's generator is not
    JAX's: the same seed gives other weights (carry JAX's across with
    ``params_from_jax``)."""
    _no_moe(cfg)
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
        params["layers"].append({
            "attn_norm": ones(),
            "wq": dense(D, (D, cfg.n_heads * Hd)),
            "wk": dense(D, (D, cfg.n_kv_heads * Hd)),
            "wv": dense(D, (D, cfg.n_kv_heads * Hd)),
            "wo": dense(cfg.n_heads * Hd, (cfg.n_heads * Hd, D)),
            "mlp_norm": ones(),
            "w1": dense(D, (D, cfg.ffn_dim)),
            "w3": dense(D, (D, cfg.ffn_dim)),
            "w2": dense(cfg.ffn_dim, (cfg.ffn_dim, D)),
        })
    return params


def params_from_jax(tree: Params, device: DeviceLike = "cuda") -> Params:
    """The JAX package's parameter pytree, with numpy arrays at its leaves
    (``jax.tree_util.tree_map(np.asarray, params)``), as this port's tree:
    same keys, layout and values (bfloat16 leaves keep their bits)."""
    dev = resolve_device(device)

    def leaf(a: Any) -> torch.Tensor:
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":       # numpy's ml_dtypes bfloat16
            bits = torch.from_numpy(np.array(a).view(np.int16))
            return bits.view(torch.bfloat16).to(dev)
        return torch.from_numpy(np.array(a)).to(dev)

    out: Params = {k: leaf(v) for k, v in tree.items() if k != "layers"}
    if any("moe" in lyr for lyr in tree["layers"]):
        raise NotImplementedError("MoE layers are not ported yet")
    out["layers"] = [{k: leaf(v) for k, v in lyr.items()}
                     for lyr in tree["layers"]]
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


def _block(lyr: Params, x: torch.Tensor, pos: torch.Tensor,
           cfg: LlamaConfig, n_heads: int, n_kv: int,
           sp_axis: Optional[str] = None) -> torch.Tensor:
    """One decoder layer: pre-norm attention + SwiGLU (dense; the JAX
    layer's MoE load-balance term is 0 without experts).  x: [B, S, D],
    or [n_sp, B, S, D] with ``sp_axis``."""
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
    x = x + att @ lyr["wo"]
    h = _rmsnorm(x, lyr["mlp_norm"], cfg.norm_eps)
    gate = F.silu((h @ lyr["w1"]).to(torch.float32)).to(x.dtype)
    ff = (gate * (h @ lyr["w3"])) @ lyr["w2"]
    return x + ff


def apply(params: Params, tokens: torch.Tensor, cfg: LlamaConfig, *,
          tp_axis: Optional[str] = None, sp_axis: Optional[str] = None,
          ep_axis: Optional[str] = None,
          remat: bool = False) -> torch.Tensor:
    """tokens [B, S] -> logits [B, S, vocab] in the model dtype; with
    ``sp_axis``, tokens [n_sp, B, S_local] -> [n_sp, B, S_local, vocab]."""
    if remat:
        raise NotImplementedError(
            "remat (per-block activation recomputation) is not ported yet: "
            "ROADMAP A.6")
    if ep_axis is not None:
        raise NotImplementedError(
            "expert parallelism (ep_axis) is not ported yet")
    _no_moe(cfg)
    if tokens.dim() != (2 if sp_axis is None else 3):
        raise ValueError(f"tokens must be [B, S] (or [n_sp, B, S_local] "
                         f"with sp_axis), got {tuple(tokens.shape)}")
    S = tokens.shape[-1]
    n_heads, n_kv = _shard_counts(cfg, tp_axis)
    pos = _positions(S, sp_axis, tokens.device, n_sp=tokens.shape[0])
    x = params["tok_emb"][tokens.long()]                    # [.., S, D]
    for lyr in params["layers"]:
        x = _block(lyr, x, pos, cfg, n_heads, n_kv, sp_axis)
    x = _rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return x @ params["lm_head"]


def _token_nll(logits: torch.Tensor,
               safe_labels: torch.Tensor) -> torch.Tensor:
    """Per-token NLL [B, S] from f32 log-softmax."""
    logz = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return -logz.gather(-1, safe_labels.long()[..., None])[..., 0]


def _weighted_loss(local_sum: torch.Tensor,
                   count: torch.Tensor) -> torch.Tensor:
    """Token-weighted mean: the sums and counts are over every token the
    call holds, all its sp shards with ``sp_axis`` (JAX's psum over the
    token-sharding axes), so the value is the global mean over them and
    its gradient sums the shards' contributions."""
    return local_sum / torch.clamp(count, min=1)


def loss_fn(params: Params, batch, cfg: LlamaConfig, *,
            tp_axis: Optional[str] = None, sp_axis: Optional[str] = None,
            dp_axis: Optional[str] = None, ep_axis: Optional[str] = None,
            remat: bool = False) -> torch.Tensor:
    """Next-token cross-entropy.  batch = (tokens, labels), both [B, S]
    (or [n_sp, B, S_local] with ``sp_axis``: the stacked shards, labels
    the globally shifted targets, so the shift crosses shard boundaries);
    -100 entries are ignored.  With ``sp_axis`` the value is the
    token-weighted mean over all the shards, as each JAX sp rank's.
    ``dp_axis`` raises: the trainer's uniform dp average equals the JAX
    dp_axis weighting when every label is valid, as in
    ``train_llama``."""
    if dp_axis is not None:
        raise NotImplementedError(
            "dp_axis (the masked-label dp weighting inside a sharded "
            "program) is not ported; ShardedTrainer averages per-rank "
            "gradients")
    tokens, labels = batch
    valid = labels >= 0
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    logits = apply(params, tokens, cfg, tp_axis=tp_axis, sp_axis=sp_axis,
                   ep_axis=ep_axis, remat=remat)
    nll = torch.where(valid, _token_nll(logits, safe),
                      torch.zeros((), dtype=torch.float32,
                                  device=logits.device))
    return _weighted_loss(nll.sum(), valid.sum())


def num_params(cfg: LlamaConfig) -> int:
    _no_moe(cfg)
    D, Hd = cfg.dim, cfg.head_dim
    ffn = 3 * D * cfg.ffn_dim
    per_layer = (2 * D + D * cfg.n_heads * Hd + 2 * D * cfg.n_kv_heads * Hd
                 + cfg.n_heads * Hd * D + ffn)
    return cfg.vocab * D * 2 + D + cfg.n_layers * per_layer


def param_bytes(params: Params) -> int:
    """Bytes the parameter tree holds."""
    total = sum(t.numel() * t.element_size()
                for k, t in params.items() if k != "layers")
    return total + sum(t.numel() * t.element_size()
                       for lyr in params["layers"] for t in lyr.values())
