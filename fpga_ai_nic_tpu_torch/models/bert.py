"""BERT-family bidirectional encoder with a masked-LM head — the port of the
JAX package's ``models/bert.py``.

Post-LN encoder, learned positions, GELU FFN (tanh form, through f32),
tied MLM decoder (logits through ``tok_emb^T``), padding masked through
``pad_id``.  The parameter tree keeps the JAX layout (``from_jax_params``
carries weights across): ``{"tok_emb" [V, D], "pos_emb" [P, D],
"emb_norm" {"g", "b"}, "layers": [{"wq", "wk", "wv", "wo" [D, D],
"attn_norm", "w1" [D, F], "w2" [F, D], "ffn_norm"}], "mlm_dense" [D, D],
"mlm_norm", "mlm_bias" [V]}``.

Attention follows ``attn_impl`` as the JAX model's does
(``ops.ring_attention.pallas_route``): on the flash route the padding mask
rides the kernels' key-bias channel (``ops.flash_attention``, 0 / -1e30 a
key); otherwise scores are f32, ``softmax(s + bias)``, and v is cast to
f32.

The dp weighting of ``loss_fn``: JAX's ``loss_fn(dp_axis="dp")`` divides
each rank's masked-token NLL sum by the global count and scales the
gradient by n_dp, so the trainers' uniform mean over ranks is the global
token-weighted update.  Here a batch may carry the global count as a
third leaf (``with_global_count``: an [n] tensor, sliced per rank like
the other leaves); ``loss_fn(..., dp_size=n)`` then returns
``n * local_sum / global_count``, whose value averaged over the ranks is
the global loss and whose gradient is JAX's on every rank.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device
from ..ops.flash_attention import flash_attention
from ..ops.ring_attention import pallas_route
from ..parallel.mesh import CountedBatch

Params = Dict[str, Any]
_NEG = -1e30


@dataclass(frozen=True)
class BertConfig:
    vocab: int = 30522
    dim: int = 768
    n_layers: int = 12
    n_heads: int = 12
    ffn_dim: int = 3072
    max_pos: int = 512
    pad_id: int = 0
    norm_eps: float = 1e-12
    dtype: str = "bfloat16"
    # attention backend: "auto" = the flash kernels on the card when the
    # shape tiles (the padding mask rides their key-bias channel), the
    # plain softmax elsewhere; "pallas" / "xla" pin one
    attn_impl: str = "auto"

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @staticmethod
    def bert_base() -> "BertConfig":
        return BertConfig()

    @staticmethod
    def tiny(vocab: int = 256, dim: int = 64, n_layers: int = 2,
             n_heads: int = 4, ffn_dim: int = 128, max_pos: int = 64,
             dtype: str = "float32") -> "BertConfig":
        return BertConfig(vocab=vocab, dim=dim, n_layers=n_layers,
                          n_heads=n_heads, ffn_dim=ffn_dim, max_pos=max_pos,
                          dtype=dtype)


def init(generator: torch.Generator, cfg: BertConfig,
         device: DeviceLike = "cuda") -> Params:
    """Random weights with the JAX package's fan-in scaling (normal times
    sqrt(1 / fan_in), drawn in f32 on ``generator``'s device, cast to
    ``cfg.dtype``), norms at one and zero, the MLM bias zero.  Torch's
    generator is not JAX's: carry JAX's weights with ``from_jax_params``."""
    dev = resolve_device(device)
    dt = cfg.torch_dtype
    D = cfg.dim

    def dense(fan_in: int, shape: Tuple[int, ...]) -> torch.Tensor:
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        return (w * math.sqrt(1.0 / fan_in)).to(dev, dt)

    def ln() -> Dict[str, torch.Tensor]:
        return {"g": torch.ones((D,), dtype=dt, device=dev),
                "b": torch.zeros((D,), dtype=dt, device=dev)}

    params: Params = {"tok_emb": dense(D, (cfg.vocab, D)),
                      "pos_emb": dense(D, (cfg.max_pos, D)),
                      "emb_norm": ln(), "layers": [],
                      "mlm_dense": dense(D, (D, D)), "mlm_norm": ln(),
                      "mlm_bias": torch.zeros((cfg.vocab,), dtype=dt,
                                              device=dev)}
    for _ in range(cfg.n_layers):
        params["layers"].append({
            "wq": dense(D, (D, D)), "wk": dense(D, (D, D)),
            "wv": dense(D, (D, D)), "wo": dense(D, (D, D)),
            "attn_norm": ln(),
            "w1": dense(D, (D, cfg.ffn_dim)),
            "w2": dense(cfg.ffn_dim, (cfg.ffn_dim, D)),
            "ffn_norm": ln(),
        })
    return params


def from_jax_params(tree: Any, device: DeviceLike = "cuda") -> Any:
    """The JAX package's parameter pytree with numpy arrays at its leaves
    (``jax.tree_util.tree_map(np.asarray, params)``) as this port's tree:
    same keys, layout and values (bfloat16 leaves keep their bits)."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: from_jax_params(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [from_jax_params(v, dev) for v in tree]
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":           # numpy's ml_dtypes bfloat16
        return torch.from_numpy(np.array(a).view(np.int16)).view(
            torch.bfloat16).to(dev)
    return torch.from_numpy(np.array(a)).to(dev)


def _layernorm(x: torch.Tensor, p: Dict[str, torch.Tensor],
               eps: float) -> torch.Tensor:
    """LayerNorm in f32, cast back to ``x.dtype`` before the affine (as the
    JAX code does)."""
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * p["g"] + p["b"]


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (tanh form) through f32, back in x's dtype."""
    return F.gelu(x.to(torch.float32), approximate="tanh").to(x.dtype)


def apply(params: Params, tokens: torch.Tensor, cfg: BertConfig,
          attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens [B, S] -> MLM logits [B, S, vocab] in the model dtype.
    ``attention_mask`` [B, S] (1 = attend) defaults to ``tokens !=
    pad_id``."""
    B, S = tokens.shape
    if S > cfg.max_pos:
        raise ValueError(f"sequence length {S} exceeds max_pos={cfg.max_pos}")
    H, Hd = cfg.n_heads, cfg.head_dim
    if attention_mask is None:
        attention_mask = tokens != cfg.pad_id
    key_bias = torch.where(attention_mask.to(torch.bool),
                           torch.zeros((), device=tokens.device),
                           torch.full((), _NEG, device=tokens.device))
    # the route asks of a q-shaped tensor's shape and device only
    use_flash = pallas_route(cfg.attn_impl, torch.zeros(
        (), device=tokens.device).expand(B, H, S, Hd))

    x = params["tok_emb"][tokens.long()] + params["pos_emb"][:S]
    x = _layernorm(x, params["emb_norm"], cfg.norm_eps)
    scale = Hd ** -0.5
    for lyr in params["layers"]:
        q = (x @ lyr["wq"]).reshape(B, S, H, Hd).transpose(1, 2)
        k = (x @ lyr["wk"]).reshape(B, S, H, Hd).transpose(1, 2)
        v = (x @ lyr["wv"]).reshape(B, S, H, Hd).transpose(1, 2)
        if use_flash:
            att = flash_attention(q, k, v, causal=False, sm_scale=scale,
                                  key_bias=key_bias)
        else:
            s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                             k.to(torch.float32)) * scale
            p = torch.softmax(s + key_bias[:, None, None, :], dim=-1)
            att = torch.einsum("bhqk,bhkd->bhqd", p, v.to(torch.float32))
        att = att.to(x.dtype).transpose(1, 2).reshape(B, S, -1)
        x = _layernorm(x + att @ lyr["wo"], lyr["attn_norm"], cfg.norm_eps)
        h = _gelu(x @ lyr["w1"])
        x = _layernorm(x + h @ lyr["w2"], lyr["ffn_norm"], cfg.norm_eps)

    h = _layernorm(_gelu(x @ params["mlm_dense"]), params["mlm_norm"],
                   cfg.norm_eps)
    return h @ params["tok_emb"].T + params["mlm_bias"]     # tied decoder


def with_global_count(batch: Tuple[torch.Tensor, ...], n: int,
                      accum_steps: int = 1, ep: int = 1
                      ) -> Tuple[torch.Tensor, ...]:
    """``(tokens, labels)`` of a global batch -> ``(tokens, labels,
    count)``, a ``CountedBatch``: ``count`` is an int64 [n] tensor, every entry the global
    number of targets (labels >= 0), so each of the n ranks' shards
    carries it.  With ``accum_steps`` = a > 1 it is ``[n a]``: rank i's
    a entries the counts of the a microbatches (``parallel.accum``:
    microbatch k is rows ``k m .. (k + 1) m - 1`` of every rank's shard),
    each over all n ranks, as JAX psums the count inside each
    microbatch.  ``ep``: each dp rank's rows split over its ep ranks
    first (JAX's ``P((dp, ep))``), so microbatch k takes the k-th part of
    every (dp, ep) rank's rows; the count stays one a dp rank and
    microbatch (``VirtualRanks.shard_count`` replicates it over ep)."""
    tokens, labels = batch
    if accum_steps == 1:
        count = (labels >= 0).sum().reshape(1).to(torch.int64)
        return CountedBatch((tokens, labels, count.expand(n).contiguous()))
    if labels.shape[0] % (n * ep * accum_steps):
        raise ValueError(f"a global batch of {labels.shape[0]} does not "
                         f"split into {n * ep} ranks x {accum_steps} "
                         "microbatches")
    counts = (labels >= 0).reshape(n * ep, accum_steps, -1).sum(
        dim=(0, 2)).to(torch.int64)
    return CountedBatch((tokens, labels, counts.repeat(n)))


def loss_fn(params: Params, batch, cfg: BertConfig, *,
            dp_size: Optional[int] = None,
            dp_axis: Optional[str] = None) -> torch.Tensor:
    """Masked-LM cross-entropy; ``batch = (tokens, labels)`` with labels
    -100 off the masked positions: the mean NLL over this batch's
    targets.  ``batch = (tokens, labels, count)`` (a rank's shard of
    ``with_global_count``) with ``dp_size`` = n: ``n * local_sum /
    count``, the JAX ``dp_axis`` weighting (see the module docstring).
    ``dp_axis`` names a JAX mesh axis, which the port has not: it raises."""
    if dp_axis is not None:
        raise NotImplementedError(
            "dp_axis is a JAX mesh axis; the port's ranks carry the global "
            "target count in the batch (with_global_count) and pass "
            "dp_size=n")
    tokens, labels = batch[0], batch[1]
    valid = labels >= 0
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    logits = apply(params, tokens, cfg)
    logz = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -logz.gather(-1, safe.long()[..., None])[..., 0]
    local_sum = torch.where(valid, nll, torch.zeros_like(nll)).sum()
    if len(batch) == 2:
        if dp_size is not None:
            raise ValueError("dp_size needs the global count in the batch "
                             "(with_global_count)")
        return local_sum / torch.clamp(valid.sum(), min=1)
    if dp_size is None:
        raise ValueError("a batch with the global count needs dp_size")
    denom = torch.clamp(batch[2].reshape(()), min=1).to(torch.float32)
    return dp_size * local_sum / denom


def num_params(cfg: BertConfig) -> int:
    D = cfg.dim
    per_layer = 4 * D * D + 2 * D * cfg.ffn_dim + 4 * D
    head = D * D + 2 * D + cfg.vocab
    return (cfg.vocab * D + cfg.max_pos * D + 2 * D
            + cfg.n_layers * per_layer + head)
