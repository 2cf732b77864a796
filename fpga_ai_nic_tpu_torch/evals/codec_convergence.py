"""Codec convergence evaluation — the port of the JAX package's
``evals/codec_convergence.py`` for the models the port can train.

Train the same model through the same explicit ring, compressed and
uncompressed, and compare final losses.  Every arm uses ``impl="ring"``
and one trainer, the ZeRO-1 ``DPTrainer`` (``trainer="dp"``, the default
here and the one the comparison uses) or the bucketed ``DDPTrainer``
(``"ddp"``, which carries no error-feedback residual); the ``*_fsdp``
models take the ZeRO-3 ``FSDPTrainer`` whatever ``trainer`` says, its
compressed gather quantizing the weight stream and its backward
reduce-scatter the gradient stream.  All arms are paired on common random
numbers (the same initial weights and batch stream per seed), so the
final-loss ratio isolates the wire codec; for
error-feedback codecs (top-k) the arm also carries the residual through
``TrainState.codec_state``.

Ported: ``run_curve``, ``run_comparison`` (the BFP mantissa sweep, on
``DDPTrainer`` as JAX's), ``run_comparison_multiseed``,
``run_codec_comparison``, ``codec_static_table`` and ``codec_error_table``
for the models ``mlp``, ``mlp_canonical``,
``bert`` (the tiny BERT on masked-LM batches of 32 tokens, each carrying
the global target count, ``models.bert.with_global_count``),
``resnet`` (the tiny ResNet on 16x16 images, sync-BN over the ranks
through ``models.resnet.dp_loss_fn``) and ``mlp_fsdp`` (the eval MLP
under ZeRO-3, ``parallel.fsdp``).  The batch stream is the reference's
numpy stream; the initial weights come from a torch generator unless
``params=`` hands them in (a test passes JAX's).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import compress
from ..device import DeviceLike, resolve_device
from ..models import bert, mlp, resnet
from ..ops import bfp, fused_update
from ..parallel.ddp import DDPTrainer
from ..parallel.fsdp import FSDPTrainer
from ..parallel.mesh import VirtualRanks
from ..parallel.train import DPTrainer
from ..utils.config import (BFPConfig, CollectiveConfig, MeshConfig,
                            MLPConfig, OptimizerConfig, TrainConfig)

MODELS = ("mlp", "mlp_canonical", "bert", "resnet", "mlp_fsdp")
TRAINERS = {"dp": DPTrainer, "ddp": DDPTrainer}
BERT_SEQ = 32               # the reference eval's masked-LM batches

# the codec arms of the default sweep: top-k exercises error feedback,
# int8 stochastic rounding
DEFAULT_CODECS: Tuple[Tuple[str, Tuple], ...] = (
    ("topk", (("bucket_elems", 256), ("k", 64))),
    ("int8", ()),
)


def _check_model(model: str) -> None:
    if model not in MODELS:
        raise ValueError(model)


def mlp_config(model: str) -> MLPConfig:
    """The eval's MLP: 128-256-256-32 ("mlp", "mlp_fsdp"), or the
    reference benchmark's 2048-wide layers with depth cut to 3
    ("mlp_canonical")."""
    _check_model(model)
    if model in ("bert", "resnet"):
        raise ValueError(f"{model} is not an MLP: see models.{model}")
    canonical = model == "mlp_canonical"
    width = 2048 if canonical else 128
    hidden = 2048 if canonical else 256
    n_cls = 128 if canonical else 32
    return MLPConfig(layer_sizes=(width, hidden, hidden, n_cls),
                     dtype="float32")


def _make_batches(model: str, n_batches: int, batch: int, seed: int
                  ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """The reference's fixed dataset from one numpy generator seeded with
    ``seed``: per batch, x ~ N(0, 1) then integer labels (the MLPs; for
    ``resnet`` x is [batch, 16, 16, 3] images), or uniform tokens and 15%
    of them (position 0 always) masked to token 3 and labelled, -100
    elsewhere (``bert``, ``BERT_SEQ`` tokens)."""
    rng = np.random.default_rng(seed)
    out = []
    if model == "resnet":
        n_cls = resnet.ResNetConfig.tiny().num_classes
        for _ in range(n_batches):
            x = rng.standard_normal((batch, 16, 16, 3)).astype(np.float32)
            y = rng.integers(0, n_cls, batch).astype(np.int32)
            out.append((torch.from_numpy(x), torch.from_numpy(y)))
        return out
    if model == "bert":
        vocab = bert.BertConfig.tiny().vocab
        for _ in range(n_batches):
            toks = rng.integers(1, vocab, (batch, BERT_SEQ)).astype(np.int32)
            labels = np.full((batch, BERT_SEQ), -100, np.int32)
            m = rng.random((batch, BERT_SEQ)) < 0.15
            m[:, 0] = True
            labels[m] = toks[m]
            toks[m] = 3
            out.append((torch.from_numpy(toks), torch.from_numpy(labels)))
        return out
    cfg = mlp_config(model)
    width, n_cls = cfg.layer_sizes[0], cfg.layer_sizes[-1]
    for _ in range(n_batches):
        x = rng.standard_normal((batch, width)).astype(np.float32)
        y = rng.integers(0, n_cls, batch).astype(np.int32)
        out.append((torch.from_numpy(x), torch.from_numpy(y)))
    return out


def run_curve(model: str, steps: int = 200, *, batch: int = 32,
              codec: Optional[str] = None, codec_opts: Tuple = (),
              mantissa_bits: Optional[int] = None, n_dev: int = 8,
              seed: int = 0, record_every: int = 5, n_batches: int = 4,
              tail_k: int = 1, trainer: str = "dp",
              params: Optional[dict] = None,
              device: DeviceLike = "cuda") -> Dict:
    """Train ``model`` for ``steps`` over ``n_dev`` virtual ranks through
    the explicit ring (AdamW, lr 3e-3) with ``trainer`` ("dp" or "ddp";
    ``FSDPTrainer`` over n_dev fsdp ranks for ``mlp_fsdp``).
    ``codec=None`` is the uncompressed baseline; ``mantissa_bits=m`` means
    BFP at that width.  Returns ``{"losses", "steps", "final_loss"}``,
    losses recorded every ``record_every`` steps; ``final_loss`` is the
    mean of the last ``tail_k`` recorded losses.  ``params`` (a parameter
    tree) replaces the seeded torch initialisation."""
    _check_model(model)
    if trainer not in TRAINERS:
        raise ValueError(f"trainer must be one of {sorted(TRAINERS)}, got "
                         f"{trainer!r}")
    if mantissa_bits is not None:
        assert codec is None, "pass codec= OR mantissa_bits=, not both"
        codec = "bfp"
        codec_opts = tuple(codec_opts) + (("mantissa_bits", mantissa_bits),)
    dev = resolve_device(device)
    fsdp = model.endswith("_fsdp")
    cfg = TrainConfig(
        iters=steps, global_batch=batch,
        mesh=MeshConfig(fsdp=n_dev) if fsdp else MeshConfig(dp=n_dev),
        collective=CollectiveConfig(impl="ring", codec=codec,
                                    codec_opts=tuple(codec_opts),
                                    bucket_elems=1 << 16),
        optimizer=OptimizerConfig(kind="adamw", learning_rate=3e-3))
    c = fused_update.resolve_codec(cfg.collective)
    if trainer == "ddp" and not fsdp and c is not None \
            and c.error_feedback:
        raise ValueError("error-feedback codecs need trainer='dp' "
                         "(DDPTrainer does not carry the residual)")
    gen = torch.Generator().manual_seed(seed)
    batches = _make_batches(model, n_batches, batch, seed)
    if model == "bert":
        bcfg = bert.BertConfig.tiny()
        loss_fn = lambda p, b: bert.loss_fn(p, b, bcfg,  # noqa: E731
                                            dp_size=n_dev)
        params = bert.init(gen, bcfg, dev) if params is None else params
        batches = [bert.with_global_count(b, n_dev) for b in batches]
    elif model == "resnet":
        rcfg = resnet.ResNetConfig.tiny()
        loss_fn = resnet.dp_loss_fn(rcfg)
        params = resnet.init(gen, rcfg, dev) if params is None else params
    else:
        mcfg = mlp_config(model)
        loss_fn = lambda p, b: mlp.loss_fn(p, b, mcfg)  # noqa: E731
        params = mlp.init(gen, mcfg, dev) if params is None else params
    cls = FSDPTrainer if fsdp else TRAINERS[trainer]
    tr = cls(loss_fn, VirtualRanks(n_dev, dev), cfg)
    state = tr.init_state(params)
    sharded = [tr.shard_batch(b) for b in batches]
    losses: List[float] = []
    rec_steps: List[int] = []
    for i in range(steps):
        state, loss = tr.step(state, sharded[i % len(sharded)])
        if (i + 1) % record_every == 0 or i == steps - 1:
            losses.append(float(loss))
            rec_steps.append(i + 1)
    final = float(np.mean(losses[-max(tail_k, 1):]))
    return {"losses": losses, "steps": rec_steps, "final_loss": final}


def run_comparison(model: str, steps: int = 200, *,
                   mantissa_sweep: Sequence[int] = (8, 6, 4),
                   batch: int = 32, n_dev: int = 8, seed: int = 0,
                   n_batches: int = 4, tail_k: int = 1,
                   params: Optional[dict] = None,
                   device: DeviceLike = "cuda") -> Dict:
    """Uncompressed baseline + one BFP arm per mantissa width on the
    bucketed ``DDPTrainer`` (JAX's ``run_curve`` default), paired on
    common random numbers: each arm's ``final_loss_ratio`` (arm /
    baseline) differs from the baseline by per-hop quantization alone."""
    kw = dict(batch=batch, n_dev=n_dev, seed=seed, n_batches=n_batches,
              tail_k=tail_k, trainer="ddp", params=params, device=device)
    out: Dict = {"model": model, "steps": steps, "tail_k": tail_k,
                 "baseline": run_curve(model, steps, **kw)}
    base = out["baseline"]["final_loss"]
    for m in mantissa_sweep:
        arm = run_curve(model, steps, mantissa_bits=m, **kw)
        arm["final_loss_ratio"] = arm["final_loss"] / base
        out[f"bfp_m{m}"] = arm
    return out


def run_comparison_multiseed(model: str, steps: int = 200, *,
                             seeds: Sequence[int] = (0, 1, 2, 3, 4),
                             mantissa_sweep: Sequence[int] = (8, 6, 4),
                             batch: int = 32, n_dev: int = 8,
                             n_batches: int = 4, tail_k: int = 8,
                             params_of: Optional[Callable[[int], dict]] = None,
                             device: DeviceLike = "cuda") -> Dict:
    """``run_comparison`` over several seeds (each seed's arms share its
    initial weights and batch stream), with the per-seed paired ratios
    and their mean, standard deviation, minimum and maximum per
    mantissa width.  ``params_of(seed)``: a seed's initial weights (the
    seeded torch initialisation without it)."""
    runs = [run_comparison(model, steps, mantissa_sweep=mantissa_sweep,
                           batch=batch, n_dev=n_dev, seed=s,
                           n_batches=n_batches, tail_k=tail_k,
                           params=None if params_of is None
                           else params_of(s), device=device)
            for s in seeds]
    out: Dict = {"model": model, "steps": steps, "seeds": list(seeds),
                 "tail_k": tail_k, "pairing": "common-random-numbers",
                 "per_seed": runs}
    for m in mantissa_sweep:
        ratios = [r[f"bfp_m{m}"]["final_loss_ratio"] for r in runs]
        out[f"bfp_m{m}"] = {
            "paired_ratios": ratios,
            "ratio_mean": float(np.mean(ratios)),
            "ratio_std": float(np.std(ratios)),
            "ratio_min": float(np.min(ratios)),
            "ratio_max": float(np.max(ratios)),
        }
    return out


def run_codec_comparison(model: str, steps: int = 200, *,
                         codecs: Sequence[Tuple[str, Tuple]] = DEFAULT_CODECS,
                         batch: int = 32, n_dev: int = 8, seed: int = 0,
                         n_batches: int = 4, tail_k: int = 4,
                         params: Optional[dict] = None,
                         device: DeviceLike = "cuda") -> Dict:
    """Uncompressed baseline + one arm per (codec, opts), paired on common
    random numbers.  Each arm carries its ``final_loss_ratio`` (arm /
    baseline) and the codec's ``describe()``."""
    kw = dict(batch=batch, n_dev=n_dev, seed=seed, n_batches=n_batches,
              tail_k=tail_k, params=params, device=device)
    out: Dict = {"model": model, "steps": steps, "tail_k": tail_k,
                 "pairing": "common-random-numbers",
                 "baseline": run_curve(model, steps, **kw)}
    base = out["baseline"]["final_loss"]
    for name, opts in codecs:
        arm = run_curve(model, steps, codec=name, codec_opts=tuple(opts),
                        **kw)
        arm["final_loss_ratio"] = arm["final_loss"] / base
        arm["codec"] = compress.get_codec(name, dict(opts)).describe()
        out[name] = arm
    return out


def codec_error_table(mantissa_sweep: Sequence[int] = (2, 3, 4, 6, 8),
                      n: int = 1 << 16, seed: int = 0) -> List[Dict]:
    """Roundtrip relative error of one BFP encode/decode pass on N(0, 1)
    data per mantissa width (on the CPU)."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    rows = []
    for m in mantissa_sweep:
        cfg = dataclasses.replace(BFPConfig(), mantissa_bits=m)
        err = (bfp.bfp_roundtrip(x, cfg) - x).numpy()
        rows.append({
            "mantissa_bits": m,
            "rel_l2_error": float(np.linalg.norm(err))
            / float(np.linalg.norm(x.numpy())),
            "max_abs_error": float(np.max(np.abs(err))),
            "wire_bytes_per_value": bfp.wire_bytes(n, cfg) / n,
        })
    return rows


def codec_static_table(codecs: Sequence[Tuple[str, Tuple]] = (
        ("bfp", ()),) + DEFAULT_CODECS,
        n: int = 1 << 16, seed: int = 0) -> List[Dict]:
    """One-pass roundtrip error and wire rate per codec on N(0, 1) data
    (on the CPU)."""
    rng = np.random.default_rng(seed)
    rows = []
    for name, opts in codecs:
        c = compress.get_codec(name, dict(opts))
        n_use = n - n % c.pad_elems
        x = torch.from_numpy(rng.standard_normal(n_use).astype(np.float32))
        err = (c.roundtrip(x) - x).numpy()
        rows.append(dict(
            c.describe(),
            rel_l2_error=float(np.linalg.norm(err)
                               / np.linalg.norm(x.numpy())),
            max_abs_error=float(np.max(np.abs(err))),
            wire_bytes_per_value=c.wire_bytes(n_use) / n_use,
        ))
    return rows
