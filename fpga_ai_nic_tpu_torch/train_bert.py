"""BERT masked-LM training driver of the port — the counterpart of the JAX
package's ``examples/train_bert.py`` (BASELINE.json's "BERT-base DP
(bucketed ring all-reduce)").  Prints one JSON line.

Examples (on the card; ``--device=cpu`` runs the plain versions instead):
  python -m fpga_ai_nic_tpu_torch.train_bert --model=base --seq=512 \\
      --bfp=1 --mesh.dp=8
  python -m fpga_ai_nic_tpu_torch.train_bert --model=base --seq=512 \\
      --bfp=1 --mesh.dp=8 --queue=explicit
  python -m fpga_ai_nic_tpu_torch.train_bert --model=tiny --device=cpu \\
      --bfp=1 --mesh.dp=2 --iters=2

Flags: ``--model=tiny|base`` (default tiny) picks ``BertConfig.tiny()`` or
``bert_base()`` and ``--model.<field>=`` overlays its fields; ``--seq=``
(default 64) is the sequence length; ``--pad-min=`` (default seq // 2):
each sequence's valid length is drawn uniformly from [pad-min, seq] and
the tail is ``pad_id``, so the mask rides the flash kernels' key-bias
channel on the card; ``--trainer=ddp|dp`` (default ddp) picks the
bucketed ``DDPTrainer`` or the ZeRO-1 ``DPTrainer``; ``--queue=fused``
(the default) or ``explicit``: the ``DDPTrainer``'s buckets issued one
collective a bucket through the host issue/wait queue
(``parallel.queued.QueuedDDPTrainer``, JAX's flag), whose counters the
JSON carries under ``collectives`` and ``max_outstanding``; ``--bfp=1`` puts the BFP wire on the ring the way the port
carries it, ``impl="ring"`` with ``BFPConfig(codec="pallas")`` and
``fused_kernel=True`` (the fused ring kernels: one reduce-scatter and one
all-gather launch a bucket), before the dotted flags, which may refine
it; ``--device=`` (default cuda; it raises when CUDA is absent);
everything else goes to ``TrainConfig``.  Unless flags say otherwise the
optimizer is BERT's pre-training AdamW (lr 1e-4, betas 0.9 / 0.999,
weight decay 0.01; Devlin et al. 2018, appendix A.2) and the global batch
8 sequences a rank.

Batches are the JAX driver's synthetic masked-LM stream from numpy's
generator seeded with ``cfg.seed``: uniform tokens, 15% of the valid
positions (position 0 always) masked to token 3 and labelled, -100
elsewhere; each batch carries the global target count
(``bert.with_global_count``) so every rank's loss is weighted as JAX's
``loss_fn(dp_axis="dp")``.  The first step is a warm-up outside the
timed window; ``tokens_per_sec`` is the JAX driver's quantity, ``iters *
global_batch * seq / wall`` (every position, padding included), and
``valid_tokens_per_sec`` counts the valid tokens alone.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time
from typing import Iterator, List, Sequence, Tuple

import numpy as np
import torch

from .device import resolve_device
from .models import bert
from .models.bert import BertConfig
from .ops import fused_update
from .parallel.ddp import DDPTrainer
from .parallel.mesh import make_ranks
from .parallel.queued import QueuedDDPTrainer
from .parallel.train import DPTrainer
from .utils.observability import CollectiveStats
from .utils.config import TrainConfig, _declared_type, coerce_value, from_flags

MODELS = {"base": BertConfig.bert_base, "tiny": BertConfig.tiny}
TRAINERS = {"ddp": DDPTrainer, "dp": DPTrainer}
BERT_ADAMW = ["--optimizer.kind=adamw", "--optimizer.learning_rate=1e-4",
              "--optimizer.b1=0.9", "--optimizer.b2=0.999",
              "--optimizer.weight_decay=0.01"]
BFP_FLAGS = ["--collective.impl=ring",
             "--collective.compression.codec=pallas",
             "--collective.fused_kernel=true"]
MASK_ID = 3


@dataclasses.dataclass(frozen=True)
class Run:
    """What the flags say besides the model and train configurations."""
    seq: int
    pad_min: int
    trainer: str
    device: str
    queue: str = "fused"


def parse(argv: Sequence[str]) -> Tuple[BertConfig, TrainConfig, Run]:
    """``(BertConfig, TrainConfig, Run)`` from the flags."""
    model, seq, pad_min, trainer, device = "tiny", 64, None, "ddp", "cuda"
    queue = "fused"
    bfp = False
    overlays: List[Tuple[str, str]] = []
    rest: List[str] = []
    for a in argv:
        key, _, val = a.partition("=")
        if key == "--model":
            model = val
        elif key.startswith("--model."):
            overlays.append((key[len("--model."):], val))
        elif key == "--seq":
            seq = int(val)
        elif key == "--pad-min":
            pad_min = int(val)
        elif key == "--trainer":
            trainer = val
        elif key == "--bfp":
            bfp = coerce_value(bool, val)
        elif key == "--queue":
            if val not in ("fused", "explicit"):
                raise ValueError(f"--queue must be fused or explicit, got "
                                 f"{val!r}")
            queue = val
        elif key == "--device":
            device = val
        else:
            rest.append(a)
    if model not in MODELS:
        raise ValueError(f"--model must be one of {sorted(MODELS)}")
    if trainer not in TRAINERS:
        raise ValueError(f"--trainer must be one of {sorted(TRAINERS)}")
    if queue == "explicit" and trainer != "ddp":
        raise ValueError("--queue=explicit issues the DDP trainer's buckets "
                         "(--trainer=ddp)")
    mcfg = MODELS[model]()
    for name, val in overlays:
        if name not in {f.name for f in dataclasses.fields(mcfg)}:
            raise ValueError(f"unknown BertConfig field {name!r}")
        mcfg = dataclasses.replace(mcfg, **{name: coerce_value(
            _declared_type(mcfg, name), val)})
    cfg = from_flags(TrainConfig,
                     BERT_ADAMW + (BFP_FLAGS if bfp else []) + rest)
    if not any(a.startswith("--global_batch=") for a in rest):
        cfg = dataclasses.replace(cfg, global_batch=8 * cfg.mesh.dp)
    pad_min = seq // 2 if pad_min is None else pad_min
    if not 1 <= pad_min <= seq:
        raise ValueError(f"--pad-min must lie in [1, seq], got {pad_min}")
    return mcfg, cfg, Run(seq, pad_min, trainer, device, queue)


def make_batch(rng: np.random.Generator, mcfg: BertConfig, batch: int,
               seq: int, pad_min: int) -> Tuple[np.ndarray, np.ndarray,
                                                int]:
    """One masked-LM batch ``(tokens, labels, valid tokens)``, int32
    [batch, seq]: the JAX driver's stream (uniform tokens, 15% of the
    positions masked, position 0 always) with a padded tail after a valid
    length drawn from [pad_min, seq]; padding is never a target."""
    toks = rng.integers(1, mcfg.vocab, (batch, seq)).astype(np.int32)
    m = rng.random((batch, seq)) < 0.15
    lens = rng.integers(pad_min, seq + 1, batch)
    pad = np.arange(seq)[None, :] >= lens[:, None]
    m[:, 0] = True
    m &= ~pad
    toks[pad] = mcfg.pad_id
    labels = np.full((batch, seq), -100, np.int32)
    labels[m] = toks[m]
    toks[m] = MASK_ID
    return toks, labels, int(lens.sum())


def batches(mcfg: BertConfig, cfg: TrainConfig, run: Run, count: int
            ) -> Iterator[Tuple[Tuple[torch.Tensor, ...], int]]:
    """``count`` pairs of a global batch ``(tokens, labels, global count)``
    (``bert.with_global_count`` over ``cfg.mesh.dp`` ranks) and its number
    of valid tokens."""
    rng = np.random.default_rng(cfg.seed)
    for _ in range(count):
        toks, labels, valid = make_batch(rng, mcfg, cfg.global_batch,
                                         run.seq, run.pad_min)
        yield bert.with_global_count(
            (torch.from_numpy(toks), torch.from_numpy(labels)),
            cfg.mesh.dp, cfg.accum_steps), valid


def build(mcfg: BertConfig, cfg: TrainConfig, run: Run):
    """The trainer over ``cfg.mesh.dp`` virtual ranks and its initial
    state, from weights drawn on the device with seed ``cfg.seed``."""
    ranks = make_ranks(cfg.mesh, run.device)
    n = cfg.mesh.dp
    cls = (QueuedDDPTrainer if run.queue == "explicit"
           else TRAINERS[run.trainer])
    tr = cls(lambda p, b: bert.loss_fn(p, b, mcfg, dp_size=n), ranks, cfg)
    gen = torch.Generator(device=ranks.device).manual_seed(cfg.seed)
    return tr, tr.init_state(bert.init(gen, mcfg, ranks.device))


def main(argv: Sequence[str]) -> dict:
    mcfg, cfg, run = parse(argv)
    dev = resolve_device(run.device)
    tr, state = build(mcfg, cfg, run)
    stream = [(tr.shard_batch(b), valid)
              for b, valid in batches(mcfg, cfg, run, cfg.iters + 1)]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    losses = []
    t0 = 0.0
    for i, (batch, _) in enumerate(stream):
        state, loss = tr.step(state, batch)
        losses.append(loss)
        if i == 0:                       # warm-up: kernel builds
            losses[0] = float(losses[0])
            if run.queue == "explicit":  # count the timed steps alone
                tr.profiler.collectives = CollectiveStats()
            t0 = time.perf_counter()
    losses = [float(v) for v in losses]  # waits for the device
    wall = time.perf_counter() - t0
    valid = sum(v for _, v in stream[1:])
    codec = fused_update.resolve_codec(cfg.collective)
    out = {"loss_first": losses[0], "loss_last": losses[-1],
           "tokens_per_sec": cfg.iters * cfg.global_batch * run.seq / wall,
           "valid_tokens_per_sec": valid / wall,
           "ms_per_step": 1e3 * wall / cfg.iters, "wall_s": wall,
           "params": bert.num_params(mcfg), "trainer": run.trainer,
           "seq": run.seq, "pad_min": run.pad_min,
           "global_batch": cfg.global_batch, "dp": cfg.mesh.dp,
           "codec": codec.describe() if codec is not None else None,
           "device": (torch.cuda.get_device_name(dev)
                      if dev.type == "cuda" else "cpu")}
    if run.trainer == "ddp":
        out["n_buckets"] = len(tr.plan.buckets)
    out["queue"] = run.queue
    if run.queue == "explicit":
        out["collectives"] = tr.profiler.collectives.as_dict()
        out["max_outstanding"] = tr.queue.max_outstanding
    if dev.type == "cuda":
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    return out


if __name__ == "__main__":
    print(json.dumps(main(sys.argv[1:])))
