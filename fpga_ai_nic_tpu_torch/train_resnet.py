"""ResNet data-parallel training driver of the port — the counterpart of the
JAX package's ``examples/train_resnet.py`` (BASELINE.json config 3,
"ResNet-50 DP with fused SGD").  Prints one JSON line with JAX's keys
(``loss_first``, ``loss_last``, ``samples_per_sec``, ``wall_s``,
``params``) and a few of its own.

Examples (on the card; ``--device=cpu`` runs the plain versions instead):
  python -m fpga_ai_nic_tpu_torch.train_resnet --model=resnet50 \\
      --image-size=224 --mesh.dp=8 --global_batch=256 --bfp=1 \\
      --collective.fused_optimizer=true --optimizer.kind=momentum \\
      --optimizer.learning_rate=0.1 --optimizer.weight_decay=1e-4 --iters=5
  python -m fpga_ai_nic_tpu_torch.train_resnet --model=tiny --device=cpu \\
      --mesh.dp=2 --global_batch=8 --iters=2

Flags: ``--model=tiny|resnet50`` (default tiny); ``--image-size=``
(default 32); ``--bfp=1`` puts the BFP wire on the ring the way the port
carries it, ``impl="ring"`` with ``BFPConfig(codec="pallas")`` and
``fused_kernel=True`` (one ring reduce-scatter and one all-gather launch
a step), before the dotted flags, which may refine it; ``--device=``
(default cuda; it raises when CUDA is absent); everything else goes to
``TrainConfig``, whose defaults are JAX's driver's (SGD lr 0.1, global
batch 5376, dp=1).

The trainer is ``DPTrainer`` with sync-BN over the dp virtual ranks
(``resnet.dp_loss_fn``: every rank's forward in one graph, each BN
layer's moments pooled).  The batch stream is JAX's, seed for seed:
``np.random.default_rng(cfg.seed)``, per batch images
``standard_normal((B, S, S, 3))`` in f32 cast to the model dtype (round
to nearest even) and labels ``integers(0, num_classes, B)`` in int32; it
reaches the ranks through ``data.ShardedLoader`` (pinned host memory,
two batches in flight).  The first step is a warm-up outside the timed
window; ``samples_per_sec`` is JAX's ``iters * global_batch / wall``.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Iterator, List, Sequence, Tuple

import numpy as np
import torch

from . import data
from .device import resolve_device
from .models import resnet
from .models.resnet import ResNetConfig
from .ops import fused_update
from .parallel.mesh import make_ranks
from .parallel.train import DPTrainer
from .utils.config import TrainConfig, coerce_value, from_flags

MODELS = {"resnet50": ResNetConfig.resnet50, "tiny": ResNetConfig.tiny}
BFP_FLAGS = ["--collective.impl=ring",
             "--collective.compression.codec=pallas",
             "--collective.fused_kernel=true"]


def parse(argv: Sequence[str]) -> Tuple[ResNetConfig, TrainConfig, int,
                                        str]:
    """``(ResNetConfig, TrainConfig, image size, device)`` from the
    flags."""
    model, size, bfp, device = "tiny", 32, False, "cuda"
    rest: List[str] = []
    for a in argv:
        key, _, val = a.partition("=")
        if key == "--model":
            model = val
        elif key == "--image-size":
            size = int(val)
        elif key == "--bfp":
            bfp = coerce_value(bool, val)
        elif key == "--device":
            device = val
        else:
            rest.append(a)
    if model not in MODELS:
        raise ValueError(f"--model must be one of {sorted(MODELS)}")
    cfg = from_flags(TrainConfig, (BFP_FLAGS if bfp else []) + rest)
    return MODELS[model](), cfg, size, device


def make_batch(rng: np.random.Generator, mcfg: ResNetConfig, batch: int,
               size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One batch of JAX's stream on the host: images [batch, size, size, 3]
    in the model dtype, labels [batch] int32."""
    x = rng.standard_normal((batch, size, size, 3)).astype(np.float32)
    y = rng.integers(0, mcfg.num_classes, batch).astype(np.int32)
    return torch.from_numpy(x).to(mcfg.torch_dtype), torch.from_numpy(y)


def batches(mcfg: ResNetConfig, cfg: TrainConfig, size: int, count: int
            ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """``count`` host batches of the stream seeded with ``cfg.seed``."""
    return data.synthetic_batches(
        lambda rng: make_batch(rng, mcfg, cfg.global_batch, size),
        seed=cfg.seed, num_batches=count)


def build(mcfg: ResNetConfig, cfg: TrainConfig, device: str):
    """The trainer over ``cfg.mesh.dp`` virtual ranks and its initial
    state, from weights drawn on the device with seed ``cfg.seed``."""
    ranks = make_ranks(cfg.mesh, device)
    tr = DPTrainer(resnet.dp_loss_fn(mcfg), ranks, cfg)
    gen = torch.Generator(device=ranks.device).manual_seed(cfg.seed)
    return tr, tr.init_state(resnet.init(gen, mcfg, ranks.device))


def main(argv: Sequence[str]) -> dict:
    mcfg, cfg, size, device = parse(argv)
    dev = resolve_device(device)
    tr, state = build(mcfg, cfg, device)
    loader = data.ShardedLoader(batches(mcfg, cfg, size, cfg.iters + 1),
                                tr.ranks, prefetch=2)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    losses = []
    t0 = 0.0
    for i, batch in enumerate(loader):
        state, loss = tr.step(state, batch)
        losses.append(loss)
        if i == 0:                       # warm-up: kernel builds, cuDNN
            losses[0] = float(losses[0])
            t0 = time.perf_counter()
    losses = [float(v) for v in losses]  # waits for the device
    wall = time.perf_counter() - t0
    codec = fused_update.resolve_codec(cfg.collective)
    out = {"loss_first": losses[0], "loss_last": losses[-1],
           "samples_per_sec": cfg.iters * cfg.global_batch / wall,
           "ms_per_step": 1e3 * wall / cfg.iters, "wall_s": wall,
           "params": resnet.num_params(mcfg), "image_size": size,
           "global_batch": cfg.global_batch, "dp": cfg.mesh.dp,
           "optimizer": cfg.optimizer.kind,
           "codec": codec.describe() if codec is not None else None,
           "device": (torch.cuda.get_device_name(dev)
                      if dev.type == "cuda" else "cpu")}
    if dev.type == "cuda":
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    return out


if __name__ == "__main__":
    print(json.dumps(main(sys.argv[1:])))
