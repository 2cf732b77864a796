"""Llama training driver of the port — the counterpart of the JAX package's
``examples/train_llama.py`` on its dp, sp and ep axes (no pipeline or
tensor parallelism yet).  Prints one JSON line: first and last loss,
tokens/s, wall time, parameter counts (all, and those a token's products
touch) and mesh.

Examples (on the card; ``--device=cpu`` runs the plain versions instead):
  python -m fpga_ai_nic_tpu_torch.train_llama --model=llama3_8b \\
      --model.n_layers=4 --model.attn_block=512 --seq=4096 \\
      --global_batch=2 --mesh.dp=2 --iters=3 \\
      --collective.impl=ring --collective.compression.codec=pallas \\
      --collective.fused_kernel=true
  python -m fpga_ai_nic_tpu_torch.train_llama --model=llama3_8b \\
      --model.n_layers=4 --model.attn_block=512 --seq=8192 \\
      --global_batch=2 --mesh.dp=2 --mesh.sp=4 --iters=3 \\
      --collective.impl=ring --collective.compression.codec=pallas \\
      --collective.fused_kernel=true
  python -m fpga_ai_nic_tpu_torch.train_llama --model=llama3_8b \\
      --model.n_layers=1 --model.vocab=32000 --model.rope_theta=1000000 \\
      --model.moe_experts=8 --model.attn_block=512 --seq=4096 \\
      --global_batch=4 --mesh.dp=2 --mesh.ep=2 --iters=3 \\
      --collective.impl=ring --collective.compression.codec=pallas \\
      --collective.fused_kernel=true
  python -m fpga_ai_nic_tpu_torch.train_llama --model=llama3_8b \\
      --model.n_layers=1 --model.vocab=32000 --model.rope_theta=1000000 \\
      --model.moe_experts=8 --model.attn_block=512 --seq=8192 \\
      --global_batch=4 --mesh.dp=2 --mesh.sp=2 --mesh.ep=2 --remat=true \\
      --optimizer.clip_norm=1.0 --iters=3 --collective.impl=ring \\
      --collective.compression.codec=pallas --collective.fused_kernel=true
  python -m fpga_ai_nic_tpu_torch.train_llama --model=tiny --device=cpu \\
      --model.attn_block=128 --seq=128 --global_batch=4 --mesh.dp=2 \\
      --iters=2

Flags: ``--model=llama3_8b|tiny`` (default tiny) picks the base
configuration and ``--model.<field>=`` overlays ``LlamaConfig`` fields;
``--seq=`` (default 64) is the sequence length; ``--device=`` (default
cuda; it raises when CUDA is absent); ``--remat=`` (default false, JAX's
flag) recomputes each decoder block in the backward; everything else
goes to ``TrainConfig``.  Batches are seeded uniform tokens, one per step, as
the JAX driver's ``make_batch`` draws them; the first step is a warm-up
outside the timed window.  The ranks of ``--mesh.dp`` and ``--mesh.sp``
are virtual ranks on one card: with sp > 1 each dp rank's loss runs over
its sp sequence shards (``llama.loss_fn(..., sp_axis="sp")``, ring
attention across them; the labels are the globally shifted targets, so
the shift crosses shard boundaries), and the sequence must split into
shards of a multiple of 128 tokens.  ``--model.moe_experts=E`` (with
``--model.moe_top_k``, ``moe_capacity_factor``, ``moe_aux_weight``) makes
every FFN a routed expert layer, trained through ``llama.dp_loss_fn`` (one
loss over all ranks, the aux over the global routing statistics, as
JAX's driver's ``dp_axis="dp"`` gives); ``--mesh.ep`` shards the experts
over that many ranks of each dp rank, the batch over dp x ep; with
``--mesh.sp`` too, each (dp, ep) rank runs its sp ring over its sequence
shards and each (dp, ep, sp) device routes its own tokens.
``--optimizer.clip_norm`` clips the global norm, each parameter counted
once across the ep rows (it needs the unfused update, the default).
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
from .models import llama
from .models.llama import LlamaConfig
from .parallel.mesh import make_ranks
from .parallel.sharded import ShardedTrainer
from .parallel.train import TrainState
from .utils.config import TrainConfig, _declared_type, coerce_value, from_flags

MODELS = {"llama3_8b": LlamaConfig.llama3_8b, "tiny": LlamaConfig.tiny}


def parse(argv: Sequence[str]) -> Tuple[LlamaConfig, TrainConfig, int, str]:
    """``(LlamaConfig, TrainConfig, seq, device)`` from the flags
    (``--remat=`` is read by ``remat_flag``)."""
    model, seq, device = "tiny", 64, "cuda"
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
        elif key == "--device":
            device = val
        elif key != "--remat":           # remat_flag reads --remat
            rest.append(a)
    if model not in MODELS:
        raise ValueError(f"--model must be one of {sorted(MODELS)}")
    mcfg = MODELS[model]()
    for name, val in overlays:
        if name not in {f.name for f in dataclasses.fields(mcfg)}:
            raise ValueError(f"unknown LlamaConfig field {name!r}")
        mcfg = dataclasses.replace(mcfg, **{name: coerce_value(
            _declared_type(mcfg, name), val)})
    cfg = from_flags(TrainConfig, rest)
    sp = cfg.mesh.sp
    if cfg.mesh.ep > 1 and mcfg.moe is None:
        raise ValueError(f"--mesh.ep={cfg.mesh.ep} needs MoE layers "
                         "(--model.moe_experts)")
    if sp > 1 and (seq % sp or (seq // sp) % 128):
        raise ValueError(f"--seq={seq} does not split into --mesh.sp={sp} "
                         "shards of a multiple of 128 tokens")
    return mcfg, cfg, seq, device


def remat_flag(argv: Sequence[str]) -> bool:
    """JAX's ``--remat=`` flag (the last one given; false without)."""
    remat = False
    for a in argv:
        key, _, val = a.partition("=")
        if key == "--remat":
            remat = coerce_value(bool, val)
    return remat


def batches(mcfg: LlamaConfig, cfg: TrainConfig, seq: int,
            count: int) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """``count`` (tokens, labels) pairs, int32 [global_batch, seq]: uniform
    tokens from numpy's generator seeded with ``cfg.seed``, labels the
    tokens shifted by one."""
    rng = np.random.default_rng(cfg.seed)
    for _ in range(count):
        toks = rng.integers(0, mcfg.vocab, (cfg.global_batch, seq + 1)
                            ).astype(np.int32)
        yield torch.from_numpy(toks[:, :-1]), torch.from_numpy(toks[:, 1:])


def build(mcfg: LlamaConfig, cfg: TrainConfig, device: str,
          remat: bool = False) -> Tuple[ShardedTrainer, TrainState]:
    """The trainer over ``cfg.mesh.dp`` x ``cfg.mesh.ep`` x
    ``cfg.mesh.sp`` virtual ranks and its initial state, from weights
    drawn on the device with seed ``cfg.seed``; ``remat`` goes to the
    loss."""
    ranks = make_ranks(cfg.mesh, device)
    if mcfg.moe is not None:
        tr = ShardedTrainer(llama.dp_loss_fn(mcfg, ranks.n, ranks.ep,
                                             n_sp=ranks.sp, remat=remat),
                            ranks, cfg, param_specs=llama.param_specs(mcfg))
    else:
        sp_axis = "sp" if cfg.mesh.sp > 1 else None
        tr = ShardedTrainer(
            lambda p, b: llama.loss_fn(p, b, mcfg, sp_axis=sp_axis,
                                       remat=remat), ranks, cfg)
    gen = torch.Generator(device=ranks.device).manual_seed(cfg.seed)
    return tr, tr.init_state(llama.init(gen, mcfg, ranks.device))


def main(argv: Sequence[str]) -> dict:
    mcfg, cfg, seq, device = parse(argv)
    dev = resolve_device(device)
    remat = remat_flag(argv)
    tr, state = build(mcfg, cfg, device, remat)
    losses = []
    t0 = 0.0
    for i, batch in enumerate(batches(mcfg, cfg, seq, cfg.iters + 1)):
        state, loss = tr.step(state, tr.shard_batch(batch))
        losses.append(loss)
        if i == 0:                       # warm-up: kernel builds
            losses[0] = float(losses[0])
            t0 = time.perf_counter()
    losses = [float(v) for v in losses]  # waits for the device
    wall = time.perf_counter() - t0
    m = cfg.mesh
    return {"loss_first": losses[0], "loss_last": losses[-1],
            "tokens_per_sec": cfg.iters * cfg.global_batch * seq / wall,
            "wall_s": wall, "params": llama.num_params(mcfg),
            "active_params": llama.active_params(mcfg),
            "mesh": {"dp": m.dp, "tp": m.tp, "sp": m.sp, "pp": m.pp,
                     "ep": m.ep}, "remat": remat,
            "device": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu")}


if __name__ == "__main__":
    print(json.dumps(main(sys.argv[1:])))
