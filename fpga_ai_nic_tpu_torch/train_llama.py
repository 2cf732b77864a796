"""Llama training driver of the port — the counterpart of the JAX package's
``examples/train_llama.py`` on its dp, tp, sp, ep and pp axes.  Prints
one JSON line: first and last loss, tokens/s,
wall time, parameter counts (all, and those a token's products touch),
mesh, and with pp the schedule's ``pipeline_cost``.

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
  python -m fpga_ai_nic_tpu_torch.train_llama --model=llama3_8b \\
      --model.n_layers=4 --model.attn_block=512 --seq=4096 \\
      --global_batch=8 --mesh.dp=2 --mesh.pp=2 --microbatches=4 \\
      --pp_schedule=1f1b-interleaved --virtual_stages=2 --iters=3 \\
      --collective.impl=ring --collective.compression.codec=pallas \\
      --collective.fused_kernel=true
  python -m fpga_ai_nic_tpu_torch.train_llama --model=llama3_8b \\
      --model.n_layers=2 --model.vocab=32000 --model.rope_theta=1000000 \\
      --model.moe_experts=8 --model.attn_block=512 --seq=8192 \\
      --global_batch=4 --mesh.pp=2 --mesh.ep=2 --mesh.sp=2 \\
      --microbatches=2 --pp_schedule=1f1b --optimizer.clip_norm=1.0 \\
      --iters=3 --collective.impl=ring \\
      --collective.compression.codec=pallas --collective.fused_kernel=true
  python -m fpga_ai_nic_tpu_torch.train_llama --model=llama3_8b \\
      --model.n_layers=4 --model.attn_block=512 --seq=4096 \\
      --global_batch=4 --mesh.dp=2 --mesh.tp=2 --iters=3 \\
      --collective.impl=ring --collective.compression.codec=pallas \\
      --collective.fused_kernel=true
  python -m fpga_ai_nic_tpu_torch.train_llama --model=llama3_8b \\
      --model.n_layers=4 --model.attn_block=512 --seq=4096 \\
      --global_batch=4 --mesh.tp=2 --mesh.pp=2 --microbatches=4 \\
      --pp_schedule=1f1b --iters=3 --collective.impl=ring \\
      --collective.compression.codec=pallas --collective.fused_kernel=true
  python -m fpga_ai_nic_tpu_torch.train_llama --model=tiny --device=cpu \\
      --model.attn_block=128 --seq=128 --global_batch=4 --mesh.dp=2 \\
      --iters=2
  torchrun --nproc_per_node=2 -m fpga_ai_nic_tpu_torch.train_llama \\
      --model=llama3_8b --model.n_layers=4 --model.attn_block=512 \\
      --seq=4096 --global_batch=2 --mesh.dp=2 --iters=3 \\
      --collective.impl=ring --collective.compression.codec=pallas \\
      --collective.fused_kernel=true
  python -m fpga_ai_nic_tpu_torch.train_llama --model=tiny --device=cpu \\
      --model.attn_block=16 --seq=64 --global_batch=4 --mesh.dp=2 \\
      --mesh.tp=2 --iters=2
  python -m fpga_ai_nic_tpu_torch.train_llama --model=llama3_8b \\
      --model.n_layers=4 --model.attn_block=512 --seq=4096 \\
      --global_batch=4 --mesh.dp=2 --accum_steps=2 --data=SURVEY.md \\
      --iters=3 --collective.impl=ring \\
      --collective.compression.codec=pallas --collective.fused_kernel=true

Flags: ``--model=llama3_8b|tiny`` (default tiny) picks the base
configuration and ``--model.<field>=`` overlays ``LlamaConfig`` fields;
``--seq=`` (default 64) is the sequence length; ``--device=`` (default
cuda; it raises when CUDA is absent); ``--remat=`` (default false, JAX's
flag) recomputes each decoder block in the backward; everything else
goes to ``TrainConfig`` (``--accum_steps=`` among it: each dp rank's
batch in that many microbatches, ``parallel.accum``).  Batches are seeded
uniform tokens, one per step, as the JAX driver's ``make_batch`` draws
them, or with ``--data=PATH`` (a text file, or a directory of ``*.txt``)
``text.lm_batches`` over ``text.ByteTokenizer`` ids, seeded with
``--seed`` and cycling the text (``epochs=None``), as JAX's driver reads
it.  Those labels mask document starts with -100, so each batch carries
the global valid count, one a microbatch
(``models.bert.with_global_count``), and the loss takes ``dp_size=n``:
JAX's ``dp_axis`` weighting.  With sp the count replicates over a dp
rank's sequence shards (``VirtualRanks.shard_count``), each shard's labels
summed against it; a MoE model's joint loss (``llama.dp_loss_fn``, the
pp forms too) divides its pooled CE by it.  The first step is
a warm-up outside the timed window.  The ranks of ``--mesh.dp`` and ``--mesh.sp``
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
once across the ep (pp) rows (it needs the unfused update, the default).
``--mesh.pp=P`` splits the stacked layers over P pipeline stages (JAX's
flags): ``--microbatches=M`` (default 1) microbatches of each dp rank's
batch, ``--pp_schedule=gpipe|1f1b|1f1b-interleaved`` (default gpipe;
``llama.loss_fn_pp``, or ``llama.loss_and_grads_pp_1f1b``), and
``--virtual_stages=v`` chunks a stage (the interleaved schedule only,
default 2; the layers live in ``pipeline.interleave_layers`` order for
the whole run, as JAX's driver keeps them).  As in JAX's driver the pp
losses always recompute each layer in the backward (remat).  pp takes
``--mesh.sp``, ``--mesh.ep`` and MoE layers too: the batch splits over
dp x ep and the sequence over sp as without pp, ``--microbatches`` cuts
each (dp, ep) rank's batch, the 1F1B schedules run the sp shards on the
gathered attention, and a MoE model trains through
``llama.pp_dp_loss_fn`` / ``pp_dp_loss_and_grads_fn`` (every rank in one
graph, the aux over the pooled statistics of each microbatch).
``--mesh.tp=T`` splits each dp rank's model over T tensor ranks as JAX's
driver does (``llama.param_specs(cfg, tp_axis="tp", tp_size=T)``: kv-head
replication where T exceeds the kv heads; the loss with ``tp_axis="tp"``,
one a dp rank): with dp, sp, ep and MoE layers, not with pp.
``--save=DIR`` checkpoints the final state at step ``--iters`` through
``utils.checkpoint.Checkpointer`` (JAX's stored layout; under the
interleaved schedule with the layout sidecar, so a restore that does not
declare the same layer order is refused).  The JSON carries ``process``
(``parallel.multihost.process_info()``); ``multihost.initialize()`` runs
first (a no-op for one process).  Under a launcher's group of W processes
at ``--mesh.dp=W`` (tp = sp = ep = pp = 1) each process is one dp rank of
the ``ShardedTrainer``, its rings across the processes
(``ops.ring_procs``), feeding its own rows of each batch; the other axes
and ``--save`` there raise ``NotImplementedError`` (ROADMAP A.11).
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import sys
import time
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import text
from .models import bert, llama
from .models.llama import LlamaConfig
from .parallel import multihost, pipeline
from .parallel.mesh import make_ranks
from .parallel.sharded import ShardedTrainer
from .parallel.train import TrainState
from .utils.checkpoint import Checkpointer
from .utils.config import TrainConfig, _declared_type, coerce_value, from_flags

MODELS = {"llama3_8b": LlamaConfig.llama3_8b, "tiny": LlamaConfig.tiny}
SCHEDULES = ("gpipe", "1f1b", "1f1b-interleaved")
PIPELINE_FLAGS = ("--microbatches", "--pp_schedule", "--virtual_stages")


@dataclasses.dataclass(frozen=True)
class Pipeline:
    """JAX's pipeline flags: microbatches a dp rank's batch, the schedule,
    and the chunks a stage (1 unless interleaved)."""

    microbatches: int = 1
    schedule: str = "gpipe"
    virtual_stages: int = 1


def pipeline_flags(argv: Sequence[str]) -> Pipeline:
    """``--microbatches``, ``--pp_schedule`` and ``--virtual_stages``, with
    JAX's errors (the last flag given wins)."""
    flags = dict(a.partition("=")[::2] for a in argv
                 if a.partition("=")[0] in PIPELINE_FLAGS)
    schedule = flags.get("--pp_schedule", "gpipe")
    if schedule not in SCHEDULES:
        raise ValueError(f"--pp_schedule must be gpipe|1f1b|"
                         f"1f1b-interleaved, got {schedule!r}")
    if "--virtual_stages" in flags and schedule != "1f1b-interleaved":
        raise ValueError("--virtual_stages only applies to "
                         "--pp_schedule=1f1b-interleaved")
    v = (int(flags.get("--virtual_stages", 2))
         if schedule == "1f1b-interleaved" else 1)
    return Pipeline(int(flags.get("--microbatches", 1)), schedule, v)


def parse(argv: Sequence[str]) -> Tuple[LlamaConfig, TrainConfig, int, str]:
    """``(LlamaConfig, TrainConfig, seq, device)`` from the flags
    (``--remat=`` is read by ``remat_flag``, the pipeline's by
    ``pipeline_flags``)."""
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
        elif key not in ("--remat", "--data", "--save") and \
                key not in PIPELINE_FLAGS:
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
    llama._shard_counts(mcfg, cfg.mesh.tp)      # JAX's tp errors, up front
    sp = cfg.mesh.sp
    if cfg.mesh.ep > 1 and mcfg.moe is None:
        raise ValueError(f"--mesh.ep={cfg.mesh.ep} needs MoE layers "
                         "(--model.moe_experts)")
    if sp > 1 and (seq % sp or (seq // sp) % 128):
        raise ValueError(f"--seq={seq} does not split into --mesh.sp={sp} "
                         "shards of a multiple of 128 tokens")
    if cfg.mesh.pp > 1:
        pipe = pipeline_flags(argv)
        M, chunks = pipe.microbatches, cfg.mesh.pp * pipe.virtual_stages
        local = cfg.global_batch // (cfg.mesh.dp * cfg.mesh.ep)
        if local % M:
            raise ValueError(f"a (dp, ep) rank's batch of {local} does not "
                             f"split into --microbatches={M}")
        if pipe.virtual_stages > 1 and mcfg.n_layers % chunks:
            raise ValueError(f"{mcfg.n_layers} layers do not split into "
                             f"pp x virtual_stages = {chunks} chunks")
    return mcfg, cfg, seq, device


def data_flag(argv: Sequence[str], name: str = "--data") -> Optional[str]:
    """JAX's ``--data=`` flag, or another path flag (``--save``): the last
    one given; None without."""
    path = None
    for a in argv:
        key, _, val = a.partition("=")
        if key == name:
            path = val
    return path


def text_batches(path: str, mcfg: LlamaConfig, cfg: TrainConfig, seq: int,
                 count: int) -> Iterator[Tuple[torch.Tensor, ...]]:
    """``count`` batches of ``text.lm_batches`` over ``path`` (byte ids,
    seeded with ``cfg.seed``, the text cycled), each with the global
    valid count of every microbatch (``bert.with_global_count``)."""
    tok = text.ByteTokenizer()
    if mcfg.vocab < tok.vocab_size:
        raise ValueError(f"--model.vocab={mcfg.vocab} < the tokenizer's "
                         f"vocab {tok.vocab_size}")
    stream = text.lm_batches(path, tok, batch_size=cfg.global_batch,
                             seq_len=seq, seed=cfg.seed, epochs=None)
    for toks, labels in itertools.islice(stream, count):
        yield bert.with_global_count(
            (torch.from_numpy(toks), torch.from_numpy(labels)),
            cfg.mesh.dp, cfg.accum_steps, cfg.mesh.ep)


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
          remat: bool = False, pipe: Pipeline = Pipeline(),
          dp_size: Optional[int] = None
          ) -> Tuple[ShardedTrainer, TrainState]:
    """The trainer over ``cfg.mesh.dp`` x ``cfg.mesh.tp`` x ``cfg.mesh.pp``
    x ``cfg.mesh.ep`` x ``cfg.mesh.sp`` virtual ranks and its initial
    state, from weights drawn on the device with seed ``cfg.seed``;
    ``remat`` goes to the loss (with pp the losses always recompute);
    ``pipe``: the pipeline flags; ``dp_size``: the dense loss's global
    count weighting (batches carrying the count)."""
    ranks = make_ranks(cfg.mesh, multihost.process_device(device))
    gen = torch.Generator(device=ranks.device).manual_seed(cfg.seed)
    if ranks.pp > 1:
        tr = _pp_trainer(mcfg, cfg, ranks, pipe, dp_size)
        params = llama.stack_params(llama.init(gen, mcfg, ranks.device))
        if pipe.schedule == "1f1b-interleaved":
            params["layers"] = pipeline.interleave_layers(
                params["layers"], ranks.pp, pipe.virtual_stages)
        return tr, tr.init_state(params)
    tp_axis = "tp" if ranks.tp > 1 else None
    specs = llama.param_specs(mcfg, tp_axis, tp_size=ranks.tp)
    if mcfg.moe is not None:
        tr = ShardedTrainer(llama.dp_loss_fn(mcfg, ranks.n, ranks.ep,
                                             n_sp=ranks.sp, tp_axis=tp_axis,
                                             remat=remat),
                            ranks, cfg, param_specs=specs)
    else:
        sp_axis = "sp" if cfg.mesh.sp > 1 else None
        tr = ShardedTrainer(
            lambda p, b: llama.loss_fn(p, b, mcfg, tp_axis=tp_axis,
                                       sp_axis=sp_axis, remat=remat,
                                       dp_size=dp_size), ranks,
            cfg, param_specs=specs if tp_axis else None)
    return tr, tr.init_state(llama.init(gen, mcfg, ranks.device))


def _pp_trainer(mcfg: LlamaConfig, cfg: TrainConfig, ranks,
                pipe: Pipeline, dp_size: Optional[int] = None
                ) -> ShardedTrainer:
    """The pp trainer of JAX's driver (``examples/train_llama.py:96-131``):
    GPipe through ``loss_fn_pp``, the 1F1B schedules through
    ``loss_and_grads_pp_1f1b``, remat on; a MoE model through
    ``pp_dp_loss_fn`` / ``pp_dp_loss_and_grads_fn``, every rank at once.
    Every label is valid here, so a dense model's per-rank weighting
    equals JAX's ``dp_axis`` one.  With tp each stage's trees are its tp
    ranks' (``stacked_param_specs(tp_axis="tp", tp_size=tp)``)."""
    tp_axis = "tp" if ranks.tp > 1 else None
    specs = llama.stacked_param_specs(
        mcfg, ep_axis="ep" if ranks.ep > 1 else None, tp_axis=tp_axis,
        tp_size=ranks.tp)
    M, v = pipe.microbatches, pipe.virtual_stages
    if mcfg.moe is not None:
        if pipe.schedule == "gpipe":
            return ShardedTrainer(
                llama.pp_dp_loss_fn(mcfg, ranks.n, ranks.ep, n_sp=ranks.sp,
                                    num_microbatches=M, remat=True),
                ranks, cfg, param_specs=specs)
        return ShardedTrainer(
            None, ranks, cfg, param_specs=specs,
            loss_and_grads_fn=llama.pp_dp_loss_and_grads_fn(
                mcfg, ranks.n, ranks.ep, n_sp=ranks.sp, num_microbatches=M,
                virtual_stages=v, remat=True))
    sp_axis = "sp" if ranks.sp > 1 else None
    if pipe.schedule == "gpipe":
        return ShardedTrainer(
            lambda p, b: llama.loss_fn_pp(p, b, mcfg, num_microbatches=M,
                                          dp_size=dp_size, tp_axis=tp_axis,
                                          sp_axis=sp_axis, remat=True),
            ranks, cfg, param_specs=specs)
    return ShardedTrainer(
        None, ranks, cfg, param_specs=specs,
        loss_and_grads_fn=lambda p, b, out=None: llama.loss_and_grads_pp_1f1b(
            p, b, mcfg, num_microbatches=M, dp_size=dp_size,
            virtual_stages=v, tp_axis=tp_axis, sp_axis=sp_axis, remat=True,
            out=out))


def main(argv: Sequence[str]) -> dict:
    multihost.initialize()
    mcfg, cfg, seq, device = parse(argv)
    dev = multihost.process_device(device)
    if data_flag(argv, "--save"):
        multihost.refuse_processes("--save (a checkpoint)")
    remat = remat_flag(argv)
    pipe = pipeline_flags(argv)
    path = data_flag(argv)
    tr, state = build(mcfg, cfg, device, remat, pipe,
                      None if path is None else cfg.mesh.dp)
    t_data = time.perf_counter()
    stream = (batches(mcfg, cfg, seq, cfg.iters + 1) if path is None
              else text_batches(path, mcfg, cfg, seq, cfg.iters + 1))
    losses = []
    masked, labels_seen = 0, 0
    t0 = 0.0
    first_batch_s = None
    for i, batch in enumerate(stream):
        if first_batch_s is None:
            first_batch_s = time.perf_counter() - t_data
        masked += int((batch[1] < 0).sum())
        labels_seen += batch[1].numel()
        state, loss = tr.step(state, multihost.local_batch_to_global(
            multihost.process_rows(batch), tr))
        losses.append(loss)
        if i == 0:                       # warm-up: kernel builds
            losses[0] = float(losses[0])
            t0 = time.perf_counter()
    losses = [float(v) for v in losses]  # waits for the device
    wall = time.perf_counter() - t0
    m = cfg.mesh
    out = {"loss_first": losses[0], "loss_last": losses[-1],
           "tokens_per_sec": cfg.iters * cfg.global_batch * seq / wall,
           "wall_s": wall, "params": llama.num_params(mcfg),
           "active_params": llama.active_params(mcfg),
           "losses": losses, "accum_steps": cfg.accum_steps,
           "mesh": {"dp": m.dp, "tp": m.tp, "sp": m.sp, "pp": m.pp,
                    "ep": m.ep}, "remat": remat or m.pp > 1,
           "process": multihost.process_info(),
           "device": (torch.cuda.get_device_name(dev)
                      if dev.type == "cuda" else "cpu")}
    if path is not None:
        out["data"] = {"path": path, "masked_share": masked / labels_seen,
                       "first_batch_s": first_batch_s}
    if m.pp > 1:
        out["pipeline_cost"] = pipeline.cost_model(
            pipe.microbatches, m.pp, schedule=pipe.schedule,
            virtual_stages=pipe.virtual_stages)
    save_dir = data_flag(argv, "--save")
    if save_dir:
        # the interleaved schedule's masters are in its layer order: the
        # sidecar makes a restore that declares another order refuse
        layout = None
        if pipe.schedule == "1f1b-interleaved":
            layout = {"layers_order": "interleaved-device-major",
                      "pp": m.pp, "virtual_stages": pipe.virtual_stages}
        out["checkpoint"] = Checkpointer(save_dir).save(
            cfg.iters, state, layout=layout)
        if layout:
            out["checkpoint_layout"] = layout
    tr.close()
    return out


if __name__ == "__main__":
    print(json.dumps(main(sys.argv[1:])))
