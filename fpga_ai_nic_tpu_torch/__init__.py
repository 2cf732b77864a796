"""PyTorch/CUDA port of the JAX package beside it, for one NVIDIA H100
(sm_90a).

The JAX package beside this one is the reference; this package mirrors its
module names so each counterpart is easy to find:

  utils/config.py       the same frozen config dataclasses and flags
  ops/bfp.py            "flat16" BFP codec (plain torch)
  ops/bfp_cuda.py       "sublane" BFP codec: CUDA kernels + plain versions
  ops/ring.py           plain torch rings over virtual ranks ([n, L] stacks)
  ops/ring_cuda.py      fused ring reduce-scatter(+SGD) / all-gather kernels
  ops/fused_update.py   flat ZeRO-1 plumbing and route choice
  compress/             the Codec protocol, BFP registered
  optim.py              the fused optimizer formula and its numpy twin
  models/mlp.py         the canonical MLP (JAX weight layout [in, out])
  parallel/mesh.py      VirtualRanks: n ranks on one card, in loopback
  parallel/train.py     DPTrainer: per-rank grads, fused RS+update, AG
  parallel/accum.py     gradient accumulation over microbatches
  parallel/queued.py    QueuedDDPTrainer on runtime/queue.py (streams)
  data.py text.py       loaders, epochs (native staging), text batches
  train_mlp.py          the training driver (``python -m ...train_mlp``)
  models/llama.py       Llama config, init, norms, rope (serving subset)
  models/llama_decode.py  forward / forward_paged / generate
  ops/paged_attend.py   paged gather-attend: CUDA kernel + plain version
  ops/integrity.py      exact checksums: KV pages, wire payloads, verdicts
  serve/                paged pool, scheduling rules, batcher, ServeEngine
  runtime/chaos.py      the collective integrity guard and fault plans
  runtime/ obs/         request intake, the queue, staging, telemetry
  utils/observability.py  Profiler, collective and recovery stats
  serve_llama.py        the serving driver (``python -m ...serve_llama``)

Nothing here imports JAX or the JAX package.  Kernel sources live in
``csrc/`` and are built by ``nvcc`` at first use (``ops/_build.py``); the
host staging engine ``csrc/staging.cpp`` by g++ (``runtime/native.py``).
"""
