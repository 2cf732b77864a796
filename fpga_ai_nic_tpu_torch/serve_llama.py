"""Serving driver of the port — the counterpart of the JAX package's
``tools/serve_bench.py`` for one configuration: random weights from a
seed, a seeded batch of prompts submitted at once, served to completion by
``ServeEngine``; prints ``summary()`` as one JSON line.

Examples (on the card; ``--device=cpu`` runs the plain versions instead):
  python -m fpga_ai_nic_tpu_torch.serve_llama --model=llama3_8b \\
      --requests=24 --prompt_min=128 --prompt_max=1024 --max_new=32 \\
      --max_reqs=16 --page_size=16 --max_pages_per_seq=128 \\
      --n_pages=2049 --prefill_chunk=256
  python -m fpga_ai_nic_tpu_torch.serve_llama --model=llama3_8b \\
      --model.n_layers=8 --model.vocab=32000 --model.rope_theta=1000000 \\
      --model.moe_experts=8 --requests=24
  python -m fpga_ai_nic_tpu_torch.serve_llama --model=tiny --device=cpu \\
      --requests=6 --prompt_min=4 --prompt_max=16 --max_new=4 \\
      --max_reqs=4 --page_size=4 --max_pages_per_seq=8 --n_pages=40 \\
      --prefill_chunk=8

Flags are ``--name=value``: ``--model`` (``llama3_8b`` or ``tiny``),
``--model.<field>=`` overlays ``LlamaConfig`` fields (e.g.
``--model.moe_experts=8`` for Mixtral's routed experts), ``--seed``,
``--device`` (default cuda; it raises when CUDA is absent),
``--attend_impl`` (``kernel`` or ``reference``), the request shape
(``--requests``, ``--prompt_min``, ``--prompt_max``, ``--max_new``) and
the ``ServeConfig`` fields.
"""

from __future__ import annotations

import dataclasses
import json
import sys
from dataclasses import fields
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from .device import resolve_device
from .models import llama
from .models.llama import LlamaConfig
from .serve import ServeConfig, ServeEngine
from .utils.config import _declared_type, coerce_value

MODELS = {"llama3_8b": LlamaConfig.llama3_8b, "tiny": LlamaConfig.tiny}
DEFAULTS: Dict[str, Any] = {
    "model": "llama3_8b", "seed": 0, "device": "cuda",
    "attend_impl": "kernel", "requests": 24, "prompt_min": 128,
    "prompt_max": 1024, "max_new": 32}
SERVE_DEFAULTS: Dict[str, Any] = {
    "max_reqs": 16, "page_size": 16, "max_pages_per_seq": 128,
    "n_pages": 2049, "prefill_chunk": 256}


def parse(argv: Sequence[str]
          ) -> Tuple[Dict[str, Any], ServeConfig, LlamaConfig]:
    """(options, ServeConfig, LlamaConfig) from ``--name=value`` flags."""
    opts = dict(DEFAULTS)
    overlays: List[Tuple[str, str]] = []
    serve_kw = dict(SERVE_DEFAULTS)
    serve_fields = {f.name: f.type for f in fields(ServeConfig)}
    for a in argv:
        key, eq, val = a.partition("=")
        name = key.removeprefix("--")
        if not key.startswith("--") or not eq:
            raise ValueError(f"expected --name=value, got {a!r}")
        if name.startswith("model."):
            overlays.append((name[len("model."):], val))
        elif name in opts:
            opts[name] = type(DEFAULTS[name])(val)
        elif name == "page_integrity":
            serve_kw[name] = val.lower() in ("1", "true", "yes", "on")
        elif name in serve_fields:
            serve_kw[name] = int(val)
        else:
            raise ValueError(f"unknown flag {key}")
    if opts["model"] not in MODELS:
        raise ValueError(f"--model must be one of {sorted(MODELS)}")
    cfg = MODELS[opts["model"]]()
    for name, val in overlays:
        if name not in {f.name for f in dataclasses.fields(cfg)}:
            raise ValueError(f"unknown LlamaConfig field {name!r}")
        cfg = dataclasses.replace(cfg, **{name: coerce_value(
            _declared_type(cfg, name), val)})
    return opts, ServeConfig(**serve_kw), cfg


def make_prompts(seed: int, n: int, lo: int, hi: int,
                 vocab: int) -> List[np.ndarray]:
    """``n`` int32 prompts, lengths uniform in [lo, hi], token ids uniform
    over the vocabulary, from numpy's generator seeded with ``seed``."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(m)).astype(np.int32)
            for m in rng.integers(lo, hi + 1, n)]


def random_params(cfg: LlamaConfig, seed: int,
                  device: torch.device) -> llama.Params:
    """``llama.init`` drawn on ``device`` from a generator seeded with
    ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return llama.init(gen, cfg, device)


def main(argv: Sequence[str]) -> Dict[str, Any]:
    opts, scfg, cfg = parse(argv)
    dev = resolve_device(opts["device"])
    params = random_params(cfg, opts["seed"], dev)
    eng = ServeEngine(params, cfg, scfg, device=dev,
                      attend_impl=opts["attend_impl"])
    for p in make_prompts(opts["seed"] + 1, opts["requests"],
                          opts["prompt_min"], opts["prompt_max"], cfg.vocab):
        eng.submit(p, opts["max_new"])
    out = eng.run()
    out["model"] = opts["model"]
    out["device_name"] = (torch.cuda.get_device_name(dev)
                          if dev.type == "cuda" else "cpu")
    return out


if __name__ == "__main__":
    print(json.dumps(main(sys.argv[1:])))
