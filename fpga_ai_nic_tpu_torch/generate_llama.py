"""Text generation driver of the port — the counterpart of the JAX
package's ``examples/generate_llama.py``: byte-tokenize a prompt, decode
greedily (or sampled, at ``--temperature``) through the contiguous KV
cache, print the continuation as one JSON line.

Examples (on the card; ``--device=cpu`` runs on the CPU):
  python -m fpga_ai_nic_tpu_torch.generate_llama --prompt="the ring" \\
      --new=32
  python -m fpga_ai_nic_tpu_torch.generate_llama --device=cpu \\
      --temperature=0.8 --seed=3 --model.dim=128

Flags are ``--name=value``: ``--prompt``, ``--new``, ``--temperature``,
``--model.<field>=`` (``LlamaConfig.tiny()`` with vocab 384, as the JAX
driver), ``--seed`` (the random weights, and with ``--temperature`` the
sampling generator), ``--device`` (default cuda; it raises when CUDA is
absent), ``--ckpt=DIR``: the weights of the latest step of a dp-only
checkpoint (``train_llama --save=``: the flat masters ``w_own`` in
forward leaf order), with JAX's size check: a tp, pp or ep layout (its
rows flatten each rank's local shapes) or a layout sidecar is refused.
"""

from __future__ import annotations

import dataclasses
import json
import sys
from typing import Any, Dict, Optional, Sequence

import torch

from . import serve_llama, text
from .device import resolve_device
from .models import llama, llama_decode
from .ops import fused_update
from .utils.checkpoint import Checkpointer
from .utils.config import CollectiveConfig


def parse(argv: Sequence[str]) -> Dict[str, Any]:
    opts: Dict[str, Any] = {"prompt": "the quick brown fox", "new": 16,
                            "temperature": 0.0, "seed": 0, "device": "cuda",
                            "ckpt": ""}
    cfg = dataclasses.replace(llama.LlamaConfig.tiny(), vocab=384)
    for a in argv:
        key, eq, val = a.partition("=")
        name = key.removeprefix("--")
        if not key.startswith("--") or not eq:
            raise ValueError(f"expected --name=value, got {a!r}")
        if name.startswith("model."):
            cfg = serve_llama.overlay(cfg, name[len("model."):], val)
        elif name in opts:
            opts[name] = type(opts[name])(val)
        else:
            raise ValueError(f"unknown flag {key}")
    opts["cfg"] = cfg
    return opts


def restore_params(ckpt_dir: str, cfg: llama.LlamaConfig,
                   device: torch.device) -> llama.Params:
    """The params of the latest step under ``ckpt_dir`` (JAX's
    ``examples/generate_llama.py``): the audited restore (a step with a
    layout sidecar is refused there), then the flat masters unflattened
    in forward leaf order after JAX's size check, which refuses the
    sharded layouts."""
    c = Checkpointer(ckpt_dir)
    step = c.latest_step()
    if step is None:
        raise SystemExit(f"no checkpoint found in {ckpt_dir}")
    payload = c.restore(step)
    shapes = llama.init(torch.Generator().manual_seed(0), cfg, "cpu")
    meta = fused_update.flat_meta(shapes, CollectiveConfig(), 1)
    flat = torch.from_numpy(payload["w_own"])
    total = sum(meta.sizes)
    if not total <= flat.shape[0] <= meta.padded_len + (1 << 16):
        raise SystemExit(
            f"checkpoint w_own has {flat.shape[0]} elements; expected "
            f"~{total} — this looks like a tp/pp/ep-sharded layout, which "
            "this driver cannot restore")
    return fused_update.unflatten_tree(flat[:meta.padded_len].to(device),
                                       meta)


def main(argv: Sequence[str],
         params: Optional[llama.Params] = None) -> Dict[str, Any]:
    """Run the driver; ``params`` replaces the seeded random weights."""
    opts = parse(argv)
    cfg = opts["cfg"]
    tok = text.ByteTokenizer()
    if cfg.vocab < tok.vocab_size:
        raise ValueError(f"--model.vocab={cfg.vocab} < the tokenizer's "
                         f"{tok.vocab_size}")
    dev = resolve_device(opts["device"])
    if params is None and opts["ckpt"]:
        params = restore_params(opts["ckpt"], cfg, dev)
    if params is None:
        params = serve_llama.random_params(cfg, opts["seed"], dev)
    ids = torch.tensor([[tok.bos_id] + tok.encode(opts["prompt"])],
                       dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(opts["seed"])
    out = llama_decode.generate(params, ids, opts["new"], cfg,
                                temperature=opts["temperature"],
                                generator=gen)
    cont = out[0, ids.shape[1]:].tolist()
    return {"prompt": opts["prompt"], "continuation": tok.decode(cont),
            "tokens": int(out.shape[1]), "continuation_ids": cont,
            "device_name": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu")}


if __name__ == "__main__":
    print(json.dumps(main(sys.argv[1:])))
