"""The reference benchmark model — the port of the JAX package's
``models/mlp.py``: N fully-connected layers trained with softmax
cross-entropy (canonical: 10 layers of 2048x2048 f32).

The JAX weight layout is kept at every public function: ``w`` is
``[in, out]`` and a layer computes ``h @ w + b`` (not ``nn.Linear``'s
``[out, in]``), so a parameter tree carries across from the JAX package
unchanged (``from_jax_params``).  A parameter tree is
``{"w": [w0, ...], "b": [b0, ...]}``.  The GEMMs are plain
``torch.matmul``, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from ..utils.config import MLPConfig

Params = Dict[str, List[torch.Tensor]]


def init(generator: torch.Generator, cfg: MLPConfig,
         device: DeviceLike = "cuda") -> Params:
    """He-normal weights (std sqrt(2 / fan_in)), zero biases, drawn on the
    CPU from ``generator`` and moved to ``device``.  Torch's generator is
    not JAX's: the same seed gives other weights than ``mlp.init`` there
    (carry JAX's across with ``from_jax_params``)."""
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    sizes = cfg.layer_sizes
    ws, bs = [], []
    for i in range(cfg.n_layers):
        w = torch.randn((sizes[i], sizes[i + 1]), generator=generator,
                        dtype=torch.float32)
        ws.append((w * math.sqrt(2.0 / sizes[i])).to(dev, dtype))
        bs.append(torch.zeros((sizes[i + 1],), dtype=dtype, device=dev))
    return {"w": ws, "b": bs}


def from_jax_params(params_np: Dict[str, List[np.ndarray]],
                    device: DeviceLike = "cuda") -> Params:
    """The JAX package's ``{"w": [...], "b": [...]}`` tree, as numpy
    arrays, as this port's parameter tree: same layout, same values."""
    dev = resolve_device(device)
    return {k: [torch.tensor(np.asarray(a), device=dev) for a in v]
            for k, v in params_np.items()}


def apply(params: Params, x: torch.Tensor, cfg: MLPConfig) -> torch.Tensor:
    """Forward pass -> logits: ReLU between layers, none after the last."""
    h = x.to(getattr(torch, cfg.dtype))
    n = len(params["w"])
    for i, (w, b) in enumerate(zip(params["w"], params["b"])):
        h = h @ w
        if cfg.fuse_bias:
            h = h + b
        if i < n - 1:
            h = torch.relu(h)
    return h


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy; labels are int class ids [B]."""
    logz = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logz, -1, labels.long()[:, None])[:, 0]
    return nll.mean()


def loss_fn(params: Params, batch: Tuple[torch.Tensor, torch.Tensor],
            cfg: MLPConfig) -> torch.Tensor:
    x, y = batch
    return softmax_xent(apply(params, x, cfg), y)


def flops_per_sample(cfg: MLPConfig) -> float:
    """Reference FLOP accounting: 6*C_i*C_{i+1} per middle layer
    (fwd 2 + bwd 2 + upd 2), 4* for layer 0 (no input-grad GEMM)."""
    sizes = cfg.layer_sizes
    total = 4.0 * sizes[0] * sizes[1]
    for i in range(1, cfg.n_layers):
        total += 6.0 * sizes[i] * sizes[i + 1]
    return total


class MLP(nn.Module):
    """The MLP as an ``nn.Module`` over a parameter tree (``w`` as
    ``[in, out]``)."""

    def __init__(self, cfg: MLPConfig, params: Optional[Params] = None, *,
                 generator: Optional[torch.Generator] = None,
                 device: DeviceLike = "cuda"):
        super().__init__()
        self.cfg = cfg
        if params is None:
            if generator is None:
                raise ValueError("pass params or a torch.Generator")
            params = init(generator, cfg, device)
        self.w = nn.ParameterList(params["w"])
        self.b = nn.ParameterList(params["b"])

    def params(self) -> Params:
        return {"w": list(self.w), "b": list(self.b)}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply(self.params(), x, self.cfg)

    def loss(self, batch: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
        return loss_fn(self.params(), batch, self.cfg)
