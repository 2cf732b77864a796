"""Fused optimizers on flat parameter shards — the port of the JAX
package's ``optim.py``.

The fused update runs on each rank's owned ZeRO-1 shard between the ring
reduce-scatter and the all-gather, with the hyperparameters in an
f32[HYPER_LEN] vector (the CUDA ring kernel reads it from device memory,
so an lr change never rebuilds anything).

Bit contract: ``golden_fused_apply`` (a numpy copy of the reference's
twin) is the spec.  Its ``fmaf`` sites are where XLA:CPU contracts the
JAX formula into fused multiply-adds; the CUDA kernel writes them as
``__fmaf_rn``.  Torch on the CPU does not contract, so ``fused_apply_blocks``
here evaluates each of those sites in float64 and rounds once, which
equals ``fmaf`` bit for bit (``_fmaf``); the square root goes the same way
(``_sqrtf``).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .device import DeviceLike
from .utils.config import OptimizerConfig, OptimizerSpec

OptState = Dict[str, torch.Tensor]

H_LR, H_WD, H_MOM, H_B2, H_EPS, H_RC1, H_RC2 = 0, 1, 2, 3, 4, 5, 6
HYPER_LEN = 8


def _f32(v: float) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def learning_rate_at(cfg: OptimizerConfig, step: Optional[int]
                     ) -> torch.Tensor:
    """Scheduled lr (f32 scalar) at ``step``: linear warmup, then constant /
    cosine / linear decay to ``min_lr_ratio * learning_rate``."""
    base = _f32(cfg.learning_rate)
    if cfg.schedule == "constant" and cfg.warmup_steps == 0:
        return base
    t = _f32(float(step))
    one = _f32(1.0)
    warm = (torch.minimum(one, (t + 1.0) / cfg.warmup_steps)
            if cfg.warmup_steps > 0 else one)
    if cfg.schedule == "constant":
        return base * warm
    horizon = max(cfg.decay_steps - cfg.warmup_steps, 1)
    frac = torch.clamp((t - cfg.warmup_steps) / horizon, 0.0, 1.0)
    decay = (0.5 * (1.0 + torch.cos(math.pi * frac))
             if cfg.schedule == "cosine" else 1.0 - frac)
    floor = _f32(cfg.min_lr_ratio)
    return base * warm * (floor + (1.0 - floor) * decay)


def fused_hyperparams(cfg: OptimizerConfig, step: Optional[int] = None,
                      device: DeviceLike = "cpu") -> torch.Tensor:
    """The f32[HYPER_LEN] vector for one fused update at ``step``."""
    if step is None:
        assert cfg.schedule == "constant" and cfg.warmup_steps == 0, (
            "lr schedules need the step count")
        lr = _f32(cfg.learning_rate)
    else:
        lr = learning_rate_at(cfg, step)
    one = _f32(1.0)
    if cfg.kind == "adamw":
        assert step is not None, "adamw needs the step count"
        t = _f32(float(step + 1))
        rc1 = one / (one - _f32(cfg.b1) ** t)
        rc2 = one / (one - _f32(cfg.b2) ** t)
    else:
        rc1 = rc2 = one
    mom = _f32(cfg.momentum if cfg.kind == "momentum" else cfg.b1)
    h = torch.stack([lr.to(torch.float32), _f32(cfg.weight_decay), mom,
                     _f32(cfg.b2), _f32(cfg.eps), rc1, rc2, _f32(0.0)])
    return h.to(device)


def _fmaf(a, b, c) -> torch.Tensor:
    """Float32 fused multiply-add through float64: the f32 x f32 product
    is exact in f64 and 53 >= 2*24 + 2 makes the double rounding harmless,
    so this equals fmaf(a, b, c) bit for bit."""
    def f64(v):
        return v.to(torch.float64) if isinstance(v, torch.Tensor) else v
    return (f64(a) * f64(b) + f64(c)).to(torch.float32)


def _sqrtf(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root (torch's CPU kernel is not):
    the float64 root rounds to the same float32, as for ``_fmaf``."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def fused_apply_blocks(kind: str, w: torch.Tensor, g: torch.Tensor,
                       state: Tuple[torch.Tensor, ...],
                       h: Callable[[int], torch.Tensor]):
    """THE fused-update formula (``optim.fused_apply_blocks`` of the JAX
    package), with every contraction site an explicit ``_fmaf``.
    ``h(i)`` reads hyper scalar i.  Returns ``(w_new, new_state)``."""
    lr, wd = h(H_LR), h(H_WD)
    if kind == "sgd":
        return _fmaf(-lr, _fmaf(wd, w, g), w), ()
    if kind == "momentum":
        (m,) = state
        m2 = _fmaf(h(H_MOM), m, g)
        t1 = _fmaf(-lr, m2, w)
        return _fmaf(-(lr * wd), w, t1), (m2,)
    if kind == "adamw":
        m, v = state
        one = torch.ones((), dtype=torch.float32, device=w.device)
        m2 = _fmaf(one - h(H_MOM), g - m, m)
        v2 = _fmaf(one - h(H_B2), _fmaf(g, g, -v), v)
        num = h(H_RC1) * m2
        den = _sqrtf(h(H_RC2) * v2) + h(H_EPS)
        upd = _fmaf(wd, w, num / den)
        return _fmaf(-lr, upd, w), (m2, v2)
    raise ValueError(kind)


def fused_apply_flat(spec: OptimizerSpec, w: torch.Tensor,
                     g_sum: torch.Tensor, state: OptState,
                     hyper: torch.Tensor, n: int
                     ) -> Tuple[torch.Tensor, OptState]:
    """The fused update on flat owned shards outside the ring kernel.
    ``g_sum`` is the reduce-scattered gradient SUM; the /n mean happens
    here, as in the kernel."""
    w = w.to(torch.float32)
    g = g_sum.to(torch.float32) / torch.tensor(n, dtype=torch.float32,
                                               device=g_sum.device)
    st = tuple(state[k] for k in spec.state_keys)
    hyper = hyper.to(w.device)
    w2, st2 = fused_apply_blocks(spec.kind, w, g, st, lambda i: hyper[i])
    return w2, dict(zip(spec.state_keys, st2))


# ---------------------------------------------------------------------------
# numpy golden twin (copy of the JAX package's bit spec)
# ---------------------------------------------------------------------------

def _np_fmaf(a, b, c):
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def golden_fused_apply(kind: str, w, g_sum, state: Dict, hyper,
                       n: int) -> Tuple:
    """Numpy golden twin of the fused update composed with the /n mean.
    Returns ``(w_new, new_state_dict)`` in float32."""
    w = np.asarray(w, np.float32)
    g = np.asarray(g_sum, np.float32) / np.float32(n)
    h = np.asarray(hyper, np.float32)
    lr, wd = h[H_LR], h[H_WD]
    one = np.float32(1.0)
    if kind == "sgd":
        return _np_fmaf(-lr, _np_fmaf(wd, w, g), w), {}
    if kind == "momentum":
        m = np.asarray(state["m"], np.float32)
        m2 = _np_fmaf(h[H_MOM], m, g)
        t1 = _np_fmaf(-lr, m2, w)
        return _np_fmaf(-(lr * wd), w, t1), {"m": m2}
    if kind == "adamw":
        m = np.asarray(state["m"], np.float32)
        v = np.asarray(state["v"], np.float32)
        m2 = _np_fmaf(one - h[H_MOM], g - m, m)
        v2 = _np_fmaf(one - h[H_B2], _np_fmaf(g, g, -v), v)
        num = h[H_RC1] * m2
        den = (np.sqrt(h[H_RC2] * v2) + h[H_EPS]).astype(np.float32)
        upd = _np_fmaf(wd, w, num / den)
        return _np_fmaf(-lr, upd, w), {"m": m2, "v": v2}
    raise ValueError(kind)


def init_state(cfg: OptimizerConfig, shape: Sequence[int],
               device: DeviceLike = "cpu") -> OptState:
    """Zeroed optimizer state shards of ``shape`` (``[n, C]`` for the
    n virtual ranks' owned shards)."""
    return {k: torch.zeros(tuple(shape), dtype=torch.float32, device=device)
            for k in OptimizerSpec(kind=cfg.kind).state_keys}


def global_norm(g: torch.Tensor, weights: Any = None) -> torch.Tensor:
    """The L2 norm of ``g`` (f32) with per-element norm weights: None,
    a tensor broadcastable to ``g``, or the segment tables ``(bounds [m +
    1], values [m])`` of one flat row (``parallel.sharded``'s
    ``norm_weight_tables``), ``g`` then holding whole rows of length
    ``bounds[-1]`` end to end (a ``[rows, C]`` stack of owned shards whose
    every ``bounds[-1] / C`` consecutive rows make one flat row).  The
    tables are read a segment at a time: no weight vector is built."""
    if weights is None:
        return torch.sqrt(torch.sum(torch.square(g.to(torch.float32))))
    if isinstance(weights, torch.Tensor):
        sq = torch.square(g.to(torch.float32)) * weights
        return torch.sqrt(torch.sum(sq))
    bounds, values = weights
    rows = g.reshape(-1, int(bounds[-1]))
    sq = torch.zeros((), dtype=torch.float32, device=g.device)
    for a, b, v in zip(bounds[:-1], bounds[1:], values):
        if v:
            seg = torch.linalg.vector_norm(rows[:, int(a):int(b)],
                                           dtype=torch.float32)
            sq = sq + float(v) * torch.square(seg)
    return torch.sqrt(sq)


def clip_by_global_norm(cfg: OptimizerConfig, g: torch.Tensor,
                        weights: Any = None) -> torch.Tensor:
    """Scale ``g`` (all ranks' owned shards, so the whole flat gradient) to
    a global L2 norm of at most ``cfg.clip_norm``; no-op when None.  The
    port has no mesh axes (one process holds every rank's shard), so the
    sum of squares runs over the whole stack; ``weights`` (JAX's per-element
    norm weights, or their segment tables: ``global_norm``) count a leaf
    replicated over r master rows 1/r a copy, so each parameter counts
    once."""
    if cfg.clip_norm is None:
        return g
    norm = global_norm(g, weights)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(norm, min=1e-12),
                        max=1.0)
    return (g.to(torch.float32) * scale).to(g.dtype)


def apply(cfg: OptimizerConfig, w: torch.Tensor, g: torch.Tensor,
          state: OptState, step: Optional[int] = None
          ) -> Tuple[torch.Tensor, OptState]:
    """Unfused update ``w_new = step(w, g)`` on flat f32 shards (the route
    when ``fused_optimizer=False``)."""
    w = w.to(torch.float32)
    g = g.to(torch.float32)
    if step is None:
        assert cfg.schedule == "constant" and cfg.warmup_steps == 0, (
            "lr schedules need the step count")
        lr = _f32(cfg.learning_rate)
    else:
        lr = learning_rate_at(cfg, step)
    lr = lr.to(w.device)
    if cfg.kind == "sgd":
        if cfg.weight_decay:
            g = g + cfg.weight_decay * w
        return w - lr * g, state
    if cfg.kind == "momentum":
        if cfg.weight_decay:
            g = g + cfg.weight_decay * w
        m = cfg.momentum * state["m"] + g
        return w - lr * m, {"m": m}
    if cfg.kind == "adamw":
        assert step is not None, "adamw needs the step count"
        t = float(step + 1)
        b1, b2 = _f32(cfg.b1), _f32(cfg.b2)
        m = b1 * state["m"] + (1 - b1) * g
        v = b2 * state["v"] + (1 - b2) * g * g
        mhat = m / (1 - b1 ** t)
        vhat = v / (1 - b2 ** t)
        upd = mhat / (torch.sqrt(vhat) + cfg.eps)
        if cfg.weight_decay:
            upd = upd + cfg.weight_decay * w
        return w - lr * upd, {"m": m, "v": v}
    raise ValueError(cfg.kind)
