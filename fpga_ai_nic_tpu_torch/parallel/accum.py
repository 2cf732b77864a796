"""Gradient accumulation — the port of the JAX package's
``parallel/accum.py``: a step's batch is cut into ``accum_steps``
sequential microbatches, their gradients are summed in f32 and scaled by
``1 / accum_steps``, and the collective still runs once a step, on the
averaged gradient.

Microbatch k of a rank is rows ``k m .. (k + 1) m - 1`` of its local
batch (m = the local batch / ``accum_steps``), as JAX's reshape of each
device's batch gives it.  Microbatch 0 seeds the sums (JAX's scan carry),
the others are added to them in order, and the loss is summed the same
way.  Microbatches are averaged uniformly, so with -100-masked labels the
token weighting is exact within a microbatch and uniform across them; a
loss that weights by the global label count reads one count a microbatch
(``models.bert.with_global_count(..., accum_steps=)``).

``accumulated_value_and_grad`` and ``accumulated_loss`` are JAX's two
functions over one rank's params and batch.  The trainers use
``microbatches`` and ``accumulate``: each microbatch's gradients go
straight into the rows the trainer's backward already fills (the f32 flat
rows of ``parallel.train``, the DDP bucket rows), added in f32, so no
second copy of the rows is made.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

import torch

from ..ops import fused_update

Rows = Union[torch.Tensor, List[torch.Tensor]]


def _split(x: torch.Tensor, accum_steps: int, axis: int
           ) -> Tuple[torch.Tensor, ...]:
    if x.shape[axis] % accum_steps:
        raise ValueError(f"a batch leaf of shape {tuple(x.shape)} does not "
                         f"split into accum_steps={accum_steps} microbatches "
                         f"on axis {axis}")
    return torch.chunk(x, accum_steps, dim=axis)


def microbatches(batch: Sequence[torch.Tensor], accum_steps: int,
                 lead: int = 0) -> List[Tuple[torch.Tensor, ...]]:
    """The ``accum_steps`` microbatches of a batch whose leaves carry
    ``lead`` rank axes ahead of each rank's local batch axis (0 for one
    rank's batch, 1 for ``[n, B/n, ...]``, 2 or 3 with the ep and sp
    axes): microbatch k holds rows ``k m .. (k + 1) m - 1`` of every
    rank's local batch, as views.  A leaf with no axis past the rank axes
    it carries (a per-rank count, ``[n, accum_steps]`` under sp) splits
    on its last axis; one that has only a rank axis raises."""
    parts = []
    for x in batch:
        axis = min(lead, x.dim() - 1)
        if lead and axis == 0:
            raise ValueError(
                f"a batch leaf of shape {tuple(x.shape)} has no axis past "
                "its rank axis to cut into microbatches (a global count "
                "takes with_global_count(..., accum_steps=))")
        parts.append(_split(x, accum_steps, axis))
    return [tuple(p[k] for p in parts) for k in range(accum_steps)]


def scale_rows(rows: Rows, accum_steps: int) -> None:
    """Multiply the summed rows by f32 ``1 / accum_steps`` in place (JAX's
    ``g * inv``)."""
    inv = float(torch.tensor(1.0 / accum_steps, dtype=torch.float32))
    for r in (rows if isinstance(rows, list) else [rows]):
        r.mul_(inv)


def accumulate(grads_fn: Callable[[Tuple[torch.Tensor, ...],
                                   Optional[Rows]],
                                  Tuple[Rows, torch.Tensor]],
               batch: Sequence[torch.Tensor], accum_steps: int,
               lead: int = 1) -> Tuple[Rows, torch.Tensor]:
    """A trainer's backward over ``accum_steps`` microbatches.
    ``grads_fn(mb, into) -> (rows, loss)``: with ``into`` None it returns
    new gradient rows (microbatch 0 seeds them), else it adds the
    microbatch's gradients into ``into`` in f32.  Returns the rows and
    the loss, each summed over the microbatches and scaled by
    ``1 / accum_steps``; at ``accum_steps=1`` it is one ``grads_fn``."""
    if accum_steps == 1:
        return grads_fn(tuple(batch), None)
    mbs = microbatches(batch, accum_steps, lead)
    rows, loss = grads_fn(mbs[0], None)
    total = loss.to(torch.float32)
    for mb in mbs[1:]:
        _, loss = grads_fn(mb, rows)
        total = total + loss.to(torch.float32)
    scale_rows(rows, accum_steps)
    inv = torch.tensor(1.0 / accum_steps, dtype=torch.float32,
                       device=total.device)
    return rows, total * inv


def add_leaves(leaves: Sequence[torch.Tensor], meta: fused_update.FlatMeta,
               out: torch.Tensor) -> None:
    """Add gradient leaves in tree order into their slots of one flat f32
    row (``fused_update.flatten_leaves``' layout), each cast to f32."""
    off = 0
    for leaf, size in zip(leaves, meta.sizes):
        out[off:off + size].add_(leaf.reshape(-1))
        off += size


def _tree_leaves_grad(params: Any) -> Tuple[List[torch.Tensor], Any]:
    pairs = fused_update._leaves(params)
    leaves = [t.detach().requires_grad_() for _, t in pairs]
    return leaves, fused_update.tree_from_leaves(tuple(p for p, _ in pairs),
                                                 leaves)


def accumulated_value_and_grad(loss_fn: Callable, accum_steps: int
                               ) -> Callable:
    """``fn(params, batch) -> (loss, grads)`` averaged over ``accum_steps``
    sequential microbatches of the batch's leading axis (which must
    divide), the sums in f32; the gradients come back as a tree of f32
    tensors of the params' structure (at ``accum_steps=1`` in the
    leaves' dtypes, as ``jax.value_and_grad`` gives them)."""

    def one(params, mb):
        leaves, tree = _tree_leaves_grad(params)
        loss = loss_fn(tree, mb)
        return loss.detach(), list(torch.autograd.grad(loss, leaves))

    def fn(params, batch):
        paths = tuple(p for p, _ in fused_update._leaves(params))
        if accum_steps == 1:
            loss, gs = one(params, tuple(batch))
            return loss, fused_update.tree_from_leaves(paths, gs)
        mbs = microbatches(batch, accum_steps, 0)
        loss, gs = one(params, mbs[0])
        total = loss.to(torch.float32)
        acc = [g.to(torch.float32) for g in gs]
        for mb in mbs[1:]:
            loss, gs = one(params, mb)
            total = total + loss.to(torch.float32)
            for a, g in zip(acc, gs):
                a.add_(g)
        scale_rows(acc, accum_steps)
        inv = torch.tensor(1.0 / accum_steps, dtype=torch.float32)
        return total * inv.to(total.device), \
            fused_update.tree_from_leaves(paths, acc)

    return fn


def accumulated_loss(loss_fn: Callable, accum_steps: int) -> Callable:
    """The mean loss over ``accum_steps`` sequential microbatches,
    differentiable as a whole (JAX's, for trainers that differentiate an
    outer function wrapping the loss): the f32 sum seeded by microbatch
    0, divided by ``accum_steps``."""
    if accum_steps == 1:
        return loss_fn

    def fn(params, batch):
        mbs = microbatches(batch, accum_steps, 0)
        total = loss_fn(params, mbs[0]).to(torch.float32)
        for mb in mbs[1:]:
            total = total + loss_fn(params, mb).to(torch.float32)
        return total / accum_steps

    return fn
