"""The fused all-reduce + weight-update engine over virtual ranks — the port
of the JAX package's ``ops/fused_update.py``.

    g_own   = reduce_scatter(flat_grads)      # [n, L] -> [n, C] sums
    w_own'  = opt(w_own, g_own / n)           # owned f32 master shards
    params' = all_gather(w_own')              # [n, L] replicas

Every per-rank quantity is stacked over the n virtual ranks as its leading
dimension (``parallel.mesh.VirtualRanks``).  A parameter tree flattens in
``jax.tree_util`` order (dict keys sorted, so an MLP's ``b0..b9`` come
before ``w0..w9``) into one f32 vector, zero-padded so each rank's chunk is
a whole number of codec units — and of (block, 128)-lane tiles when the
fused kernels carry the wire.

Routing, as in the JAX package: ``fused_kernel=True`` on a CUDA tensor
runs the fused CUDA ring (``ops.ring_cuda``) with the update on its final
hop; everywhere else (a CPU tensor, ``impl="xla"``, the separate-op ring,
``topology="hier"``, n == 1) the same update formula
(``optim.fused_apply_flat``) runs right after the reduce, and the ring
takes the *configured* codec — with ``BFPConfig(codec="pallas")`` that is
the sublane layout, so the CPU route and the kernels quantize in the same
blocks.  ``topology="hier"`` takes the two-stage rings of
``ops.ring_hier`` (the codec on the slow inter hop only) for every
collective; the config refuses it with ``fused_kernel``, as the JAX
package's does.

``integrity=True`` on the three collectives appends the exact wire verdict
(``ops.integrity``): frame conservation on the rings (the per-rank payload
checksums of ``ops.ring``, or the checksum pair of the fused
reduce-scatter kernel), replica agreement after the fused all-gather
kernel (its wire lives inside the kernel), constant True for
``impl="xla"`` (no explicit frames).
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Tuple, Union

import numpy as np
import torch

from . import integrity as integrity_lib
from . import ring as ring_ops
from . import ring_cuda
from . import ring_hier
from .. import optim
from ..utils.config import CollectiveConfig, OptimizerConfig, OptimizerSpec


Path = Tuple[Union[str, int], ...]   # dict keys and list indices


class FlatMeta(NamedTuple):
    keys: Tuple[Path, ...]               # leaf paths, flattening order
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[torch.dtype, ...]
    sizes: Tuple[int, ...]
    padded_len: int


def resolve_codec(coll: CollectiveConfig):
    """The compress.Codec this config asks for (None = uncompressed)."""
    from ..compress import resolve
    return resolve(coll)


def pad_multiple(coll: CollectiveConfig, n: int) -> int:
    """Padding multiple of flat vectors fed to the n-way collective: each
    rank's chunk must be a whole number of codec units, and of
    (block, 128)-lane tiles when the fused kernels carry the wire or the
    codec takes the sublane layout (``Codec.unit_elems``: its kernels take
    whole tiles).  The JAX package pads to tiles on the fused route only;
    its separate-op ring with a sublane codec asserts whole tiles at run
    time instead, so this differs only where JAX's raises."""
    codec = resolve_codec(coll)
    if codec is not None:
        if coll.fused_kernel:
            return n * codec.pad_elems * ring_cuda.LANES
        return n * codec.unit_elems(codec.pad_elems)
    return n


def wire_bytes_for(coll: CollectiveConfig, L: int, n: int,
                   codec: Any = "__resolve__") -> int:
    """Per-rank wire bytes of one all-reduce of an [L]-element f32 vector
    under this config (the topology's accounting); pass ``codec=None`` for
    the raw-f32 accounting."""
    if codec == "__resolve__":
        codec = resolve_codec(coll)
    if coll.topology == "hier":
        return ring_hier.wire_bytes_per_device(L, n, coll.intra_size, codec)
    return ring_ops.wire_bytes_per_device(L, n, codec)


def _leaves(tree: Any, path: Path = ()) -> List[Tuple[Path, Any]]:
    """(path, leaf) pairs of a tree of dicts and lists in
    ``jax.tree_util`` order: dict keys sorted, list order kept."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in _leaves(tree[k],
                                                         path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, t in enumerate(tree)
                for pl in _leaves(t, path + (i,))]
    return [(path, tree)]


def tree_leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in _leaves(tree)]


def tree_map(fn: Any, tree: Any) -> Dict[str, Any]:
    pairs = _leaves(tree)
    return tree_from_leaves(tuple(p for p, _ in pairs),
                            [fn(leaf) for _, leaf in pairs])


def tree_from_leaves(paths: Tuple[Path, ...], leaves: List[Any]
                     ) -> Dict[str, Any]:
    """Rebuild the tree of dicts and lists that ``_leaves`` walked (a list
    at the top when the paths start with an index)."""
    root: Any = [] if paths and paths[0] and isinstance(paths[0][0], int) \
        else {}
    for path, leaf in zip(paths, leaves):
        node: Any = root
        for key, nxt in zip(path[:-1], path[1:]):
            if isinstance(node, list):
                if key == len(node):
                    node.append([] if isinstance(nxt, int) else {})
                node = node[key]
            else:
                node = node.setdefault(key, [] if isinstance(nxt, int)
                                       else {})
        if isinstance(node, list):
            node.append(leaf)
        else:
            node[path[-1]] = leaf
    return root


def flat_meta(tree: Any, coll: CollectiveConfig, n: int) -> FlatMeta:
    """Static flattening metadata of a parameter tree (tensors or numpy
    arrays; only shapes and dtypes are read)."""
    pairs = _leaves(tree)
    shapes = tuple(tuple(leaf.shape) for _, leaf in pairs)
    dtypes = tuple(leaf.dtype if isinstance(leaf, torch.Tensor)
                   else torch.as_tensor(np.zeros((), leaf.dtype)).dtype
                   for _, leaf in pairs)
    sizes = tuple(int(np.prod(s)) if s else 1 for s in shapes)
    total = sum(sizes)
    m = pad_multiple(coll, n)
    return FlatMeta(tuple(p for p, _ in pairs), shapes, dtypes, sizes,
                    total + (-total) % m)


def params_like_from_meta(meta: FlatMeta) -> Any:
    """A params tree of meta-device tensors (shapes and dtypes, no
    storage) rebuilt from flattening metadata: what a target trainer's
    ``_ensure_meta`` reads when a live state arrives from another rank
    count (``parallel.reshard``) instead of from ``init_state``."""
    return tree_from_leaves(meta.keys, [
        torch.empty(s, dtype=d, device="meta")
        for s, d in zip(meta.shapes, meta.dtypes)])


def flatten_leaves(leaves: List[torch.Tensor], meta: FlatMeta,
                   out: torch.Tensor = None) -> torch.Tensor:
    """Copy leaves in tree order into one flat f32 [padded_len] vector
    (into ``out`` when given), zero-padded, one leaf at a time."""
    if out is None:
        out = torch.empty(meta.padded_len, dtype=torch.float32,
                          device=leaves[0].device)
    off = 0
    for leaf, size in zip(leaves, meta.sizes):
        out[off:off + size].copy_(leaf.reshape(-1))
        off += size
    out[off:] = 0
    return out


def flatten_tree(tree: Any, meta: FlatMeta,
                 out: torch.Tensor = None) -> torch.Tensor:
    """Concatenate a tree into one flat f32 [padded_len] vector."""
    return flatten_leaves(tree_leaves(tree), meta, out)


def unflatten_tree(flat: torch.Tensor, meta: FlatMeta,
                   side: torch.Tensor = None) -> Dict[str, Any]:
    """Inverse of flatten_tree.  Leaves in ``flat``'s dtype are views of
    it.  ``side`` (``split_working``): the leaves of another dtype come
    from it instead, in tree order."""
    leaves, off, s_off = [], 0, 0
    for shape, dtype, size in zip(meta.shapes, meta.dtypes, meta.sizes):
        if side is not None and dtype != flat.dtype:
            leaves.append(side[s_off:s_off + size].view(shape).to(dtype))
            s_off += size
        else:
            leaves.append(flat[off:off + size].view(shape).to(dtype))
        off += size
    return tree_from_leaves(meta.keys, leaves)


def split_working(flat: torch.Tensor, meta: FlatMeta
                  ) -> Tuple[torch.Tensor, Any]:
    """Gathered f32 weights ``[n, L_pad]`` as working replicas: ``(flat in
    the model dtype, side)``, the model dtype the one that holds most of
    the tree's elements (a bf16 Llama with MoE's f32 routers is bf16).
    ``side`` is None when every leaf has that dtype, else ``[n, L_side]`` f32, the other leaves' exact values in
    tree order (``unflatten_tree(..., side)`` reads them).  One cast of
    the whole row gives each leaf of the working dtype the bits of JAX's
    per-leaf cast in ``unflatten_tree``; the side keeps the others'."""
    held: Dict[torch.dtype, int] = {}
    for dtype, size in zip(meta.dtypes, meta.sizes):
        held[dtype] = held.get(dtype, 0) + size
    dt = max(held, key=held.get)
    rows = flat if flat.dtype == dt else flat.to(dt)
    if len(set(meta.dtypes)) == 1:
        return rows, None
    spans, off = [], 0
    for dtype, size in zip(meta.dtypes, meta.sizes):
        if dtype != dt:
            spans.append(flat[:, off:off + size])
        off += size
    return rows, torch.cat(spans, dim=1).to(torch.float32)


def init_master_shard(params_tree, coll: CollectiveConfig,
                      opt_cfg: OptimizerConfig, n: int
                      ) -> Tuple[torch.Tensor, optim.OptState, FlatMeta]:
    """``(w_own [n, C], opt_state, meta)`` from a replicated parameter
    tree: rank i owns chunk i of the flat master vector."""
    meta = flat_meta(params_tree, coll, n)
    flat = flatten_tree(params_tree, meta)
    w_own = flat.reshape(n, meta.padded_len // n).clone()
    return w_own, optim.init_state(opt_cfg, w_own.shape,
                                   device=w_own.device), meta


def _fused_bfp_cfg(coll: CollectiveConfig):
    return resolve_codec(coll).cfg


def _kernel_route(coll: CollectiveConfig, x: torch.Tensor) -> bool:
    return coll.fused_kernel and x.device.type == "cuda"


def _fused_slice(coll: CollectiveConfig, L: int, n: int) -> int:
    """The fused route's slice (and checksum frame): whole tiles of the
    chunk, at most ``coll.slice_elems``."""
    return ring_cuda.pick_slice_elems(L // n, coll.slice_elems,
                                      _fused_bfp_cfg(coll).block_size)


def _true(x: torch.Tensor) -> torch.Tensor:
    return torch.tensor(True, device=x.device)


def _pair_ok(pair: torch.Tensor) -> torch.Tensor:
    return integrity_lib.conservation_ok(pair[:, 0], pair[:, 1])


def reduce_scatter(flat_g: torch.Tensor, coll: CollectiveConfig,
                   integrity: bool = False):
    """[n, L] per-rank vectors -> [n, L/n]: rank i's reduced chunk i; with
    ``integrity``, ``(owned, wire_ok)``."""
    n, L = flat_g.shape
    if coll.impl == "xla":
        out = flat_g.reshape(n, n, L // n).sum(dim=0)
        return (out, _true(out)) if integrity else out
    if coll.topology == "hier":
        return ring_hier.hier_reduce_scatter(
            flat_g, coll.intra_size, compression=resolve_codec(coll),
            slice_elems=coll.slice_elems, integrity=integrity)
    if _kernel_route(coll, flat_g):
        res = ring_cuda.ring_reduce_scatter_fused(
            flat_g, compression=_fused_bfp_cfg(coll),
            slice_elems=_fused_slice(coll, L, n), integrity=integrity)
        return (res[0], _pair_ok(res[1])) if integrity else res
    slice_e = (_fused_slice(coll, L, n) if coll.fused_kernel
               else coll.slice_elems)
    return ring_ops.ring_reduce_scatter(flat_g, resolve_codec(coll),
                                        slice_elems=slice_e,
                                        integrity=integrity)


def reduce_scatter_update(flat_g: torch.Tensor, w_own: torch.Tensor,
                          opt_state: optim.OptState, step: int,
                          coll: CollectiveConfig, opt_cfg: OptimizerConfig,
                          integrity: bool = False):
    """Fused gradient reduce + ZeRO-1 update of each rank's owned shard.
    Returns ``(g_own_sum [n, C], w_new [n, C], opt_state_new)``, and the
    wire verdict last with ``integrity``.  On the CUDA kernel route the
    update retires inside the kernel (``update_route_gatable`` is False
    there); every other route applies the same formula after the reduce.
    ``topology="hier"`` always takes that shared-formula route."""
    spec = OptimizerSpec.from_optimizer(opt_cfg)
    n, L = flat_g.shape
    hyper = optim.fused_hyperparams(opt_cfg, step, device=flat_g.device)
    if _kernel_route(coll, flat_g) and n > 1 and coll.topology == "flat":
        res = ring_cuda.ring_reduce_scatter_update_fused(
            flat_g, w_own, opt_state, hyper, opt_kind=spec.kind,
            compression=_fused_bfp_cfg(coll),
            slice_elems=_fused_slice(coll, L, n), integrity=integrity)
        return res[:3] + (_pair_ok(res[3]),) if integrity else res
    res = reduce_scatter(flat_g, coll, integrity=integrity)
    g_own = res[0] if integrity else res
    w_new, st2 = optim.fused_apply_flat(spec, w_own, g_own, opt_state,
                                        hyper, n)
    return (g_own, w_new, st2) + ((res[1],) if integrity else ())


def update_route_gatable(coll: CollectiveConfig, n: int = 0,
                         device=None) -> bool:
    """True when ``reduce_scatter_update`` takes a route on which the
    caller gates a tripped verdict (``torch.where(ok, new, old)``).  False
    only on the CUDA kernel route (``fused_kernel``, n != 1, a CUDA
    device), where the update retires with the final hop inside the kernel
    and, as in the JAX package, ``chaos.check_step_diag`` invalidating the
    step is the only recovery.  ``n`` 0 or ``device`` None mean unknown:
    the kernel route is then assumed reachable."""
    on_card = device is None or torch.device(device).type == "cuda"
    return not (coll.fused_kernel and n != 1 and coll.topology == "flat"
                and on_card)


def error_feedback_encode(codec, flat_g: torch.Tensor, residual: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compensate-then-compress: ``(g_wire, new_residual)`` with ``g_wire =
    roundtrip(flat_g + residual)``, the locally quantized gradient handed to
    the collective, and ``new_residual`` what this pass dropped, carried to
    the next step.  ``flat_g`` / ``residual``: [n, L] per-rank rows, all
    ranks encoded in one codec call (``ring.check_whole_units``)."""
    n, L = flat_g.shape
    g_comp = flat_g + residual
    codec = codec.for_payload(L, flat_g.device)
    ring_ops.check_whole_units(codec, L)
    g_wire = codec.roundtrip(g_comp.reshape(-1)).reshape(n, L)
    return g_wire, g_comp - g_wire


def ring_all_reduce_routed(x: torch.Tensor, coll: CollectiveConfig
                           ) -> torch.Tensor:
    """Explicit-ring sum all-reduce [n, L] -> [n, L] (every row the sums)
    under the config's routing, as the JAX function routes it for the
    bucketed DDP trainer: ``topology="hier"`` takes the two-stage rings
    (``ring_hier.hier_all_reduce``), ``fused_kernel`` the fused BFP ring
    (``ring_cuda.ring_all_reduce_fused``: the kernels on a CUDA tensor,
    their plain versions on the CPU), otherwise the ``ops.ring`` rings with
    the configured codec.  No integrity seam: the DDP trainer refuses
    integrity_check, as the JAX one does."""
    if coll.topology == "hier":
        return ring_hier.hier_all_reduce(
            x, coll.intra_size, compression=resolve_codec(coll),
            slice_elems=coll.slice_elems)
    if coll.fused_kernel:
        return ring_cuda.ring_all_reduce_fused(
            x, compression=_fused_bfp_cfg(coll))
    return ring_ops.ring_all_reduce(x, resolve_codec(coll),
                                    slice_elems=coll.slice_elems)


def all_gather_flat(owned: torch.Tensor, coll: CollectiveConfig,
                    integrity: bool = False):
    """[n, C] owned chunks -> [n, n*C] replicas; with ``integrity``,
    ``(replicas, wire_ok)``."""
    n, C = owned.shape
    if coll.impl == "xla":
        out = owned.reshape(1, n * C).expand(n, n * C)
        return (out, _true(out)) if integrity else out
    if coll.topology == "hier":
        return ring_hier.hier_all_gather(
            owned, coll.intra_size, compression=resolve_codec(coll),
            integrity=integrity)
    if _kernel_route(coll, owned):
        out = ring_cuda.ring_all_gather_fused(
            owned, compression=_fused_bfp_cfg(coll))
        return (out, integrity_lib.replica_consistent(out)) if integrity \
            else out
    return ring_ops.ring_all_gather(owned, resolve_codec(coll),
                                    integrity=integrity)


def repad_flat(v: torch.Tensor, meta: FlatMeta) -> torch.Tensor:
    """A flat master or optimizer vector (1-D) re-fitted to ``meta``'s
    padded length, value-exact: the live elements (``sum(meta.sizes)``)
    do not depend on the mesh or the codec, and every pad element is
    zero (``flatten_tree`` zero-pads, and the optimizers keep the pad
    lanes at zero), so only the zero tail changes.  Fewer than the live
    elements, or a nonzero tail past them, is another model's vector and
    raises."""
    total = sum(meta.sizes)
    if v.shape[0] < total:
        raise ValueError(
            f"flat state of length {v.shape[0]} cannot hold this "
            f"layout's {total} live elements: wrong checkpoint/model")
    if v.shape[0] == meta.padded_len:
        return v
    tail = v[total:]
    if tail.numel() and float(tail.abs().max()) != 0.0:
        raise ValueError(
            f"flat state of length {v.shape[0]} carries nonzero data "
            f"past this layout's {total} live elements: wrong "
            "checkpoint/model (refusing to truncate)")
    return torch.nn.functional.pad(v[:total], (0, meta.padded_len - total))
