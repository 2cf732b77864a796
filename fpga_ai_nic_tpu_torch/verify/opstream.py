"""Protocol programs the port takes from the JAX package's
``verify/opstream.py``, in plain Python: the hierarchical two-hop phase
program of ``ops/ring_hier.py`` (``intra_perm``, ``inter_perm``,
``HierPhase``, ``HierProgram``, ``hier_program``), the block order of a
KV migration (``HandoffMove``, ``handoff_program``), which
``serve.handoff.apply_handoff`` iterates, and the reshard IR
(``Seg``, ``reshard_segments``, ``reshard_owners``, ``union_layout``,
``SegMove``, ``ResidMove``, ``reshard_msg_bases``, ``reshard_leaf_actions``,
``reshard_residual_actions``, ``reshard_op_stream``), which
``parallel.reshard`` executes.

One definition of the phases, their subring permutations and the
conservation message ids, consumed by ``ops.ring_hier``.  The port's rings
run over virtual ranks stacked as the rows of one tensor, so a permutation
``[(src, dst), ...]`` is applied as ``received[dst] = payload[src]``
(``ops.ring._send``'s ``perm=``).
"""

from __future__ import annotations

from typing import Any, List, NamedTuple, Optional, Sequence, Tuple


def intra_perm(n: int, ni: int) -> List[Tuple[int, int]]:
    """Next neighbour inside each group of ni consecutive ranks: the intra
    subring permutation."""
    return [(g * ni + j, g * ni + (j + 1) % ni)
            for g in range(n // ni) for j in range(ni)]


def inter_perm(n: int, ni: int) -> List[Tuple[int, int]]:
    """Next group, same intra position: the inter rings."""
    ng = n // ni
    return [(g * ni + j, ((g + 1) % ng) * ni + j)
            for g in range(ng) for j in range(ni)]


class HierPhase(NamedTuple):
    """One phase of the hierarchical schedule: ``hops`` ring hops over
    ``perm``, each hop carrying ``slices`` wire messages.  ``msg(s, k)`` is
    hop s / slice k's id in the owning conservation carry, the index
    ``integrity.hop_weight`` weights."""

    kind: str                  # rs_intra | rs_inter | ag_inter | ag_intra
    hops: int
    slices: int                # wire messages per hop (s_inter on rs_inter)
    base: int                  # carry message id of (hop 0, slice 0)
    perm: Tuple[Tuple[int, int], ...]

    def msg(self, s: Any, k: Any = 0) -> Any:
        return self.base + s * self.slices + k


class HierProgram(NamedTuple):
    """The full two-hop schedule of ``ops.ring_hier`` over n = ni * ng
    ranks.  The reduce-scatter phases share one conservation carry (intra
    hop s is message s, inter hop s slice k is (ni-1) + s*s_inter + k); the
    all-gather phases share another (inter hop s is message s, intra hop s
    is (ng-1) + s)."""

    n: int
    ni: int
    ng: int
    s_inter: int
    rs_intra: HierPhase
    rs_inter: HierPhase
    ag_inter: HierPhase
    ag_intra: HierPhase


def hier_program(n: int, ni: int, s_inter: int = 1) -> HierProgram:
    """Build the hierarchical phase program (validates the declared
    factorization, as ``ops.ring_hier.check_factorization``)."""
    if ni < 1 or n % ni:
        raise ValueError(f"intra size {ni} does not factor n={n}")
    ng = n // ni
    pa = tuple(intra_perm(n, ni))
    pb = tuple(inter_perm(n, ni))
    return HierProgram(
        n=n, ni=ni, ng=ng, s_inter=s_inter,
        rs_intra=HierPhase("rs_intra", ni - 1, 1, 0, pa),
        rs_inter=HierPhase("rs_inter", ng - 1, s_inter, ni - 1, pb),
        ag_inter=HierPhase("ag_inter", ng - 1, 1, 0, pb),
        ag_intra=HierPhase("ag_intra", ni - 1, 1, ng - 1, pa))


class HandoffMove(NamedTuple):
    """One gathered page block of a KV migration: pool index in
    layer-major K-then-V order, equal to its odd-multiplier index in
    ``ops.integrity.gathered_page_checksums`` (a block-order change is a
    weight change)."""

    pool: int
    msg: int


def handoff_program(n_layers: int) -> List[HandoffMove]:
    """The block order of one KV migration: ``serve.handoff.apply_handoff``
    gathers, sends and writes the blocks in this order, and the landed-page
    checksum weights block j by 2j + 1."""
    return [HandoffMove(i, i) for i in range(2 * n_layers)]


# ---------------------------------------------------------------------------
# the reshard transfer program (``parallel.reshard``)
# ---------------------------------------------------------------------------

Op = Tuple[Any, ...]


def msg_weight(msg: int) -> int:
    """The odd conservation weight of message ``msg``: (2 msg + 1) mod
    2^32, ``ops.integrity.hop_weight`` on plain ints."""
    return (2 * msg + 1) & 0xFFFFFFFF


class Seg(NamedTuple):
    """One intersection-table segment: ``length`` contiguous live
    elements moving from source rank ``src`` (at chunk-local ``src_off``)
    to target rank ``dst`` (at ``dst_off``); ``src == dst`` stays
    resident."""

    src: int
    dst: int
    src_off: int
    dst_off: int
    length: int


def reshard_segments(live: int, chunk_src: int,
                     chunk_tgt: int) -> Tuple[Seg, ...]:
    """Source->target shard intersections of a [live] flat vector: cut
    [0, live) at every chunk boundary of either layout.  The segments
    partition the live range (asserted)."""
    assert live > 0 and chunk_src > 0 and chunk_tgt > 0
    cuts = {0, live}
    cuts.update(range(chunk_src, live, chunk_src))
    cuts.update(range(chunk_tgt, live, chunk_tgt))
    edges = sorted(cuts)
    table = []
    for a, b in zip(edges, edges[1:]):
        src, dst = a // chunk_src, a // chunk_tgt
        table.append(Seg(src=src, dst=dst, src_off=a - src * chunk_src,
                         dst_off=a - dst * chunk_tgt, length=b - a))
    assert sum(t.length for t in table) == live
    return tuple(table)


def reshard_owners(n_src: int, n_tgt: int) -> Tuple[int, ...]:
    """The error-feedback residual's old-rank -> new-owner map:
    contiguous groups, every old residual has exactly one new home (mass
    is conserved), new ranks beyond the assignment start at zero."""
    assert n_src > 0 and n_tgt > 0
    return tuple(i * n_tgt // n_src for i in range(n_src))


def union_layout(live: int, n_src: int, padded_src: int, n_tgt: int,
                 padded_tgt: int) -> Tuple[int, int, int, int]:
    """(chunk_src, chunk_tgt, n_union, seed_len) of a mesh-shape change.
    Shrink: the union layout is the source layout, no seeding; grow: the
    source is first re-laid onto n_union ranks with the smallest even
    chunking that holds the live elements."""
    assert padded_src % n_src == 0, (padded_src, n_src)
    assert padded_tgt % n_tgt == 0, (padded_tgt, n_tgt)
    n_union = max(n_src, n_tgt)
    if n_tgt <= n_src:
        chunk_src, seed_len = padded_src // n_src, padded_src
    else:
        chunk_src = -(-live // n_union)
        seed_len = n_union * chunk_src
    return chunk_src, padded_tgt // n_tgt, n_union, seed_len


class SegMove(NamedTuple):
    """One intersection segment as a transfer-program action: an
    ``"xfer"`` crosses the wire (conservation message ``msg``), a
    ``"copy"`` stays resident (never checksummed)."""

    kind: str                  # "xfer" | "copy"
    seg_index: int
    src: int
    dst: int
    src_off: int
    dst_off: int
    length: int
    msg: int


class ResidMove(NamedTuple):
    """One error-feedback residual ownership move (``"keep"`` stays
    resident)."""

    kind: str                  # "xfer" | "keep"
    src: int
    dst: int
    msg: int


def reshard_msg_bases(n_segs: int,
                      n_flat_leaves: int) -> Tuple[Tuple[int, ...], int]:
    """(per-leaf message bases, residual base) of the one program-wide
    conservation counter: leaf li's segments are messages
    [li*n_segs, (li+1)*n_segs), the residual moves follow, so every
    message of a transfer gets a distinct odd weight."""
    return (tuple(li * n_segs for li in range(n_flat_leaves)),
            n_flat_leaves * n_segs)


def reshard_leaf_actions(table: Sequence[Any],
                         base: int = 0) -> List[SegMove]:
    """One flat leaf's transfer actions in table order (message ids
    included): the program ``parallel.reshard`` runs a leaf."""
    return [SegMove("copy" if t.src == t.dst else "xfer", ti,
                    t.src, t.dst, t.src_off, t.dst_off, t.length,
                    base + ti)
            for ti, t in enumerate(table)]


def reshard_residual_actions(owners: Sequence[int],
                             base: int = 0) -> List[ResidMove]:
    """The residual moves in ascending-source order (the golden twin's
    sum order)."""
    return [ResidMove("keep" if i == owner else "xfer", i, owner,
                      base + i)
            for i, owner in enumerate(owners)]


class _StreamSink:
    """Collects one node's ops in the JAX package's ``ListSink`` shapes
    (the ops a reshard stream uses)."""

    def __init__(self) -> None:
        self.ops: List[Op] = []

    def local(self, name: str, *args: Any) -> None:
        self.ops.append(("local", name, tuple(args)))

    def chk_emit(self, msg: int, carry: str = "wire") -> None:
        self.ops.append(("chk_emit", carry, msg, msg_weight(msg)))

    def chk_arrive(self, msg: int, carry: str = "wire") -> None:
        self.ops.append(("chk_arrive", carry, msg, msg_weight(msg)))


def reshard_op_stream(live: int, chunk_src: int, chunk_tgt: int,
                      n_union: int,
                      residual_owners_map: Optional[Sequence[int]] = None,
                      n_flat_leaves: int = 1,
                      integrity: bool = False) -> List[List[Op]]:
    """Per-node op streams of the transfer program, from the same action
    lists ``parallel.reshard`` executes: per leaf, the intersection
    segments in table order (a single-pair send/recv where the owner
    changes, a resident copy where it does not), then the residual
    ownership moves in ascending-source order; ``integrity`` adds the
    paired checksum ops with the program-wide message counter."""
    segs = reshard_segments(live, chunk_src, chunk_tgt)
    bases, resid_base = reshard_msg_bases(len(segs), n_flat_leaves)
    sinks = [_StreamSink() for _ in range(n_union)]

    def xfer(src: int, dst: int, tag: Op, msg: int) -> None:
        assert src < n_union and dst < n_union, (tag, n_union)
        if integrity:
            sinks[src].chk_emit(msg)
        sinks[src].ops.append(("send_to", dst, tag))
        sinks[dst].ops.append(("recv_from", src, tag))
        if integrity:
            sinks[dst].chk_arrive(msg)

    for li in range(n_flat_leaves):
        for act in reshard_leaf_actions(segs, bases[li]):
            if act.kind == "copy":
                if act.src < n_union:
                    sinks[act.src].local("copy", "seg", li, act.seg_index)
                continue
            xfer(act.src, act.dst, ("seg", li, act.seg_index), act.msg)
    if residual_owners_map is not None:
        for ra in reshard_residual_actions(residual_owners_map,
                                           resid_base):
            if ra.kind == "keep":
                sinks[ra.src].local("resid_keep", "resid", ra.src)
                continue
            xfer(ra.src, ra.dst, ("resid", ra.src), ra.msg)
    return [s.ops for s in sinks]
