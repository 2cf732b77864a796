"""Protocol programs the port takes from the JAX package's
``verify/opstream.py``, in plain Python: the hierarchical two-hop phase
program of ``ops/ring_hier.py`` (``intra_perm``, ``inter_perm``,
``HierPhase``, ``HierProgram``, ``hier_program``) and the block order of a
KV migration (``HandoffMove``, ``handoff_program``), which
``serve.handoff.apply_handoff`` iterates.

One definition of the phases, their subring permutations and the
conservation message ids, consumed by ``ops.ring_hier``.  The port's rings
run over virtual ranks stacked as the rows of one tensor, so a permutation
``[(src, dst), ...]`` is applied as ``received[dst] = payload[src]``
(``ops.ring._send``'s ``perm=``).
"""

from __future__ import annotations

from typing import Any, List, NamedTuple, Tuple


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
