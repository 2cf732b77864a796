"""Hierarchical (intra x inter) two-stage ring collectives over virtual
ranks, the codec only on the slow hop — the port of the JAX package's
``ops/ring_hier.py``.

The flat ring (``ops.ring``) pays the codec on every hop, also on hops
that cross a fast boundary where full precision is free (the links inside
a node against the links between nodes).  This module quantizes only the
slow phase:

  phase A (intra, fast hop, no codec): ring reduce-scatter inside each
      group of ``n_intra`` consecutive ranks, in f32; after ni-1 hops member
      j of every group holds the group-partial sums of the chunks whose
      intra index is j.
  phase B (inter, slow hop, codec ring): ring reduce-scatter across groups
      (members with equal intra position form the inter rings), with the
      configured codec on the wire through ``ops.ring._send``, so every
      codec that rides the flat ring rides the slow hop unchanged.

The all-gather runs the phases in reverse: the inter codec gather of the
owned chunk (encoded once, forwarded verbatim), then the raw intra
gather, so the weights cross the slow boundary once, quantized.

The n = ni * ng ranks are the rows of one ``[n, L]`` tensor: rank d is
group ``d // ni``, intra position ``d % ni``.  Ownership stays natural:
rank d ends with chunk d, as on the flat ring, so a trainer's ZeRO-1 shards
are the same under either topology.  A hop applies the phase's subring
permutation (``verify.opstream``) to the stacked rows (``ops.ring._send``'s
``perm=``), so the value and wire taps of ``runtime.chaos`` fire on hier
hops as on flat ones, and with ``BFPConfig(codec="pallas")`` on a CUDA
tensor phase B runs the BFP encode and decode kernels on every slow hop.

Numerics: phase A's add order is the flat-ring schedule inside the group,
phase B's the flat-ring schedule across groups; ``compress.golden``'s
``hier_*`` twins are the bit spec for every codec.  Wire accounting is
exact per hop and phase (``HierarchicalPlan``).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from . import integrity as _integrity
from . import ring as ring_ops
from ..compress import as_codec
from ..verify import opstream as _opstream


# ---------------------------------------------------------------------------
# static plan / wire accounting
# ---------------------------------------------------------------------------

class HierarchicalPlan(NamedTuple):
    """Static shape and exact byte accounting of one hierarchical
    all-reduce (reduce-scatter and/or all-gather) of an [L]-element f32
    payload over n = n_intra * n_inter ranks."""

    L: int                 # flat payload elements (padded, L % n == 0)
    n: int
    n_intra: int           # fast-hop group size (ni)
    n_inter: int           # slow-hop ring length (ng)
    codec_name: Optional[str]        # inter-hop wire format (None = f32)
    # exact per-rank bytes on the wire, per phase and collective:
    rs_intra_bytes: int
    rs_inter_bytes: int
    ag_intra_bytes: int
    ag_inter_bytes: int

    def wire_bytes(self, which: str = "all_reduce") -> int:
        """Exact per-rank wire bytes: "reduce_scatter", "all_gather" or
        "all_reduce" (= RS + AG)."""
        rs = self.rs_intra_bytes + self.rs_inter_bytes
        ag = self.ag_intra_bytes + self.ag_inter_bytes
        return {"reduce_scatter": rs, "all_gather": ag,
                "all_reduce": rs + ag}[which]

    def intra_bytes(self, which: str = "all_reduce") -> int:
        return {"reduce_scatter": self.rs_intra_bytes,
                "all_gather": self.ag_intra_bytes,
                "all_reduce": self.rs_intra_bytes + self.ag_intra_bytes
                }[which]

    def inter_bytes(self, which: str = "all_reduce") -> int:
        return {"reduce_scatter": self.rs_inter_bytes,
                "all_gather": self.ag_inter_bytes,
                "all_reduce": self.rs_inter_bytes + self.ag_inter_bytes
                }[which]

    def describe(self) -> Dict[str, Any]:
        return {
            "topology": "hier",
            "n": self.n, "n_intra": self.n_intra, "n_inter": self.n_inter,
            "codec": self.codec_name or "none",
            "payload_elems": self.L,
            "rs_intra_bytes": self.rs_intra_bytes,
            "rs_inter_bytes": self.rs_inter_bytes,
            "ag_intra_bytes": self.ag_intra_bytes,
            "ag_inter_bytes": self.ag_inter_bytes,
            "wire_bytes_all_reduce": self.wire_bytes("all_reduce"),
        }


def check_factorization(n: int, n_intra: int) -> int:
    """Validate the declared factorization; returns n_inter."""
    if n_intra < 1 or n % n_intra != 0:
        raise ValueError(
            f"intra_size={n_intra} does not factor the {n}-rank axis "
            "(need 1 <= intra_size dividing n)")
    return n // n_intra


def plan_hier(L: int, n: int, n_intra: int,
              compression=None) -> HierarchicalPlan:
    """Exact wire accounting for a hierarchical all-reduce of [L] f32.

    Per rank: phase A sends (ni-1) raw-f32 units of L/ni elements each
    (reduce-scatter) and the same again for the gather; phase B sends
    (ng-1) codec payloads of the final chunk C = L/n per collective.
    ``compression`` is a Codec or a BFPConfig, normalized as ``ops.ring``
    does."""
    ng = check_factorization(n, n_intra)
    if L % n != 0:
        raise ValueError(f"need L divisible by n={n}, got {L}")
    codec = as_codec(compression)
    C = L // n
    unit_a = L // n_intra                   # ng * C raw f32 elements
    inter_payload = (codec.wire_bytes(C) if codec is not None else C * 4)
    return HierarchicalPlan(
        L=L, n=n, n_intra=n_intra, n_inter=ng,
        codec_name=codec.name if codec is not None else None,
        rs_intra_bytes=(n_intra - 1) * unit_a * 4,
        rs_inter_bytes=(ng - 1) * inter_payload,
        ag_intra_bytes=(n_intra - 1) * unit_a * 4,
        ag_inter_bytes=(ng - 1) * inter_payload)


def wire_bytes_per_device(L: int, n: int, n_intra: int,
                          compression=None) -> int:
    """Hierarchical analogue of ``ops.ring.wire_bytes_per_device``: exact
    per-rank bytes of one all-reduce (RS + AG), both phases."""
    return plan_hier(L, n, n_intra, compression).wire_bytes("all_reduce")


# ---------------------------------------------------------------------------
# collectives over the stacked ranks
# ---------------------------------------------------------------------------

def _positions(n: int, ni: int, device) -> tuple:
    ranks = torch.arange(n, device=device)
    return ranks, ranks // ni, ranks % ni


def _verdict(chk) -> torch.Tensor:
    return _integrity.conservation_ok(chk[0], chk[1])


def hier_reduce_scatter(x: torch.Tensor, n_intra: int, *,
                        compression=None,
                        slice_elems: Optional[int] = None,
                        integrity: bool = False):
    """Two-stage ring reduce-scatter of the ranks' flat vectors: raw f32
    over the fast intra hop, the codec ring over the slow inter hop.

    x: [n, L] with L % n == 0.  Returns [n, L // n]: rank d's fully reduced
    chunk d.  ``integrity=True`` checksums both phases' payloads (the raw
    f32 intra words and the encoded inter frames) on both sides of every
    hop, on one message counter spanning both phases (intra hop s is
    message s, inter hop s slice k is (ni-1) + s*stride + k), and returns
    ``(owned, wire_ok)``."""
    ni = int(n_intra)
    n, L = x.shape
    ng = check_factorization(n, ni)
    if L % n:
        raise ValueError(f"need flat length divisible by {n}, got "
                         f"{tuple(x.shape)}")
    codec = as_codec(compression, L // n, x.device)
    if n == 1:
        return (x, torch.tensor(True, device=x.device)) if integrity else x
    C = L // n
    x = ring_ops._tap(x, "ring_hier.reduce_scatter")
    chk = _integrity.zero_carry(n, x.device) if integrity else None
    stride_b = ring_ops._send_n_messages(codec, C, slice_elems)
    prog = _opstream.hier_program(n, ni, s_inter=stride_b)
    ranks, g, j = _positions(n, ni, x.device)

    def hop(send, cdc, phase, s, slc=None):
        nonlocal chk
        if chk is None:
            return ring_ops._send(send, cdc, slc, perm=phase.perm)
        recv, chk = ring_ops._send(send, cdc, slc, chk, phase.msg(s),
                                   perm=phase.perm)
        return recv

    # phase A: intra ring over units[j'] = concat_g'(chunk g'*ni + j'), f32
    units = (x.reshape(n, ng, ni, C).transpose(1, 2)
             .reshape(n, ni, ng * C).clone())
    for s in range(prog.rs_intra.hops):
        recv = hop(units[ranks, (j - s - 1) % ni], None, prog.rs_intra, s)
        dst = (j - s - 2) % ni
        units[ranks, dst] = units[ranks, dst] + recv
    # own[d, q] = sum over rank d's group of chunk q*ni + j
    own = units[ranks, j].reshape(n, ng, C)
    del units
    # phase B: inter ring over the ng group-partial chunks, codec wire
    for s in range(prog.rs_inter.hops):
        recv = hop(own[ranks, (g - s - 1) % ng], codec, prog.rs_inter, s,
                   slice_elems)
        dst = (g - s - 2) % ng
        own[ranks, dst] = own[ranks, dst] + recv
    owned = own[ranks, g]          # chunk g*ni + j == the rank's index
    return (owned, _verdict(chk)) if integrity else owned


def hier_all_gather(owned: torch.Tensor, n_intra: int, *,
                    compression=None, integrity: bool = False):
    """Two-stage ring all-gather: the codec inter gather first (each chunk
    crosses the slow boundary once, encoded at its first send and
    forwarded verbatim, so every replica is bitwise equal), then the raw
    intra gather.  owned: [n, C], rank d contributing chunk d; returns
    [n, n * C] in natural chunk order (with ``integrity=True``:
    ``(gathered, wire_ok)``, inter hop s message s, intra hop s message
    (ng-1) + s of the gather's carry)."""
    ni = int(n_intra)
    n, C = owned.shape
    ng = check_factorization(n, ni)
    codec = as_codec(compression, C, owned.device)
    owned = ring_ops._tap(owned, "ring_hier.all_gather")
    if n == 1:
        out1 = owned if codec is None else codec.roundtrip(
            owned.reshape(-1)).reshape(1, C).to(owned.dtype)
        return (out1, torch.tensor(True, device=owned.device)) \
            if integrity else out1
    chk = _integrity.zero_carry(n, owned.device) if integrity else None
    frame = _integrity.row_checksums
    prog = _opstream.hier_program(n, ni)
    ranks, g, j = _positions(n, ni, owned.device)

    def forward(pay, phase, s):
        nonlocal chk
        w = _integrity.hop_weight(phase.msg(s))
        chk = ring_ops._checked(chk, w, frame, pay, 0)
        pay = ring_ops._tap_wire(tuple(ring_ops._hop(p, phase.perm)
                                       for p in pay), "ring.wire")
        chk = ring_ops._checked(chk, w, frame, pay, 1)
        return pay

    # phase B': inter all-gather of the owned chunk across groups
    blocks = torch.zeros((n, ng, C), dtype=owned.dtype, device=owned.device)
    if ng > 1 and codec is not None:
        ring_ops.check_whole_units(codec, C)
        pay = tuple(p.reshape(n, -1)
                    for p in codec.encode(owned.reshape(-1)))

        def landed(p):
            return codec.decode(tuple(q.reshape(-1) for q in p), n * C,
                                owned.dtype).reshape(n, C)
    else:
        # raw frames; with ng == 1 no slow boundary is crossed, so nothing
        # is quantized (the raw intra hops keep the replicas identical)
        pay = (owned,)

        def landed(p):
            return p[0]
    # the contributor stores the bytes it sends: every replica sees
    # wire-identical values for every chunk
    blocks[ranks, g] = landed(pay)
    for s in range(prog.ag_inter.hops):
        pay = forward(pay, prog.ag_inter, s)
        blocks[ranks, (g - s - 1) % ng] = landed(pay)
    # member j now holds blocks[q] = chunk q*ni + j for every group q

    # phase A': raw intra all-gather of the [ng * C] block
    pay = (blocks.reshape(n, ng * C),)
    out = torch.empty((n, ni, ng * C), dtype=owned.dtype,
                      device=owned.device)
    out[ranks, j] = pay[0]
    for s in range(prog.ag_intra.hops):
        pay = forward(pay, prog.ag_intra, s)
        out[ranks, (j - s - 1) % ni] = pay[0]
    # out[d, p] = blocks of member p = chunks {q*ni + p}; natural order
    full = out.reshape(n, ni, ng, C).transpose(1, 2).reshape(n, n * C)
    return (full, _verdict(chk)) if integrity else full


def hier_all_reduce(x: torch.Tensor, n_intra: int, *, compression=None,
                    slice_elems: Optional[int] = None,
                    integrity: bool = False):
    """Full hierarchical all-reduce (sum) = two-stage RS + two-stage AG.
    With ``integrity=True`` returns ``(reduced, wire_ok)``, the AND of
    both collectives' verdicts."""
    if not integrity:
        return hier_all_gather(
            hier_reduce_scatter(x, n_intra, compression=compression,
                                slice_elems=slice_elems),
            n_intra, compression=compression)
    owned, ok_rs = hier_reduce_scatter(x, n_intra, compression=compression,
                                       slice_elems=slice_elems,
                                       integrity=True)
    full, ok_ag = hier_all_gather(owned, n_intra, compression=compression,
                                  integrity=True)
    return full, ok_rs & ok_ag
