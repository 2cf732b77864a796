"""Live mesh resharding: recover from a shrink or a grow by moving the live
state between rank counts instead of restoring a checkpoint — the port of
the JAX package's ``parallel/reshard.py``.

What moves, and how:

  flat master / moment shards   Every ZeRO-1 (and ZeRO-3) leaf is one flat
      f32 vector stacked as ``[n, C]`` rank rows: ``live`` model elements
      then a zero tail that depends on the rank count.  The live range does
      not, so a rank-count change is exactly an array redistribution: cut
      [0, live) at every source-chunk and target-chunk boundary; each
      segment has one source owner and one target owner (the intersection
      table, ``verify.opstream.reshard_segments``).  A segment whose owner
      changes is one copy from its source row to its target row through
      the wire hook (``ops.ring.tap_wire_array`` at ``"reshard.wire"``):
      the port's ranks are rows of one card, so the row copy is the
      loopback wire, as the rings' hops are.  A segment that stays put is
      a local copy, neither counted nor checksummed.  ``WIRE`` counts the
      bytes the wire copies: they equal ``plan.wire_bytes()`` (the JAX
      package's static rule J8, held here at run time).

  grow                          The source is first re-laid onto the
      ``n_union`` rows of the union layout (``verify.opstream.
      union_layout``), segment by segment; the owner-changing bytes of
      that seeding are ``plan.seed_bytes()``, counted in
      ``WIRE["seed_bytes"]`` and never in the wire's.

  EF codec residuals            ``codec_state`` is per-rank state (the
      gradient mass rank i's local quantization dropped), not a shard of
      one vector, so it moves by ownership: old rank i's live residual is
      added into new rank ``i * n_tgt // n_src``'s in ascending i
      (``golden_redistribute_residual`` is the bit-exact numpy twin).  A
      checkpoint restore re-zeros it; the reshard keeps it bit for bit.

With ``donate`` the source leaves' storage is released once the move has
run (what JAX's ``donate_argnums`` does), so a move holds about one
state's footprint beside the target's.  With ``integrity`` every wire
segment is checksummed on its source row before the copies and on its
target row after the wire tap (``ops.integrity.row_checksums``: one
launch a side on a card, the message weights from
``verify.opstream.reshard_msg_bases``); a tripped verdict raises
``runtime.chaos.WireIntegrityError`` before the state is handed over.

``reshard_state(src_trainer, tgt_trainer, state)`` is the call the elastic
loop's first recovery tier makes.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops import fused_update
from ..ops import integrity as integrity_lib
from ..ops import ring as ring_ops
from ..verify import opstream as _opstream

__all__ = [
    "Transfer", "FlatPlan", "ResidualPlan", "ReshardPlan", "WIRE",
    "intersection_table", "residual_owners", "make_plan", "plan_for",
    "golden_redistribute_residual", "transfer", "reshard_state",
    "pack_state_leaves", "split_state_leaves", "reset_wire_counters",
]


def pack_state_leaves(w_own: Any, opt_state: Optional[Dict[str, Any]]
                      ) -> Dict[str, Any]:
    """The flat-leaf naming of a live move (``w_own`` + sorted
    ``opt.<k>`` moments), shared by every trainer's ``reshard_leaves``."""
    d = {"w_own": w_own}
    d.update({f"opt.{k}": v for k, v in sorted((opt_state or {}).items())})
    return d


def split_state_leaves(leaves: Dict[str, Any]
                       ) -> Tuple[Any, Dict[str, Any]]:
    """Inverse of ``pack_state_leaves``: (w_own, opt_state)."""
    return leaves["w_own"], {k[len("opt."):]: v for k, v in leaves.items()
                             if k.startswith("opt.")}


# one intersection-table segment, and the table itself: the IR's
Transfer = _opstream.Seg
intersection_table = _opstream.reshard_segments
residual_owners = _opstream.reshard_owners


class FlatPlan(NamedTuple):
    """Redistribution plan of one flat-vector layout (every master and
    moment leaf of a state shares it).  ``chunk_src`` is the per-rank
    chunk of the union layout the move reads (the trainer's chunk for a
    shrink); ``chunk_tgt`` the target trainer's."""

    live: int
    n_src: int
    n_tgt: int
    n_union: int
    chunk_src: int
    chunk_tgt: int
    padded_src: int          # source trainer layout length (n_src chunks)
    padded_tgt: int          # target trainer layout length (n_tgt chunks)
    seed_len: int            # union input layout length (n_union chunks)
    table: Tuple[Transfer, ...]

    @property
    def wire_elems(self) -> int:
        """Elements that change owner: what the wire copies move."""
        return sum(t.length for t in self.table if t.src != t.dst)

    @property
    def local_elems(self) -> int:
        return self.live - self.wire_elems

    def seed_table(self) -> Tuple[Transfer, ...]:
        """The grow seeding's segments (source layout against the union
        layout); empty for a shrink, whose union is the source layout."""
        if self.n_union == self.n_src:
            return ()
        return intersection_table(self.live, self.padded_src // self.n_src,
                                  self.chunk_src)

    @property
    def seed_elems(self) -> int:
        """Elements the grow seeding moves between rows before the move,
        counted with the same intersection rule (0 for a shrink)."""
        return sum(t.length for t in self.seed_table() if t.src != t.dst)


class ResidualPlan(NamedTuple):
    """Redistribution plan of the per-rank error-feedback residuals: old
    rank i's [pad_src] residual (live prefix) is added into new rank
    ``owners[i]``'s [pad_tgt] residual, in ascending i."""

    live: int
    n_src: int
    n_tgt: int
    n_union: int
    pad_src: int
    pad_tgt: int
    owners: Tuple[int, ...]

    @property
    def wire_elems(self) -> int:
        return self.live * sum(1 for i, o in enumerate(self.owners)
                               if i != o)


class ReshardPlan(NamedTuple):
    """A rank-count change: one FlatPlan shared by ``n_flat_leaves`` state
    vectors (master + optimizer moments) and an optional ResidualPlan."""

    flat: FlatPlan
    n_flat_leaves: int
    residual: Optional[ResidualPlan]

    def wire_bytes(self, itemsize: int = 4) -> int:
        """Exactly the bytes that change owner per the intersection table
        (and the residuals that change rank)."""
        n = self.n_flat_leaves * self.flat.wire_elems
        if self.residual is not None:
            n += self.residual.wire_elems
        return n * itemsize

    def seed_bytes(self, itemsize: int = 4) -> int:
        """Bytes the grow seeding moves before the wire copies (0 for a
        shrink), reported apart from ``wire_bytes``."""
        return self.n_flat_leaves * self.flat.seed_elems * itemsize

    def describe(self) -> Dict[str, Any]:
        f = self.flat
        return {
            "n_src": f.n_src, "n_tgt": f.n_tgt, "live_elems": f.live,
            "n_flat_leaves": self.n_flat_leaves,
            "transfers": len(f.table),
            "wire_bytes": self.wire_bytes(),
            "seed_bytes": self.seed_bytes(),
            "residual_moved": (0 if self.residual is None
                               else self.residual.wire_elems // max(
                                   self.residual.live, 1)),
        }


def make_plan(live: int, n_src: int, padded_src: int, n_tgt: int,
              padded_tgt: int, *, n_flat_leaves: int,
              residual: bool = False) -> ReshardPlan:
    """Plan a rank-count change of a state of ``n_flat_leaves`` flat
    vectors ([padded_src] over n_src ranks -> [padded_tgt] over n_tgt)
    and, with ``residual``, per-rank residuals ([padded_src] each ->
    [padded_tgt] each)."""
    assert 0 < live <= min(padded_src, padded_tgt)
    assert n_flat_leaves >= 1
    chunk_src, chunk_tgt, n_union, seed_len = _opstream.union_layout(
        live, n_src, padded_src, n_tgt, padded_tgt)
    flat = FlatPlan(live=live, n_src=n_src, n_tgt=n_tgt, n_union=n_union,
                    chunk_src=chunk_src, chunk_tgt=chunk_tgt,
                    padded_src=padded_src, padded_tgt=padded_tgt,
                    seed_len=seed_len,
                    table=intersection_table(live, chunk_src, chunk_tgt))
    rp = None
    if residual:
        # each rank's residual is a whole padded-model vector, not a chunk
        rp = ResidualPlan(live=live, n_src=n_src, n_tgt=n_tgt,
                          n_union=n_union,
                          pad_src=padded_src, pad_tgt=padded_tgt,
                          owners=residual_owners(n_src, n_tgt))
    return ReshardPlan(flat=flat, n_flat_leaves=n_flat_leaves, residual=rp)


def golden_redistribute_residual(res: np.ndarray, live: int, n_tgt: int,
                                 pad_tgt: int) -> np.ndarray:
    """Bit-exact numpy twin of the residual move: ``res[n_src, pad_src]``
    -> ``[n_tgt, pad_tgt]``, f32 sums in ascending-source order."""
    res = np.asarray(res, np.float32)
    n_src = res.shape[0]
    out = np.zeros((n_tgt, pad_tgt), np.float32)
    for i, owner in enumerate(residual_owners(n_src, n_tgt)):
        out[owner, :live] = out[owner, :live] + res[i, :live]
    return out


# ---------------------------------------------------------------------------
# planning a trainer pair
# ---------------------------------------------------------------------------

def _wire_format(trainer: Any) -> Tuple[Any, ...]:
    """Everything that parameterizes the trainer's wire format: codec name
    and options, the legacy BFPConfig, error feedback (an int8+EF source
    onto an int8 target would move a residual nothing consumes)."""
    coll = trainer.cfg.collective
    return (coll.codec, tuple(coll.codec_opts or ()), coll.compression,
            bool(getattr(trainer, "_ef", False)))


def plan_for(src_trainer: Any, tgt_trainer: Any) -> ReshardPlan:
    """The ReshardPlan of a src->tgt trainer pair.  The source must know
    its layout (it trained); the target derives its own from the source's
    (``fused_update.params_like_from_meta``)."""
    if type(src_trainer) is not type(tgt_trainer):
        raise ValueError(
            f"reshard moves state between mesh SHAPES, not trainer kinds: "
            f"{type(src_trainer).__name__} -> "
            f"{type(tgt_trainer).__name__}")
    if getattr(src_trainer, "takes_sp", False):
        raise ValueError(
            "reshard moves the dp (or fsdp) axis of DPTrainer and "
            "FSDPTrainer states; ShardedTrainer has no live reshard, as in "
            "the JAX package")
    if _wire_format(src_trainer) != _wire_format(tgt_trainer):
        raise ValueError(
            "reshard keeps the wire format fixed across the move "
            f"(codec/opts/EF {_wire_format(src_trainer)} -> "
            f"{_wire_format(tgt_trainer)}); change codecs via "
            "checkpoint-restore")
    src_meta = src_trainer._meta
    assert src_meta is not None, "source trainer has no layout (init first)"
    if tgt_trainer._meta is None:
        tgt_trainer._ensure_meta(fused_update.params_like_from_meta(src_meta))
    tgt_meta = tgt_trainer._meta
    live = sum(src_meta.sizes)
    if live != sum(tgt_meta.sizes):
        raise ValueError(
            f"layout mismatch: {live} live elements at the source vs "
            f"{sum(tgt_meta.sizes)} at the target — different models")
    from ..utils.config import OptimizerSpec
    n_flat = 1 + len(OptimizerSpec.from_optimizer(
        src_trainer.cfg.optimizer).state_keys)
    return make_plan(live, src_trainer.n, src_meta.padded_len,
                     tgt_trainer.n, tgt_meta.padded_len,
                     n_flat_leaves=n_flat,
                     residual=bool(getattr(src_trainer, "_ef", False)))


# ---------------------------------------------------------------------------
# the move on one card: row copies as the wire
# ---------------------------------------------------------------------------

# bytes the wire copies moved and the grow seeding moved, and the wire
# copies made, since the last reset (the run-time check of wire_bytes)
WIRE: Dict[str, int] = {"bytes": 0, "seed_bytes": 0, "copies": 0}
WIRE_POINT = "reshard.wire"


def reset_wire_counters() -> None:
    for k in WIRE:
        WIRE[k] = 0


def _wire_copy(dst: torch.Tensor, src: torch.Tensor) -> None:
    """One owner-changing segment over the wire: the copy into the target
    row, counted, then the wire tap on what landed."""
    dst.copy_(src)
    WIRE["bytes"] += src.numel() * src.element_size()
    WIRE["copies"] += 1
    got = ring_ops.tap_wire_array(dst, WIRE_POINT)
    if got is not dst:
        dst.copy_(got)


def _rows(v: torch.Tensor, n: int) -> torch.Tensor:
    return v.reshape(n, -1)


def _seed(rows: torch.Tensor, fp: FlatPlan) -> torch.Tensor:
    """The source rows re-laid onto the union layout ([n_union,
    chunk_src]); a shrink's union is the source itself."""
    table = fp.seed_table()
    if not table:
        return rows
    union = torch.empty((fp.n_union, fp.chunk_src), dtype=rows.dtype,
                        device=rows.device)
    union.view(-1)[fp.live:].zero_()
    for t in table:
        union[t.dst, t.dst_off:t.dst_off + t.length].copy_(
            rows[t.src, t.src_off:t.src_off + t.length])
        if t.src != t.dst:
            WIRE["seed_bytes"] += t.length * rows.element_size()
    return union


class _Ledger:
    """The integrity carry of one move: the wire messages' source views
    (checksummed before the copies) and landed views, with their odd
    weights."""

    def __init__(self) -> None:
        self.sent: List[torch.Tensor] = []
        self.landed: List[torch.Tensor] = []
        self.weights: List[int] = []

    def verdict(self) -> bool:
        if not self.weights:
            return True
        recv = integrity_lib.row_checksums(
            [v.reshape(1, -1) for v in self.landed], self.weights)
        return bool(integrity_lib.conservation_ok(self.send, recv))

    def sign(self) -> None:
        """The send side's checksums, before any copy runs."""
        self.send = (integrity_lib.row_checksums(
            [v.reshape(1, -1) for v in self.sent], self.weights)
            if self.weights else None)


def transfer(plan: ReshardPlan, leaves: List[torch.Tensor],
             resid: Optional[torch.Tensor] = None, *,
             integrity: bool = False, donate: bool = False
             ) -> Tuple[List[torch.Tensor], Optional[torch.Tensor], bool]:
    """Run the plan: ``leaves`` (``[n_src, C_src]`` rows or ``[padded_src]``
    flat, in ``pack_state_leaves`` order) and the residual (``[n_src,
    pad_src]``) -> ``(target leaves [n_tgt, chunk_tgt], target residual
    [n_tgt, pad_tgt] or None, wire_ok)``.  ``wire_ok`` is True without
    ``integrity``.  With ``donate`` the sources' storage is released after
    the move."""
    fp = plan.flat
    assert len(leaves) == plan.n_flat_leaves, (len(leaves),
                                              plan.n_flat_leaves)
    bases, resid_base = _opstream.reshard_msg_bases(len(fp.table),
                                                    plan.n_flat_leaves)
    srcs = [_seed(_rows(v, fp.n_src), fp) for v in leaves]
    ledger = _Ledger() if integrity else None
    moves: List[Tuple[torch.Tensor, torch.Tensor, bool]] = []
    outs = []
    for li, rows in enumerate(srcs):
        out = torch.empty((fp.n_tgt, fp.chunk_tgt), dtype=rows.dtype,
                          device=rows.device)
        out.view(-1)[fp.live:].zero_()
        for act in _opstream.reshard_leaf_actions(fp.table, bases[li]):
            s = rows[act.src, act.src_off:act.src_off + act.length]
            d = out[act.dst, act.dst_off:act.dst_off + act.length]
            wire = act.kind == "xfer"
            moves.append((d, s, wire))
            if wire and ledger is not None:
                ledger.sent.append(s)
                ledger.landed.append(d)
                ledger.weights.append(integrity_lib.hop_weight(act.msg))
        outs.append(out)
    rp = plan.residual
    resid_moves = []
    if rp is not None:
        assert resid is not None, "EF codec with no residual state"
        resid = _rows(resid, rp.n_src)
        for ra in _opstream.reshard_residual_actions(rp.owners, resid_base):
            s = resid[ra.src, :rp.live]
            recv = s if ra.kind == "keep" else torch.empty_like(s)
            resid_moves.append((ra, s, recv))
            if ra.kind == "xfer" and ledger is not None:
                ledger.sent.append(s)
                ledger.landed.append(recv)
                ledger.weights.append(integrity_lib.hop_weight(ra.msg))
    if ledger is not None:
        ledger.sign()
    for d, s, wire in moves:
        if wire:
            _wire_copy(d, s)
        else:
            d.copy_(s)
    resid_out = None
    if rp is not None:
        resid_out = torch.zeros((rp.n_tgt, rp.pad_tgt), dtype=resid.dtype,
                                device=resid.device)
        for ra, s, recv in resid_moves:
            if ra.kind == "xfer":
                _wire_copy(recv, s)
            resid_out[ra.dst, :rp.live].add_(recv)
    ok = True if ledger is None else ledger.verdict()
    del moves, resid_moves, srcs, ledger
    if donate:
        for v in list(leaves) + ([resid] if resid is not None else []):
            st = v.untyped_storage()
            if st.resizable():       # storage numpy lent stays the caller's
                st.resize_(0)
    return outs, resid_out, ok


def reshard_state(src_trainer: Any, tgt_trainer: Any, state: Any, *,
                  events: Any = None, donate: bool = True,
                  integrity: Optional[bool] = None) -> Any:
    """Move a live TrainState / FSDPState from ``src_trainer``'s rank count
    to ``tgt_trainer``'s.  Returns the target trainer's state, step kept,
    masters and moments value-exact (the live elements only ever move),
    the error-feedback residual redistributed (not re-zeroed).  With
    ``donate`` the source leaves are released.

    ``integrity`` (None: the source trainer's ``collective.
    integrity_check``) checksums every wire segment on both sides; a
    tripped verdict raises ``runtime.chaos.WireIntegrityError`` before
    the landed state reaches the target trainer (the elastic ladder then
    falls through to the checkpoint-restore tier)."""
    if integrity is None:
        integrity = bool(getattr(src_trainer.cfg.collective,
                                 "integrity_check", False))
    plan = plan_for(src_trainer, tgt_trainer)
    fp = plan.flat
    leaves = src_trainer.reshard_leaves(state)
    names = list(leaves)
    assert len(names) == plan.n_flat_leaves, (names, plan.n_flat_leaves)
    resid = None
    if plan.residual is not None:
        resid = state.codec_state
        assert resid is not None, "EF codec with no residual state"
    step = int(state.step)
    del state
    if events is not None:
        with events.span("reshard.transfer", **plan.describe()):
            outs, codec_state, ok = transfer(
                plan, [leaves[k] for k in names], resid,
                integrity=bool(integrity), donate=donate)
            if outs and outs[0].is_cuda:
                torch.cuda.synchronize(outs[0].device)
    else:
        outs, codec_state, ok = transfer(
            plan, [leaves[k] for k in names], resid,
            integrity=bool(integrity), donate=donate)
    del leaves, resid
    if not ok:
        from ..runtime.chaos import WireIntegrityError
        raise WireIntegrityError(
            "reshard transfer wire checksum tripped: a segment landed with "
            "different bytes than were sent "
            f"({fp.n_src}->{fp.n_tgt}); refusing the landed state — fall "
            "through to checkpoint restore")
    landed = dict(zip(names, outs))
    if codec_state is None and getattr(tgt_trainer, "_ef", False):
        codec_state = tgt_trainer._init_codec_state()
    new_state = tgt_trainer.state_from_reshard(landed, step, codec_state)
    if events is not None:
        events.instant("reshard.done", n_src=fp.n_src, n_tgt=fp.n_tgt,
                       wire_bytes=plan.wire_bytes(),
                       seed_bytes=plan.seed_bytes())
    return new_state
