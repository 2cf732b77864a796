"""The collective autotuner — the port of the JAX package's
``tune/autotune.py``.  ``CollectiveConfig(codec="auto")`` picks the codec,
the pipeline depth, the bucket size and the topology (flat or
hierarchical) by argmin over an enumerated candidate grid, scored with
the ``ops.ring_cost`` roofline under the rates of ``tune.calibration``;
resolved once, in Python, at trainer construction, and the plan kept in
``obs_static_metrics()``.

Scoring (seconds, one training step's all-reduce of an E-element f32
payload over n ranks; JAX's model, the same arithmetic):

  stream   flat: max(wire_bytes / W_inter, raw_bytes (1/enc + 1/dec)) over
           the 2 (n - 1) / n E elements a rank moves (``ring_cost.
           hop_cost``: encode and decode share the ALUs, so they add);
           hier: the codec-free fast hop at W_intra plus that max on the
           slow hop's elements (``ring_cost.hier_phase_bytes``).
  overhead n_buckets (dispatch_s + hops rtt_s / D + (D - 1) slice_bytes /
           W_inter), codec-independent, so the codec argmin is monotone
           in the link rate.
  exposed_s    = overhead + stream * (E_last / E): every bucket but the
                 last overlaps the backward; the argmin's objective.
  collective_s = overhead + stream: the whole collective.

Candidates are enumerated in sorted order and scores are pure arithmetic
over the calibration: the same rates give the same plan.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .calibration import Calibration, load_calibration
from ..ops import ring_cost

# candidate grids (sorted; determinism depends on stable ordering)
DEPTH_CANDIDATES = (1, 2, 4, 8)
BUCKET_CANDIDATES = (1 << 18, 1 << 20, 1 << 22, 4 * 1024 * 1024)
# payload-class split of the codec rates (resident vs streaming)
VMEM_CLASS_MAX_BYTES = 4 * (1 << 20)


@dataclass(frozen=True)
class Candidate:
    codec: Optional[str]
    pipeline_depth: int
    bucket_elems: int
    topology: str               # "flat" | "hier"
    intra_size: int             # 1 for flat

    def key(self) -> tuple:
        """Deterministic sort / tie-break key (the uncompressed candidate
        first, then topology and the smaller schedule knobs)."""
        return (self.codec or "", self.topology, self.intra_size,
                self.pipeline_depth, self.bucket_elems)


@dataclass(frozen=True)
class TunedPlan:
    """The resolved choice and what it takes to audit it."""
    candidate: Candidate
    modeled_exposed_s: float
    modeled_collective_s: float
    wire_bytes_per_device: int      # exact, one all-reduce of the payload
    raw_bytes_per_device: int
    payload_elems: int
    n: int
    payload_class: str              # "vmem" | "streaming"
    calibrated: bool
    dryrun: bool
    n_candidates: int
    calibration: Dict[str, Any]     # provenance record

    def describe(self) -> Dict[str, Any]:
        c = self.candidate
        return {
            "codec": c.codec or "none",
            "pipeline_depth": c.pipeline_depth,
            "bucket_elems": c.bucket_elems,
            "topology": c.topology,
            "intra_size": c.intra_size,
            "payload_elems": self.payload_elems,
            "payload_class": self.payload_class,
            "n_devices": self.n,
            "modeled_exposed_ms": round(self.modeled_exposed_s * 1e3, 4),
            "modeled_collective_ms":
                round(self.modeled_collective_s * 1e3, 4),
            "wire_bytes_per_device": self.wire_bytes_per_device,
            "raw_bytes_per_device": self.raw_bytes_per_device,
            "calibrated": self.calibrated,
            "dryrun": self.dryrun,
            "n_candidates": self.n_candidates,
            "calibration": self.calibration,
        }


def needs_autotune(coll: Any) -> bool:
    """Does this CollectiveConfig defer its choices to the tuner?"""
    return getattr(coll, "codec", None) == "auto"


def payload_class(payload_elems: int) -> str:
    return ("vmem" if payload_elems * 4 <= VMEM_CLASS_MAX_BYTES
            else "streaming")


def _codec_obj(name: Optional[str]) -> Any:
    if name is None:
        return None
    from ..compress import get_codec
    return get_codec(name)


def _hier_intra_candidates(n: int, intra_size: int,
                           topology: Optional[str]) -> List[int]:
    """Admissible fast-hop group sizes: a declared ``intra_size`` > 1
    dividing n as it is (n itself only when "hier" is pinned); with
    ``intra_size`` 0 and "hier" pinned every proper divisor of n."""
    if topology not in (None, "hier"):
        return []
    if intra_size > 1 and n % intra_size == 0:
        if intra_size < n or topology == "hier":
            return [intra_size]
        return []
    if intra_size == 0 and topology == "hier":
        return [d for d in range(2, n) if n % d == 0]
    return []


def enumerate_candidates(n: int, intra_size: int = 0,
                         codecs: Optional[Sequence[Optional[str]]] = None,
                         topology: Optional[str] = None,
                         depths: Optional[Sequence[int]] = None
                         ) -> List[Candidate]:
    """The whole grid the tuner argmins over: every registered codec and
    none, the flat topology and the admissible hierarchical ones
    (``_hier_intra_candidates``; ``topology`` pins one), every depth of
    ``depths`` (the trainers pass (1,)) and bucket size."""
    if codecs is None:
        from ..compress import available_codecs
        codecs = (None,) + tuple(available_codecs())
    topologies: List[Tuple[str, int]] = []
    if topology in (None, "flat"):
        topologies.append(("flat", 1))
    topologies += [("hier", ni)
                   for ni in _hier_intra_candidates(n, intra_size,
                                                    topology)]
    if not topologies:
        raise ValueError(
            f"no admissible topology: topology={topology!r} with "
            f"intra_size={intra_size} over n={n} (hier needs "
            "intra_size > 1 dividing n, or intra_size=0 with "
            "topology='hier' to delegate the factorization)")
    out = []
    for codec in sorted(codecs, key=lambda c: c or ""):
        for topo, ni in topologies:
            for depth in (depths or DEPTH_CANDIDATES):
                for bucket in BUCKET_CANDIDATES:
                    out.append(Candidate(codec, depth, bucket, topo, ni))
    return sorted(out, key=Candidate.key)


def score_candidate(payload_elems: int, n: int, cand: Candidate,
                    calib: Calibration,
                    slice_elems: int = 8192) -> Dict[str, Any]:
    """Modeled seconds of one training step's all-reduce (RS + AG) of an
    [payload_elems] f32 payload under ``cand`` (the module docstring's
    formula)."""
    E = int(payload_elems)
    klass = payload_class(E)
    enc, dec, rates_measured = calib.codec_stage_rates(cand.codec, klass)
    codec = _codec_obj(cand.codec)

    def wire_bytes(elems: int) -> int:
        if codec is None:
            return elems * 4
        pe = codec.pad_elems
        return codec.wire_bytes(elems + (-elems) % pe)

    if cand.topology == "hier":
        ph = ring_cost.hier_phase_bytes(E, n, cand.intra_size, wire_bytes)
        intra = ring_cost.hop_cost(ph["intra_bytes"], ph["intra_bytes"],
                                   calib.intra_gbps)
        inter = ring_cost.hop_cost(ph["inter_raw_bytes"],
                                   ph["inter_wire_bytes"],
                                   calib.inter_gbps, enc, dec)
        t_stream = intra["t_s"] + inter["t_s"]
        hops = ph["hops"]
        wire_total = ph["intra_bytes"] + ph["inter_wire_bytes"]
        raw_total = ph["intra_bytes"] + ph["inter_raw_bytes"]
        stream_detail = {"intra": intra, "inter": inter}
    else:
        e_wire = 2 * (n - 1) * (E // n)
        raw_total = e_wire * 4
        wire_total = wire_bytes(e_wire)
        hop = ring_cost.hop_cost(raw_total, wire_total,
                                 calib.inter_gbps, enc, dec)
        t_stream = hop["t_s"]
        hops = 2 * (n - 1)
        stream_detail = {"flat": hop}

    nb = max(1, math.ceil(E / cand.bucket_elems))
    e_last = E - (nb - 1) * cand.bucket_elems
    tail_frac = e_last / E if E else 1.0
    D = cand.pipeline_depth
    t_overhead = nb * (calib.dispatch_s
                       + hops * calib.rtt_s / D
                       + (D - 1) * slice_elems * 4
                       / (calib.inter_gbps * 1e9))
    return {
        "exposed_s": t_overhead + t_stream * tail_frac,
        "collective_s": t_overhead + t_stream,
        "stream_s": t_stream,
        "overhead_s": t_overhead,
        "n_buckets": nb,
        "last_bucket_elems": e_last,
        "wire_bytes_per_device": int(wire_total),
        "raw_bytes_per_device": int(raw_total),
        "payload_class": klass,
        "rates_measured": rates_measured,
        "stream_detail": stream_detail,
    }


def tune(payload_elems: int, n: int, *, intra_size: int = 0,
         topology: Optional[str] = None,
         codecs: Optional[Sequence[Optional[str]]] = None,
         calibration: Optional[Calibration] = None,
         slice_elems: int = 8192,
         depths: Optional[Sequence[int]] = None) -> TunedPlan:
    """The argmin over the grid: ``tune_topk(..., k=1)[0]``."""
    return tune_topk(payload_elems, n, 1, intra_size=intra_size,
                     topology=topology, codecs=codecs,
                     calibration=calibration, slice_elems=slice_elems,
                     depths=depths)[0]


def tune_topk(payload_elems: int, n: int, k: int = 3, *,
              intra_size: int = 0, topology: Optional[str] = None,
              codecs: Optional[Sequence[Optional[str]]] = None,
              calibration: Optional[Calibration] = None,
              slice_elems: int = 8192,
              depths: Optional[Sequence[int]] = None) -> List[TunedPlan]:
    """The argmin and the best runner-ups of distinct (codec, topology,
    intra_size) groups — the bounded candidate set ``tune.adapt``
    switches between: within a group the best schedule, the groups by
    score, ties on the candidate key.  Element 0 is ``tune``'s plan."""
    assert k >= 1, k
    calib = calibration if calibration is not None else load_calibration()
    cands = enumerate_candidates(n, intra_size, codecs, topology, depths)
    best_by_group: Dict[Tuple[str, str, int],
                        Tuple[float, Candidate, Dict[str, Any]]] = {}
    for cand in cands:
        s = score_candidate(payload_elems, n, cand, calib, slice_elems)
        group = (cand.codec or "", cand.topology, cand.intra_size)
        cur = best_by_group.get(group)
        if cur is None or s["exposed_s"] < cur[0]:
            best_by_group[group] = (s["exposed_s"], cand, s)
    ranked = sorted(best_by_group.values(),
                    key=lambda t: (t[0], t[1].key()))
    return [TunedPlan(
        candidate=cand,
        modeled_exposed_s=s["exposed_s"],
        modeled_collective_s=s["collective_s"],
        wire_bytes_per_device=s["wire_bytes_per_device"],
        raw_bytes_per_device=s["raw_bytes_per_device"],
        payload_elems=int(payload_elems), n=int(n),
        payload_class=s["payload_class"],
        calibrated=calib.calibrated,
        dryrun=calib.dryrun,
        n_candidates=len(cands),
        calibration=calib.describe()) for _, cand, s in ranked[:k]]


def rescore(plan: TunedPlan, payload_elems: int,
            calibration: Optional[Calibration] = None,
            slice_elems: int = 8192) -> TunedPlan:
    """The chosen candidate re-priced at the padded payload length the
    collective moves (known only once the codec is resolved), under the
    calibration and slice plan ``tune`` scored with."""
    calib = calibration if calibration is not None else load_calibration()
    s = score_candidate(payload_elems, plan.n, plan.candidate, calib,
                        slice_elems)
    return dataclasses.replace(
        plan,
        modeled_exposed_s=s["exposed_s"],
        modeled_collective_s=s["collective_s"],
        wire_bytes_per_device=s["wire_bytes_per_device"],
        raw_bytes_per_device=s["raw_bytes_per_device"],
        payload_elems=int(payload_elems),
        payload_class=s["payload_class"])


def resolved_config(coll: Any, cand: Candidate) -> Any:
    """The concrete frozen CollectiveConfig a candidate stands for."""
    return dataclasses.replace(
        coll, codec=cand.codec, codec_opts=(),
        pipeline_depth=cand.pipeline_depth,
        bucket_elems=cand.bucket_elems,
        topology=cand.topology,
        intra_size=(cand.intra_size if cand.topology == "hier"
                    else coll.intra_size))


def resolve_collective(coll: Any, n: int, payload_elems: int,
                       calibration: Optional[Calibration] = None
                       ) -> Tuple[Any, Optional[TunedPlan]]:
    """A ``CollectiveConfig(codec="auto", ...)`` template as the concrete
    config the trainer runs, with its TunedPlan; any other config passes
    through with plan None.  The depth grid is pinned to (1,): the
    separate-op ring ``codec="auto"`` runs has no launch-ahead depth."""
    if not needs_autotune(coll):
        return coll, None
    topology = "hier" if coll.topology == "hier" else None
    plan = tune(payload_elems, n, intra_size=coll.intra_size,
                topology=topology, calibration=calibration,
                slice_elems=coll.slice_elems, depths=(1,))
    return resolved_config(coll, plan.candidate), plan


def payload_elems_of(params_like: Any) -> int:
    """Elements of a parameter tree (tensors, or anything with a shape)."""
    from ..ops.fused_update import tree_leaves
    return sum(math.prod(t.shape) for t in tree_leaves(params_like))


def resolve_train_config(cfg: Any, n: int, params_like: Any,
                         calibration: Optional[Calibration] = None,
                         padded: bool = False
                         ) -> Tuple[Any, Optional[TunedPlan]]:
    """The trainers' one resolution step: the payload from the params
    tree, one calibration for the argmin and the rescore, the collective
    replaced inside the TrainConfig.  With ``padded`` the plan is
    re-priced at the length the resolved collective moves, the payload
    padded to its codec's multiple (``fused_update.pad_multiple``): the
    ZeRO trainers' one flat vector.  ``(new_cfg, plan)``, or ``(cfg,
    None)`` when nothing is deferred."""
    if not needs_autotune(cfg.collective):
        return cfg, None
    calib = calibration if calibration is not None else load_calibration()
    total = payload_elems_of(params_like)
    coll, plan = resolve_collective(cfg.collective, n, total,
                                    calibration=calib)
    if padded:
        from ..ops.fused_update import pad_multiple
        length = total + (-total) % pad_multiple(coll, n)
        if length != plan.payload_elems:
            plan = rescore(plan, length, calibration=calib,
                           slice_elems=coll.slice_elems)
    return dataclasses.replace(cfg, collective=coll), plan
