"""The measured rates the collective tuner scores with — the port of the
JAX package's ``tune/calibration.py``.

The rates ``ops.ring_cost`` is parameterized by: each codec's encode and
decode GB/s (per payload class, "vmem" / "streaming"), the per-direction
link rate of the ring ("inter"), and the fast-hop rate of the
hierarchical ring ("intra").

Source ranking (highest wins): **live** (``tune.adapt.live_calibrate``,
measured at trainer construction on the ranks the job runs on:
``apply_live``) > a banked card measurement > a banked CPU measurement
(``dryrun``) > the documented fallback constants.  A banked file is one
the port wrote itself (``bank_calibration``): ``calibration/cuda_*.json``
under the repository root, stamped with its platform ("cuda" or "cpu"),
the card's name and power limit (``nvidia-smi --query-gpu=name,
power.limit --format=csv,noheader``) and the commit.  The JAX package's
artifacts (``artifacts/``, ``BENCH_r*.json``, ``CODEC_BENCH_r*.json``,
``COLLECTIVE_r*.json``) describe TPU and CPU runs of the reference and
are never read.  With nothing banked the fallback constants stand and
``calibrated`` is False.

Honesty rules, as JAX's: every contributing file is listed with its path,
commit and platform; a rate measured on the CPU is ``dryrun`` (JAX's
flag means "not a TPU"; here it means "not the card"); a component with
no measurement keeps the fallback and says so.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BANK_PATTERN = os.path.join("calibration", "cuda_*.json")

# documented fallback constants (JAX's; used only where nothing measured
# backs a component, which then reads calibrated=False)
FALLBACK_INTER_GBPS = 12.5      # the reference's own 100GbE wire
FALLBACK_INTRA_GBPS = 45.0      # a fast-hop class (DEFAULT_LINK_RATES)
FALLBACK_CODEC_GBPS = 5.0       # conservative codec stage rate
DEFAULT_DISPATCH_S = 50e-6      # per-collective issue cost
DEFAULT_RTT_S = 5e-6            # per-hop launch latency


@dataclass(frozen=True)
class ArtifactRecord:
    """Provenance of one contributing banked file."""
    path: str
    git_sha: Optional[str]
    platform: Optional[str]
    dryrun: bool                 # measured on the CPU, not the card

    def describe(self) -> Dict[str, Any]:
        return {"path": self.path, "git_sha": self.git_sha,
                "platform": self.platform, "dryrun": self.dryrun}


@dataclass(frozen=True)
class CodecRates:
    """Measured stage rates of one codec at one payload class; ``live``
    marks rows measured at startup (``apply_live`` stamps it)."""
    encode_gbps: float
    decode_gbps: float
    source: str
    dryrun: bool
    live: bool = False


@dataclass(frozen=True)
class Calibration:
    """The rate set the tuner scores with.  ``calibrated`` is True when at
    least one component was measured; per-component flags say which."""

    codec_rates: Mapping[str, Mapping[str, CodecRates]] = \
        field(default_factory=dict)      # name -> class -> rates
    inter_gbps: float = FALLBACK_INTER_GBPS
    inter_calibrated: bool = False
    inter_source: str = "fallback constant (FALLBACK_INTER_GBPS)"
    inter_dryrun: bool = False
    inter_live: bool = False
    intra_gbps: float = FALLBACK_INTRA_GBPS
    intra_calibrated: bool = False
    intra_source: str = "fallback constant (FALLBACK_INTRA_GBPS)"
    intra_dryrun: bool = False
    intra_live: bool = False
    dispatch_s: float = DEFAULT_DISPATCH_S
    rtt_s: float = DEFAULT_RTT_S
    artifacts: Tuple[ArtifactRecord, ...] = ()

    @property
    def calibrated(self) -> bool:
        return bool(self.codec_rates) or self.inter_calibrated \
            or self.intra_calibrated

    @property
    def dryrun(self) -> bool:
        """True when every measured component was measured on the CPU (or
        none was measured)."""
        measured = [r.dryrun for by_class in self.codec_rates.values()
                    for r in by_class.values()]
        if self.inter_calibrated:
            measured.append(self.inter_dryrun)
        return all(measured) if measured else True

    def codec_stage_rates(self, name: Optional[str],
                          payload_class: str = "streaming"
                          ) -> Tuple[float, float, bool]:
        """(encode_gbps, decode_gbps, measured) for a codec at a payload
        class; no codec (uncompressed) has no stages (inf, inf)."""
        if name is None:
            return float("inf"), float("inf"), True
        by_class = self.codec_rates.get(name) or {}
        row = by_class.get(payload_class) \
            or next(iter(by_class.values()), None)
        if row is None or row.encode_gbps <= 0 or row.decode_gbps <= 0:
            return FALLBACK_CODEC_GBPS, FALLBACK_CODEC_GBPS, False
        return row.encode_gbps, row.decode_gbps, True

    def describe(self) -> Dict[str, Any]:
        """The provenance record kept beside every tuned plan
        (``obs_static_metrics``)."""
        return {
            "calibrated": self.calibrated,
            "dryrun": self.dryrun,
            "inter_gbps": round(self.inter_gbps, 3),
            "inter_calibrated": self.inter_calibrated,
            "inter_source": self.inter_source,
            "inter_live": self.inter_live,
            "intra_gbps": round(self.intra_gbps, 3),
            "intra_calibrated": self.intra_calibrated,
            "intra_source": self.intra_source,
            "intra_dryrun": self.intra_dryrun,
            "intra_live": self.intra_live,
            "dispatch_s": self.dispatch_s,
            "rtt_s": self.rtt_s,
            "codec_rates": {
                name: {klass: {"encode_gbps": r.encode_gbps,
                               "decode_gbps": r.decode_gbps,
                               "source": r.source, "dryrun": r.dryrun,
                               "live": r.live}
                       for klass, r in by_class.items()}
                for name, by_class in sorted(self.codec_rates.items())},
            "artifacts": [a.describe() for a in self.artifacts],
        }


# -- the port's banked files ---------------------------------------------------

def _load(path: str) -> Optional[dict]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _is_dryrun_platform(platform: Optional[str]) -> bool:
    return platform != "cuda"


def bank_calibration(calib: Calibration, path: str, *, platform: str,
                     device: Optional[str] = None,
                     git_sha: Optional[str] = None) -> dict:
    """Write the measured components of ``calib`` as a banked file the
    loader reads (``calibration/cuda_<name>.json`` under the repository
    root): ``platform`` "cuda" (measured on the card) or "cpu", ``device``
    the card's name and power limit as ``nvidia-smi`` gives them."""
    d: Dict[str, Any] = {"platform": platform, "device": device,
                         "_provenance": {"git_sha": git_sha},
                         "codec_rates": {
                             name: {k: {"encode_gbps": r.encode_gbps,
                                        "decode_gbps": r.decode_gbps}
                                    for k, r in by_class.items()}
                             for name, by_class in calib.codec_rates.items()}}
    if calib.inter_calibrated:
        d["inter_gbps"] = calib.inter_gbps
    if calib.intra_calibrated:
        d["intra_gbps"] = calib.intra_gbps
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(d, f, indent=1, sort_keys=True)
    return d


def load_calibration(root: Optional[str] = None,
                     artifacts: Optional[Sequence[Tuple[str, dict]]] = None
                     ) -> Calibration:
    """A Calibration from the port's banked files under ``root`` (the
    repository by default; ``BANK_PATTERN``), newest name first; a card
    row outranks a CPU row.  ``artifacts`` injects ``(path, dict)`` pairs
    instead (the tests' seam).  A file whose platform is neither "cuda"
    nor "cpu" is not the port's and is skipped."""
    root = root or ROOT
    if artifacts is not None:
        pairs = [(p, d) for p, d in artifacts if d]
    else:
        pairs = []
        for p in sorted(glob.glob(os.path.join(root, BANK_PATTERN)),
                        reverse=True):
            d = _load(p)
            if d:
                pairs.append((p, d))
    codec_rates: Dict[str, Dict[str, CodecRates]] = {}
    records: List[ArtifactRecord] = []
    links = {
        "inter": (FALLBACK_INTER_GBPS, False,
                  "fallback constant (FALLBACK_INTER_GBPS)", False, 0),
        "intra": (FALLBACK_INTRA_GBPS, False,
                  "fallback constant (FALLBACK_INTRA_GBPS)", False, 0)}
    for path, d in pairs:
        platform = d.get("platform")
        if platform not in ("cuda", "cpu"):
            continue
        dry = _is_dryrun_platform(platform)
        rel = os.path.relpath(path, root) if os.path.isabs(path) else path
        src = os.path.basename(path) + (f" ({d['device']})"
                                        if d.get("device") else "")
        contributed = False
        for name, by_class in (d.get("codec_rates") or {}).items():
            for klass, row in by_class.items():
                enc, dec = row.get("encode_gbps"), row.get("decode_gbps")
                if not enc or not dec:
                    continue
                cur = codec_rates.get(name, {}).get(klass)
                if cur is None or (cur.dryrun and not dry):
                    codec_rates.setdefault(name, {})[klass] = CodecRates(
                        float(enc), float(dec), src, dry)
                    contributed = True
        for key in ("inter", "intra"):
            rate = d.get(f"{key}_gbps")
            rank = 1 if dry else 2
            if rate and rank > links[key][4]:
                links[key] = (float(rate), True,
                              f"{src} ring all-reduce"
                              + (" (dryrun: CPU)" if dry else ""), dry, rank)
                contributed = True
        if contributed:
            records.append(ArtifactRecord(
                rel, (d.get("_provenance") or {}).get("git_sha"), platform,
                dry))
    inter, intra = links["inter"], links["intra"]
    return Calibration(
        codec_rates=codec_rates,
        inter_gbps=inter[0], inter_calibrated=inter[1],
        inter_source=inter[2], inter_dryrun=inter[3],
        intra_gbps=intra[0], intra_calibrated=intra[1],
        intra_source=intra[2], intra_dryrun=intra[3],
        artifacts=tuple(records))


def fixture_calibration(inter_gbps: float = 50.0,
                        codec_gbps: float = 8.0,
                        topk_gbps: Optional[float] = None) -> Calibration:
    """JAX's deterministic fixture regime, the same numbers (the tests and
    the card's adaptive phase share it): at the default fast wire the
    argmin's plan 0 is the uncompressed flat ring, so a forced shift has
    a cheaper wire format to move to.  Pure data, no banked file."""
    tk = codec_gbps if topk_gbps is None else topk_gbps
    rates = {
        name: {klass: CodecRates(r, r, "fixture", False)
               for klass in ("vmem", "streaming")}
        for name, r in (("bfp", codec_gbps), ("int8", codec_gbps),
                        ("topk", tk))}
    return Calibration(
        codec_rates=rates, inter_gbps=inter_gbps, inter_calibrated=True,
        inter_source="fixture", intra_gbps=40.0,
        artifacts=(ArtifactRecord("fixture.json", "f" * 40, "tpu",
                                  False),))


# -- the live tier -------------------------------------------------------------

def apply_live(base: Calibration, *,
               inter_gbps: Optional[float] = None,
               intra_gbps: Optional[float] = None,
               codec_rates: Optional[Mapping[str, Mapping[str, CodecRates]]]
               = None,
               dryrun: bool = False,
               source: str = "startup mesh microbench") -> Calibration:
    """Overlay live-measured rates onto ``base`` (the top of the ranking):
    each overridden component's source is prefixed ``live:`` and its
    ``*_live`` flag set, ``dryrun`` says the rates were measured on the
    CPU, and the components not measured keep their provenance."""
    kw: Dict[str, Any] = {}
    tag = f"live: {source}" + (" (dryrun: CPU)" if dryrun else "")
    if inter_gbps is not None and inter_gbps > 0:
        kw.update(inter_gbps=float(inter_gbps), inter_calibrated=True,
                  inter_source=tag, inter_dryrun=bool(dryrun),
                  inter_live=True)
    if intra_gbps is not None and intra_gbps > 0:
        kw.update(intra_gbps=float(intra_gbps), intra_calibrated=True,
                  intra_source=tag, intra_dryrun=bool(dryrun),
                  intra_live=True)
    if codec_rates:
        merged: Dict[str, Dict[str, CodecRates]] = {
            name: dict(by_class)
            for name, by_class in base.codec_rates.items()}
        for name, by_class in codec_rates.items():
            for klass, rates in by_class.items():
                src = rates.source if rates.source.startswith("live:") \
                    else f"live: {rates.source}"
                merged.setdefault(name, {})[klass] = CodecRates(
                    rates.encode_gbps, rates.decode_gbps, src,
                    bool(dryrun), live=True)
        kw["codec_rates"] = merged
    return dataclasses.replace(base, **kw) if kw else base
