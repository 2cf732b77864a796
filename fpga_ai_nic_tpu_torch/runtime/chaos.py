"""Collective integrity checking and the corruption part of fault injection —
the port of the JAX package's ``runtime/chaos.py``.

Two tiers guard the trainer's collective (``parallel.train.DPTrainer`` with
``CollectiveConfig(integrity_check=True)``):

  value tier  per-chunk input sums against the reduced output within a
              tolerance derived from the codec's declared error bound, and
              a NaN/inf count (``chunk_checksums``, ``collective_integrity``,
              ``integrity_tol``); plus the host-side ``NormDriftGuard``;
  exact tier  bit-exact checksums over the encoded wire frames
              (``ops.integrity``): ``wire_ok``, the finite wrong-value class
              no tolerance band can see.

``check_step_diag`` raises on a step's verdicts, the exact tier first.

Fault injection: a ``FaultPlan`` of ``FaultSpec``s fires corruption at the
``collective`` site, through the two seams of ``ops.ring`` (plain Python
callables here; the JAX package compiles them in as XLA callbacks): the
value modes (``nan``, ``bitflip``, ``scale``) through the collective tap,
on each rank's input row of a ring collective, and ``wirebit`` (a low
stored bit of an encoded frame: finite, in-band) through the wire tap, on
each rank's received payload arrays.  The corrupted indices and bits derive
from ``numpy.random.default_rng`` of (plan seed, spec step) exactly as in
the JAX package, so a plan flips the same words in both.  As in the JAX
package, the fused ring kernels are not tapped.  Every other fault kind and
site (hang, slowdown, exception, preemption, the queue, staging, serving,
reshard and checkpoint sites) is not ported: ROADMAP A.8.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "FAULT_KINDS", "SITES", "CORRUPTION_MODES",
    "InjectedFault", "InjectedPreemption", "IntegrityError",
    "WireIntegrityError",
    "FaultSpec", "FaultPlan", "NormDriftGuard",
    "chunk_checksums", "collective_integrity", "integrity_tol",
    "check_step_diag", "install_collective_tap", "uninstall_collective_tap",
    "install_wire_tap", "uninstall_wire_tap", "activate",
]

# the JAX package's kinds, sites and modes: all are recognised, the subset
# below is ported
FAULT_KINDS = ("hang", "slowdown", "exception", "corruption", "preemption")
DURABILITY_KINDS = ("kill", "diskfull")
SITES = ("queue.issue", "queue.wait", "staging", "collective", "serve.step",
         "serve.handoff", "fleet.membership", "reshard.transfer",
         "ckpt.save", "ckpt.restore")
CORRUPTION_MODES = ("nan", "bitflip", "scale", "wirebit", "stale_manifest")
# modes of the value tap; "wirebit" belongs to the wire tap
_VALUE_MODES = ("nan", "bitflip", "scale")
# wire-tap point -> the site whose wirebit specs fire there
_WIRE_POINT_SITES = {"ring.wire": "collective"}


class InjectedFault(RuntimeError):
    """A fault raised on purpose by a fault plan (transient by contract)."""


class InjectedPreemption(InjectedFault):
    """The process lost its device: recovery rebuilds, not a plain retry."""


class IntegrityError(RuntimeError):
    """A value-space guard tripped (a collective's chunk sums or non-finite
    values, a drifting norm, the serving tick's logits); the numbers must
    not reach the optimizer or a token stream."""


class WireIntegrityError(IntegrityError):
    """The exact tier tripped: a wire frame or KV page failed its bit-exact
    checksum (``ops.integrity``)."""


@dataclass(frozen=True)
class FaultSpec:
    """One planned fault: fire ``kind`` at ``site`` on step ``step``;
    ``mode`` / ``fraction`` shape the corruption (``fraction`` of the
    elements, at least one).  Ported: kind "corruption" at site
    "collective"."""

    kind: str
    site: str
    step: int
    mode: str = "nan"
    fraction: float = 0.01

    def __post_init__(self):
        if self.kind not in FAULT_KINDS + DURABILITY_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r}")
        if self.mode not in CORRUPTION_MODES:
            raise ValueError(f"unknown corruption mode {self.mode!r}")
        if self.kind != "corruption" or self.site != "collective":
            raise NotImplementedError(
                f"fault {self.kind!r} at {self.site!r} is not ported (only "
                "corruption at the collective site): ROADMAP A.8")
        if self.mode == "stale_manifest":
            raise ValueError("mode='stale_manifest' only exists at the "
                             "checkpoint sites")


class FaultPlan:
    """A deterministic schedule of FaultSpecs and the hooks that fire them.
    Each spec fires at most once, so a retry of the same step runs clean.

        plan.begin_step(i)                  # before step i
        plan.collective_payload(a)          # value tap, per rank row
        plan.wire_payload(a, "ring.wire")   # wire tap, per payload array
    """

    def __init__(self, faults: Iterable[FaultSpec] = (), seed: int = 0):
        self.faults: Tuple[FaultSpec, ...] = tuple(faults)
        self.seed = seed
        self.fired: List[FaultSpec] = []
        self._step = -1

    def begin_step(self, step: int) -> None:
        self._step = int(step)

    def _pending(self, site: str, kinds: Sequence[str],
                 modes: Optional[Sequence[str]] = None) -> List[FaultSpec]:
        fired_ids = {id(f) for f in self.fired}
        return [s for s in self.faults
                if s.site == site and s.step == self._step
                and s.kind in kinds and id(s) not in fired_ids
                and (modes is None or s.kind != "corruption"
                     or s.mode in modes)]

    def armed(self, site: str, modes: Sequence[str]) -> bool:
        """Whether a corruption spec of ``modes`` is pending at ``site`` in
        this step (the taps read no payload otherwise)."""
        return bool(self._pending(site, ("corruption",), modes))

    def _take(self, site: str, kinds: Sequence[str],
              limit: Optional[int] = None,
              modes: Optional[Sequence[str]] = None) -> List[FaultSpec]:
        """Pop (mark fired) the pending specs at (site, this step, kinds),
        at most ``limit``; ``modes`` restricts the corruption modes, so the
        value and wire taps never take each other's specs."""
        out = self._pending(site, kinds, modes)
        if limit is not None:
            out = out[:limit]
        self.fired.extend(out)
        return out

    def collective_payload(self, arr: np.ndarray) -> np.ndarray:
        """The value tap: the first rank to arrive takes every pending
        value-mode corruption spec."""
        for spec in self._take("collective", ("corruption",),
                               modes=_VALUE_MODES):
            arr = self._corrupt_array(np.array(arr), spec)
        return arr

    def wire_payload(self, arr: np.ndarray, point: str) -> np.ndarray:
        """The wire tap, once per payload array per rank: one pending
        ``wirebit`` spec at a time flips low stored bits of the encoded
        bytes."""
        site = _WIRE_POINT_SITES.get(point)
        if site is None:
            return arr
        for spec in self._take(site, ("corruption",), limit=1,
                               modes=("wirebit",)):
            arr = self._corrupt_wire_array(np.array(arr), spec)
        return arr

    def _corrupt_array(self, arr: np.ndarray, spec: FaultSpec) -> np.ndarray:
        """Deterministic damage from (plan seed, spec step) only."""
        if spec.mode == "wirebit":
            return self._corrupt_wire_array(arr, spec)
        rng = np.random.default_rng((self.seed, spec.step, 0xC0FFEE))
        flat = arr.reshape(-1)
        k = max(1, int(flat.size * spec.fraction))
        idx = rng.choice(flat.size, size=min(k, flat.size), replace=False)
        if spec.mode == "nan":
            flat[idx] = np.nan
        elif spec.mode == "scale":
            flat[idx] = flat[idx] * np.float32(1e8) + np.float32(1e8)
        else:                                   # bitflip: exponent-high bit
            f32 = flat.astype(np.float32, copy=True)
            bits = f32.view(np.uint32)
            bits[idx] ^= np.uint32(1 << 30)
            flat[:] = f32.astype(flat.dtype)
        return arr

    def _corrupt_wire_array(self, arr: np.ndarray,
                            spec: FaultSpec) -> np.ndarray:
        """The lowest stored bit of ``fraction`` of the words flips: int
        frames flip mantissa/index LSBs, f32 frames mantissa bit 1.  Always
        finite, always in-band, always a changed wire byte."""
        rng = np.random.default_rng((self.seed, spec.step, 0xB17F11B))
        flat = arr.reshape(-1)
        k = max(1, int(flat.size * spec.fraction))
        idx = rng.choice(flat.size, size=min(k, flat.size), replace=False)
        if flat.dtype == np.float32:
            flat.view(np.uint32)[idx] ^= np.uint32(1 << 1)
        elif flat.dtype.kind in "iu":
            flat[idx] ^= flat.dtype.type(1)
        else:   # other float widths: flip the lowest mantissa bit
            w = flat.view(np.uint16 if flat.dtype.itemsize == 2
                          else np.uint32)
            w[idx] ^= w.dtype.type(1)
        return arr


# ---------------------------------------------------------------------------
# the taps (ops.ring's seams)
# ---------------------------------------------------------------------------

_ACTIVE_PLAN: Optional[FaultPlan] = None


def _to_numpy(x: torch.Tensor) -> np.ndarray:
    """A tensor's bits on the host (bf16 as its uint16 patterns)."""
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(np.uint16)
    return x.numpy()


def _from_numpy(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if like.dtype == torch.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            like.device)
    return torch.from_numpy(a).to(like.device)


def _run_tap(x: torch.Tensor, modes: Sequence[str], hook) -> torch.Tensor:
    """``x`` itself unless the active plan fires; then a corrupted copy."""
    plan = _ACTIVE_PLAN
    if plan is None or not plan.armed("collective", modes):
        return x
    a = _to_numpy(x)
    got = hook(plan, a)
    return x if got is a else _from_numpy(got, x)


def _tap_fn(x: torch.Tensor, point: str) -> torch.Tensor:
    return _run_tap(x, _VALUE_MODES,
                    lambda plan, a: plan.collective_payload(a))


def _wire_tap_fn(x: torch.Tensor, point: str) -> torch.Tensor:
    if point not in _WIRE_POINT_SITES:
        return x
    return _run_tap(x, ("wirebit",),
                    lambda plan, a: plan.wire_payload(a, point))


def install_collective_tap() -> None:
    """Route each rank's input row of the ring collectives through the
    active plan (``activate``)."""
    from ..ops import ring
    ring.set_fault_tap(_tap_fn)


def uninstall_collective_tap() -> None:
    from ..ops import ring
    ring.set_fault_tap(None)


def install_wire_tap() -> None:
    """Route each rank's received encoded payload arrays through the active
    plan's wirebit hook."""
    from ..ops import ring
    ring.set_wire_tap(_wire_tap_fn)


def uninstall_wire_tap() -> None:
    from ..ops import ring
    ring.set_wire_tap(None)


class activate:
    """Context manager binding a plan as the ambient target of the taps."""

    def __init__(self, plan: Optional[FaultPlan]):
        self.plan = plan

    def __enter__(self):
        global _ACTIVE_PLAN
        self._prev = _ACTIVE_PLAN
        _ACTIVE_PLAN = self.plan
        return self.plan

    def __exit__(self, *exc):
        global _ACTIVE_PLAN
        _ACTIVE_PLAN = self._prev
        return False


# ---------------------------------------------------------------------------
# collective integrity (over virtual ranks)
# ---------------------------------------------------------------------------

def integrity_tol(coll, n: int) -> float:
    """Tolerance of the value tier for an n-way all-reduce under the
    configured wire format, from the codec's declared error bound: f32
    reassociation only (1e-3) without a codec, ``(n-1) * error_bound * 8``
    capped at 0.5 with one.  A gross-corruption tripwire (NaN, flipped
    exponent bits, runaway scale), not a bit-exactness check."""
    from ..ops.fused_update import resolve_codec
    codec = resolve_codec(coll)
    if codec is None:
        return 1e-3
    return min(0.5, (n - 1) * float(codec.error_bound) * 8.0)


def chunk_checksums(flat: torch.Tensor, n: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-chunk input checksums of the ranks' flat contributions
    ``[n_ranks, L]``, summed over the ranks: ``(expect [n], l1 [n])``,
    expect[b] the true sum of reduced chunk b, l1[b] its scale."""
    parts = flat.reshape(flat.shape[0], n, -1)
    # the L1 sums in one read, with no |flat| copy
    l1 = torch.linalg.vector_norm(parts, ord=1, dim=2)
    return parts.sum(dim=2).sum(dim=0), l1.sum(dim=0)


def collective_integrity(expect: torch.Tensor, l1: torch.Tensor,
                         g_red: torch.Tensor, n: int,
                         tol: float) -> Dict[str, Any]:
    """After ``g_red = reduce_scatter(flat)`` (``[n, C]`` sums, pre-mean):
    each rank's reduced-chunk sum against the input checksum, and the
    non-finite count::

        integrity_ok   bool — all chunks within tol and all finite
        integrity_err  f32  — worst relative chunk-sum discrepancy
        nonfinite      int  — NaN/inf count across the reduced vector

    ``integrity_ok`` fails closed on NaN (a NaN comparison is False)."""
    got = g_red.to(torch.float32).sum(dim=1)
    nonfinite = (~torch.isfinite(g_red)).sum()
    err = ((expect - got).abs() / (l1 + 1e-20)).max()
    ok = (nonfinite == 0) & (err <= tol)
    return {"integrity_ok": ok, "integrity_err": err, "nonfinite": nonfinite}


def check_step_diag(diag: Dict[str, Any], step: int) -> None:
    """Host-side verdict on a step's diagnostics: raises
    ``WireIntegrityError`` when the exact tier tripped (checked first: it
    proves the bytes changed in flight, with no tolerance involved; on the
    fused kernel route this raise is the only recovery), else
    ``IntegrityError`` when the value tier did."""
    if not bool(diag.get("wire_ok", True)):
        raise WireIntegrityError(
            f"exact wire checksum tripped at step {step}: an encoded "
            "frame changed between send and receive (finite corruption "
            "class, invisible to the value band)")
    nonfinite = int(diag.get("nonfinite", 0))
    ok = bool(diag.get("integrity_ok", True))
    if nonfinite or not ok:
        raise IntegrityError(
            f"collective integrity tripped at step {step}: "
            f"nonfinite={nonfinite}, "
            f"rel_err={float(diag.get('integrity_err', float('nan'))):.3g} "
            "(update was gated out before the optimizer)")


@dataclass
class NormDriftGuard:
    """Host-side drift guard over a scalar series (gradient norm or loss):
    trips when the value is non-finite, or after ``warmup`` clean samples
    jumps ``factor``x above the running median."""

    factor: float = 1e3
    warmup: int = 3
    window: int = 32
    history: List[float] = field(default_factory=list)

    def check(self, value: float, what: str = "grad_norm") -> None:
        v = float(value)
        if not np.isfinite(v):
            raise IntegrityError(f"{what} is non-finite ({v})")
        h = self.history
        if len(h) >= self.warmup:
            med = float(np.median(h[-self.window:]))
            if med > 0 and v > self.factor * med:
                raise IntegrityError(
                    f"{what} drift: {v:.3g} is {v / med:.1f}x the running "
                    f"median {med:.3g} (factor limit {self.factor:g})")
        h.append(v)
        del h[:-self.window]
