"""Deterministic fault injection and collective integrity checking — the
port of the JAX package's ``runtime/chaos.py``.

A ``FaultPlan`` of ``FaultSpec``s fires faults at the system's boundaries
(``SITES``), each derived, as in the JAX package, from the code point that
fires it (the ``_*_POINT_SITES`` maps):

  queue.issue / queue.wait   ``runtime.queue.CollectiveQueue`` (host)
  staging                    ``runtime.staging.Stager`` and ``plan.stage``
  collective                 each rank's input row of a ring collective
                             (``ops.ring``'s value tap; as in the JAX
                             package the fused ring kernels are not tapped)
  serve.step                 ``serve.engine.ServeEngine``'s tick
  serve.handoff, fleet.membership   ``serve.fleet.ServeFleet``
  ckpt.save / ckpt.restore   ``utils.checkpoint.Checkpointer`` (durability)

Fault kinds (``FAULT_KINDS``): ``hang`` (a sleep past the watchdog's
limit), ``slowdown`` (a sleep below it: survived without recovery),
``exception`` (``InjectedFault``), ``preemption`` (``InjectedPreemption``:
recovery re-initialises and restores), ``corruption`` (the payload is
damaged: ``nan``, ``bitflip`` of an exponent bit, ``scale``, or
``wirebit``, a low stored bit: finite, in-band, visible only to an exact
checksum).  The durability kinds ``kill`` and ``diskfull`` interrupt a
save's file-op sequence at ``fraction`` of its ops; ``wirebit`` and
``stale_manifest`` corrupt a committed step at rest
(``damage_checkpoint``).  The ``reshard.transfer`` site belongs to the
live reshard tier, which is not ported (ROADMAP A.8's reshard slice): a
spec there raises.

Everything is deterministic under a fixed seed: the plan's spec list, the
corrupted indices and the flipped bits derive from
``numpy.random.default_rng`` exactly as in the JAX package, so a plan
flips the same words in both.  A tensor of the card is copied to the host,
damaged there and copied back.  bfloat16 payloads (the serving pool) take
the value modes through f32 and ``wirebit`` on their stored 16-bit words;
the JAX package's ``corrupt`` leaves bfloat16 leaves alone (numpy does not
count ``ml_dtypes.bfloat16`` as floating), so there a plan at ``serve.step``
on a bf16 pool damages nothing.

The integrity tiers guarding the trainer's collective
(``parallel.train.DPTrainer`` with ``CollectiveConfig(integrity_check=
True)``): the value tier (``chunk_checksums``, ``collective_integrity``,
``integrity_tol``, the host-side ``NormDriftGuard``) and the exact tier
(``ops.integrity``'s wire checksums, ``wire_ok``); ``check_step_diag``
raises on a step's verdicts, the exact tier first.
"""

from __future__ import annotations

import os
import shutil
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "FAULT_KINDS", "DURABILITY_KINDS", "SITES", "TRAIN_SITES",
    "SERVE_SITES", "WIRE_SITES", "CKPT_SITES", "CORRUPTION_MODES",
    "InjectedFault", "InjectedPreemption", "IntegrityError",
    "WireIntegrityError",
    "FaultSpec", "FaultPlan", "NormDriftGuard", "state_buffers_alive",
    "chunk_checksums", "collective_integrity", "integrity_tol",
    "check_step_diag", "install_collective_tap", "uninstall_collective_tap",
    "install_wire_tap", "uninstall_wire_tap", "activate",
]

FAULT_KINDS = ("hang", "slowdown", "exception", "corruption", "preemption")
# fire point -> the site its specs target; the exported *_SITES tuples are
# derived from these maps, never written out
_TRAIN_POINT_SITES = {
    "runtime.queue.CollectiveQueue.issue": "queue.issue",
    "runtime.queue.CollectiveQueue.wait": "queue.wait",
    "runtime.staging.Stager.wait": "staging",
    "runtime.chaos.collective_tap": "collective",
}
_SERVE_POINT_SITES = {
    "serve.engine.ServeEngine.tick": "serve.step",
    "serve.fleet.ServeFleet._handoff": "serve.handoff",
    "serve.fleet.ServeFleet.tick": "fleet.membership",
}
TRAIN_SITES = tuple(dict.fromkeys(_TRAIN_POINT_SITES.values()))
SERVE_SITES = tuple(dict.fromkeys(_SERVE_POINT_SITES.values()))
_CKPT_POINT_SITES = {
    "utils.checkpoint.Checkpointer.save": "ckpt.save",
    "utils.checkpoint.Checkpointer.restore": "ckpt.restore",
}
CKPT_SITES = tuple(dict.fromkeys(_CKPT_POINT_SITES.values()))
SITES = TRAIN_SITES + SERVE_SITES + ("reshard.transfer",) + CKPT_SITES
CORRUPTION_MODES = ("nan", "bitflip", "scale", "wirebit", "stale_manifest")
# kill-during-save and disk-full: the save's op stream cut at a planned
# prefix (``fraction`` of its ops); only at ckpt.save
DURABILITY_KINDS = ("kill", "diskfull")

# kinds a site that sits inside a collective can take (no raising there)
_CALLBACK_KINDS = ("hang", "slowdown", "corruption")
_CALLBACK_ONLY_SITES = ("collective", "reshard.transfer")
# modes of the value taps; "wirebit" belongs to the wire tap
_VALUE_MODES = ("nan", "bitflip", "scale")
# wire-tap point -> the site whose wirebit specs fire there
_WIRE_POINT_SITES = {
    "ring.wire": "collective",
    "reshard.wire": "reshard.transfer",
    "handoff.wire": "serve.handoff",
}
WIRE_SITES = tuple(dict.fromkeys(_WIRE_POINT_SITES.values()))


class InjectedFault(RuntimeError):
    """A fault raised on purpose by a fault plan (transient by contract)."""

    def __init__(self, spec: "FaultSpec"):
        super().__init__(f"injected {spec.kind} at {spec.site} "
                         f"(step {spec.step})")
        self.spec = spec
        self.kind = spec.kind
        self.site = spec.site


class InjectedPreemption(InjectedFault):
    """The process lost its device: recovery re-initialises the control
    plane and restores a checkpoint, not a plain retry."""


class IntegrityError(RuntimeError):
    """A value-space guard tripped (a collective's chunk sums or non-finite
    values, a drifting norm, the serving tick's logits); the numbers must
    not reach the optimizer or a token stream."""


class WireIntegrityError(IntegrityError):
    """The exact tier tripped: a wire frame or KV page failed its bit-exact
    checksum (``ops.integrity``)."""


def state_buffers_alive(state: Any) -> bool:
    """True while every tensor of a state tree (dicts, lists, tuples) still
    holds its storage: the gate between migrating a dying replica's state
    and replaying it, and before retrying a step from its pre-step state
    (a tensor whose storage was released reads as dead)."""
    if isinstance(state, dict):
        return all(state_buffers_alive(v) for v in state.values())
    if isinstance(state, (list, tuple)):
        return all(state_buffers_alive(v) for v in state)
    if isinstance(state, torch.Tensor):
        need = state.numel() * state.element_size()
        return need == 0 or state.untyped_storage().nbytes() >= need
    return True


@dataclass(frozen=True)
class FaultSpec:
    """One planned fault: fire ``kind`` at ``site`` on step ``step``;
    ``duration_s`` is the sleep of a hang or slowdown; ``mode`` /
    ``fraction`` shape the corruption (``fraction`` of the elements, at
    least one; for kill / diskfull the share of the save's ops run before
    the interrupt).  The JAX package's validation, with its messages."""

    kind: str
    site: str
    step: int
    duration_s: float = 0.25
    mode: str = "nan"
    fraction: float = 0.01

    def __post_init__(self):
        if self.kind not in FAULT_KINDS + DURABILITY_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r}")
        if self.mode not in CORRUPTION_MODES:
            raise ValueError(f"unknown corruption mode {self.mode!r}")
        if self.site == "reshard.transfer":
            raise NotImplementedError(
                "the 'reshard.transfer' site is the live reshard tier's "
                "wire (parallel/reshard.py), which is not ported: ROADMAP "
                "A.8, its reshard slice")
        if self.kind in DURABILITY_KINDS and self.site != "ckpt.save":
            raise ValueError(
                f"{self.kind!r} only exists at the 'ckpt.save' site: it "
                "truncates/fails the save file-op sequence at a planned "
                "prefix (fraction of the op count)")
        if self.site in CKPT_SITES and self.kind not in \
                DURABILITY_KINDS + ("corruption",):
            raise ValueError(
                f"{self.kind!r} cannot fire at the {self.site!r} site: "
                "durability sites take kill/diskfull (save only) and "
                "corruption (mode='wirebit' file bit-flip at rest, "
                "mode='stale_manifest')")
        if self.site in CKPT_SITES and self.kind == "corruption" \
                and self.mode not in ("wirebit", "stale_manifest"):
            raise ValueError(
                f"corruption mode {self.mode!r} cannot fire at "
                f"{self.site!r}: stored-file damage is 'wirebit' (a low "
                "stored bit flips at rest) or 'stale_manifest'")
        if self.mode == "stale_manifest" and self.site not in CKPT_SITES:
            raise ValueError(
                "mode='stale_manifest' only exists at the durability "
                "sites (ckpt.save / ckpt.restore): it swaps a step's "
                "manifest for a previous step's")
        if self.site in _CALLBACK_ONLY_SITES \
                and self.kind not in _CALLBACK_KINDS:
            raise ValueError(
                f"{self.kind!r} cannot fire at the {self.site!r} site: it "
                "runs inside the collective, where a raise cannot unwind "
                "the step in the JAX package — plan it at a host site "
                "(queue.*/staging) instead")


def _is_float(leaf: Any) -> bool:
    if isinstance(leaf, torch.Tensor):
        return leaf.is_floating_point()
    if isinstance(leaf, np.ndarray):
        return np.issubdtype(leaf.dtype, np.floating)
    return isinstance(leaf, float)


def _numel(leaf: Any) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.numel()
    return int(np.size(leaf))


# a trainer state's working copies (every rank's replica of the params, the
# side rows): JAX's states hold the params once, as leaves no larger than
# the master vector, so these take no part in picking the leaf to corrupt
_DERIVED_FIELDS = ("replicas", "side")


def _flatten(tree: Any) -> Tuple[List[Any], Any]:
    """``(leaves, rebuild)``: a tree's leaves in the JAX package's pytree
    order (dict keys sorted; tuples, lists and NamedTuples in order) and a
    function rebuilding the tree from new leaves."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_flatten(tree[k]) for k in keys]

        def rebuild(leaves, _parts=parts, _keys=keys):
            out, i = dict(tree), 0
            for k, (ls, rb) in zip(_keys, _parts):
                out[k] = rb(leaves[i:i + len(ls)])
                i += len(ls)
            return out
        return [l for ls, _ in parts for l in ls], rebuild
    if isinstance(tree, (list, tuple)):
        fields = getattr(tree, "_fields", None)
        skip = (set(_DERIVED_FIELDS) if fields and {"w_own", "w_master"}
                & set(fields) else set())
        idx = [i for i in range(len(tree))
               if not (fields and fields[i] in skip)]
        parts = [_flatten(tree[i]) for i in idx]

        def rebuild(leaves, _parts=parts, _idx=idx):
            items, j = list(tree), 0
            for i, (ls, rb) in zip(_idx, _parts):
                items[i] = rb(leaves[j:j + len(ls)])
                j += len(ls)
            return type(tree)(*items) if fields else type(tree)(items)
        return [l for ls, _ in parts for l in ls], rebuild
    if tree is None:
        return [], lambda leaves: None
    return [tree], lambda leaves: leaves[0]


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


class FaultPlan:
    """A deterministic schedule of FaultSpecs and the hooks that fire them.
    Thread-safe: host hooks and the collective tap may run on different
    threads (a watchdog worker and the loop).  Each spec fires at most
    once, so a retry of the same step runs clean.

        plan.begin_step(i)                  # before step i
        plan.fire(site)                     # host boundary: sleep or raise
        x = plan.corrupt(site, x)           # host boundary with a payload
        plan.collective_payload(a)          # value tap, per rank row
        plan.wire_payload(a, "ring.wire")   # wire tap, per payload array

    ``events`` (an ``obs.events.EventStream`` or None) receives a
    ``chaos.fire`` instant for every spec that fires."""

    def __init__(self, faults: Iterable[FaultSpec] = (), seed: int = 0):
        self.faults: Tuple[FaultSpec, ...] = tuple(faults)
        self.seed = seed
        self.fired: List[FaultSpec] = []
        self._step = -1
        self._lock = threading.RLock()
        self.events = None

    # -- construction -----------------------------------------------------------

    @classmethod
    def random(cls, seed: int, n_steps: int, *, rate: float = 0.25,
               kinds: Sequence[str] = FAULT_KINDS,
               sites: Sequence[str] = TRAIN_SITES,
               duration_s: float = 0.25) -> "FaultPlan":
        """Seeded random plan: each step draws one fault with probability
        ``rate``; kind, site and mode uniformly from the legal
        combinations (the value modes only).  Same seed, same plan, and
        the same plan as the JAX package's."""
        rng = np.random.default_rng(seed)
        specs = []
        for step in range(n_steps):
            if rng.random() >= rate:
                continue
            site = str(rng.choice(list(sites)))
            legal = [k for k in kinds
                     if site != "collective" or k in _CALLBACK_KINDS]
            if not legal:
                continue
            kind = str(rng.choice(legal))
            specs.append(FaultSpec(
                kind=kind, site=site, step=step, duration_s=duration_s,
                mode=str(rng.choice(list(_VALUE_MODES)))))
        return cls(specs, seed=seed)

    @classmethod
    def sustained(cls, kind: str, site: str, *, start_step: int,
                  n_steps: int, duration_s: float = 0.25,
                  mode: str = "nan", fraction: float = 0.01,
                  seed: int = 0) -> "FaultPlan":
        """A regime shift, not a glitch: one identical spec a step for
        ``n_steps`` steps from ``start_step``, each firing once."""
        if n_steps < 1:
            raise ValueError(f"n_steps must be >= 1, got {n_steps}")
        return cls([FaultSpec(kind, site, step=start_step + i,
                              duration_s=duration_s, mode=mode,
                              fraction=fraction)
                    for i in range(n_steps)], seed=seed)

    # -- stepping ---------------------------------------------------------------

    def begin_step(self, step: int) -> None:
        with self._lock:
            self._step = int(step)

    @property
    def step(self) -> int:
        return self._step

    def _pending(self, site: str, kinds: Sequence[str],
                 modes: Optional[Sequence[str]] = None) -> List[FaultSpec]:
        fired_ids = {id(f) for f in self.fired}
        return [s for s in self.faults
                if s.site == site and s.step == self._step
                and s.kind in kinds and id(s) not in fired_ids
                and (modes is None or s.kind != "corruption"
                     or s.mode in modes)]

    def armed(self, site: str, kinds: Sequence[str],
              modes: Optional[Sequence[str]] = None) -> bool:
        """Whether a spec of ``kinds`` (corruption restricted to ``modes``)
        is pending at ``site`` in this step: the taps read no payload
        otherwise."""
        with self._lock:
            return bool(self._pending(site, kinds, modes))

    def _take(self, site: str, kinds: Sequence[str],
              limit: Optional[int] = None,
              modes: Optional[Sequence[str]] = None) -> List[FaultSpec]:
        """Pop (mark fired) the pending specs at (site, this step, kinds),
        at most ``limit``: raising hooks take one at a time, so sibling
        specs stay armed for the retry.  Fired-ness is per spec instance.
        ``modes`` restricts the corruption modes, so the value and wire
        taps never take each other's specs."""
        with self._lock:
            out = self._pending(site, kinds, modes)
            if limit is not None:
                out = out[:limit]
            self.fired.extend(out)
        ev = self.events
        if ev is not None:
            for s in out:
                ev.instant("chaos.fire", kind=s.kind, site=s.site,
                           step=s.step)
        return out

    # -- host-side firing -------------------------------------------------------

    def fire(self, site: str) -> None:
        """The host boundary hook: sleeps for hang/slowdown, raises for
        preemption (``InjectedPreemption``) and exception
        (``InjectedFault``), one raise a call.  Corruption specs are left
        to ``corrupt`` and the taps."""
        for spec in self._take(site, ("hang", "slowdown")):
            time.sleep(spec.duration_s)
        for spec in self._take(site, ("preemption",), limit=1):
            raise InjectedPreemption(spec)
        for spec in self._take(site, ("exception",), limit=1):
            raise InjectedFault(spec)

    def corrupt(self, site: str, tree: Any) -> Any:
        """Pending corruption specs at ``site`` damage the largest float
        leaf of ``tree`` (tensors or arrays in dicts, lists, tuples,
        NamedTuples); the tree comes back unchanged (the same objects)
        when nothing fires, else a new tree with a damaged copy of that
        leaf."""
        specs = self._take(site, ("corruption",))
        if not specs:
            return tree
        leaves, rebuild = _flatten(tree)
        for spec in specs:
            fl = [i for i, l in enumerate(leaves) if _is_float(l)]
            if not fl:
                continue
            i = max(fl, key=lambda j: _numel(leaves[j]))
            leaves[i] = self._corrupt_leaf(leaves[i], spec)
        return rebuild(leaves)

    def _corrupt_leaf(self, leaf: Any, spec: FaultSpec) -> Any:
        if not isinstance(leaf, torch.Tensor):
            return self._corrupt_array(np.array(leaf), spec)
        if leaf.dtype == torch.bfloat16 and spec.mode != "wirebit":
            a = leaf.detach().float().cpu().numpy()
            out = torch.from_numpy(self._corrupt_array(a, spec))
            return out.to(torch.bfloat16).to(leaf.device)
        return _from_numpy(self._corrupt_array(_to_numpy(leaf).copy(),
                                               spec), leaf)

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

    def stage(self, batch: Any) -> Any:
        """The staging boundary as one call (fire, then corrupt): what
        ``runtime.staging.Stager`` does with ``chaos=plan``, for callers
        staging batches without it (the elastic loop's ``stage_fn``)."""
        self.fire("staging")
        return self.corrupt("staging", batch)

    # -- the collective taps ----------------------------------------------------

    def collective_payload(self, arr: np.ndarray) -> np.ndarray:
        """The value tap: the first rank to arrive sleeps for a pending
        hang or slowdown (a straggler) and takes every pending value-mode
        corruption spec."""
        for spec in self._take("collective", ("hang", "slowdown")):
            time.sleep(spec.duration_s)
        for spec in self._take("collective", ("corruption",),
                               modes=_VALUE_MODES):
            arr = self._corrupt_array(np.array(arr), spec)
        return arr

    def wire_payload(self, arr: np.ndarray, point: str) -> np.ndarray:
        """The wire tap, once per payload array per rank: one pending
        ``wirebit`` spec at a time flips low stored bits of the encoded
        bytes (so sibling specs stay armed for later payloads)."""
        site = _WIRE_POINT_SITES.get(point)
        if site is None:
            return arr
        for spec in self._take(site, ("corruption",), limit=1,
                               modes=("wirebit",)):
            arr = self._corrupt_wire_array(np.array(arr), spec)
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

    # -- the durability sites ---------------------------------------------------

    def take_save_interrupts(self) -> List[FaultSpec]:
        """Pop the pending kill/diskfull spec at ``ckpt.save`` for the save
        about to run (``utils.checkpoint`` maps its ``fraction`` to an op
        index and stops there); one a save, so a sibling stays armed for
        the next save."""
        return self._take("ckpt.save", DURABILITY_KINDS, limit=1)

    def damage_checkpoint(self, site: str, step_dir: str,
                          prev_manifest: Optional[str] = None) -> None:
        """Fire pending corruption specs at a durability site against a
        committed step directory.  ``wirebit``: bit 0 of one 4-byte-aligned
        data byte of a primary leaf file (chosen by the plan's rng among
        the files of 1 KiB or more) flips; ``stale_manifest``: the
        previous step's manifest replaces this step's."""
        from ..utils.checkpoint import (MANIFEST_FILE, flip_stored_bit,
                                        npy_data_offset)
        for spec in self._take(site, ("corruption",),
                               modes=("wirebit", "stale_manifest")):
            if spec.mode == "stale_manifest":
                if prev_manifest is not None and \
                        os.path.exists(prev_manifest):
                    shutil.copyfile(prev_manifest,
                                    os.path.join(step_dir, MANIFEST_FILE))
                continue
            try:
                names = sorted(
                    f for f in os.listdir(step_dir)
                    if f.endswith(".npy") and not f.endswith(".m.npy"))
            except FileNotFoundError:
                continue
            if not names:
                continue
            big = [f for f in names
                   if os.path.getsize(os.path.join(step_dir, f)) >= 1024]
            pool = big or names
            rng = np.random.default_rng((self.seed, spec.step, 0xD15C0))
            p = os.path.join(step_dir, str(rng.choice(pool)))
            with open(p, "rb") as f:
                header = f.read(16)
            n_words = max(1, (os.path.getsize(p)
                              - npy_data_offset(header)) // 4)
            flip_stored_bit(p, byte_off=4 * int(rng.integers(n_words)))


# ---------------------------------------------------------------------------
# the taps (ops.ring's seams)
# ---------------------------------------------------------------------------

_ACTIVE_PLAN: Optional[FaultPlan] = None


def _tap_fn(x: torch.Tensor, point: str) -> torch.Tensor:
    """The value tap: ``x`` itself unless the active plan has a hang,
    slowdown or value-mode corruption pending at ``collective``; then
    the plan's ``collective_payload`` on its bits (a copy when damaged)."""
    plan = _ACTIVE_PLAN
    if plan is None or not plan.armed(
            "collective", ("hang", "slowdown", "corruption"), _VALUE_MODES):
        return x
    a = _to_numpy(x)
    got = plan.collective_payload(a)
    return x if got is a else _from_numpy(got, x)


def _wire_tap_fn(x: torch.Tensor, point: str) -> torch.Tensor:
    site = _WIRE_POINT_SITES.get(point)
    plan = _ACTIVE_PLAN
    if site is None or plan is None or not plan.armed(
            site, ("corruption",), ("wirebit",)):
        return x
    a = _to_numpy(x)
    got = plan.wire_payload(a, point)
    return x if got is a else _from_numpy(got, x)


def install_collective_tap() -> None:
    """Route each rank's input row of the ring collectives through the
    active plan (``activate``)."""
    from ..ops import ring
    ring.set_fault_tap(_tap_fn)


def uninstall_collective_tap() -> None:
    from ..ops import ring
    ring.set_fault_tap(None)


def install_wire_tap() -> None:
    """Route each rank's received encoded payload arrays, and each page
    block of a KV migration (``serve.handoff``), through the active plan's
    wirebit hook."""
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
