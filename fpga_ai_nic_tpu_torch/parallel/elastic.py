"""Elastic recovery loop, the restore tier — the port of the JAX package's
``parallel/elastic.py``.

``runtime.watchdog`` detects, ``utils.checkpoint`` restores; this module
composes them, with ``parallel.multihost`` control-plane re-init and the
``runtime.chaos`` integrity guards, into one supervised loop that turns
every detected fault into a bounded recovery:

    ElasticTrainer.run:
        for each step:
            plan.begin_step(step)                  # chaos only: arm faults
            watchdog.run(                          # hang -> DeviceHangError
                stage_fn(batch)                    # staging boundary
                queue.issue(state, batch)          # host issue boundary
                queue.wait(ticket))                # host wait boundary
            check_step_diag(metrics)               # wire corruption -> raise
            drift guards (loss, grad_norm)         # garbage in -> raise
            master guard (w_own / w_master)        # poisoned state -> raise
            heartbeat.beat(); maybe checkpoint
        on failure:
            classify -> record fault (observability.RecoveryStats)
            preemption: multihost re-init
            restore the last verified checkpoint -> retry with backoff

The JAX package's first tier, the live mesh reshard
(``ElasticTrainer(reshard=ReshardPolicy(...))``), is the next slice of
ROADMAP A.8; here ``reshard=`` raises, and every fault takes the restore
tier (as in the JAX package when no policy is armed).

The bound covers the device work: the attempt waits on its ticket (the
queue synchronises on the ticket's CUDA event) inside the watchdog's
worker.  A timed-out attempt keeps running until its call returns; the
port's trainer steps make new tensors and update nothing in place, so its
late result is simply dropped, and the queue abandons its ticket.

The master guard reads the state a checkpoint would persist: the
finiteness check and the norm of the masters each run on the card as one
reduction (not a host pull of the masters, 168 MB a step on the MLP); the
verdicts are the JAX package's.  It runs when a fault plan is armed, or
as ``ElasticConfig.master_guard`` says.

The loop checkpoints every ``ckpt_every`` steps (and before the first
step) and recovers by restoring the last verified checkpoint and
replaying from it: the loop is keyed on ``state.step``, so a rewind
re-requests the same batches from ``batch_fn``, and a ``FaultPlan`` fires
each spec at most once.  Every event lands in ``Profiler.recovery``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from . import multihost
from ..runtime import chaos as chaos_lib
from ..runtime.queue import CollectiveQueue
from ..runtime.watchdog import DeviceHangError, Heartbeat, Watchdog
from ..utils.checkpoint import Checkpointer
from ..utils.observability import Profiler

__all__ = ["ElasticConfig", "ElasticTrainer", "RecoveryExhausted"]


class RecoveryExhausted(RuntimeError):
    """A step kept failing after max_retries recoveries: the fault is not
    transient (or the recovery path itself is broken); escalate instead
    of looping forever."""


@dataclass(frozen=True)
class ElasticConfig:
    """Knobs of the supervised loop (the JAX package's defaults)."""

    step_timeout_s: float = 300.0     # watchdog limit per step attempt
    stall_after_s: float = 600.0      # heartbeat staleness for monitors
    max_retries: int = 3              # recoveries per step before giving up
    backoff_s: float = 0.05           # exponential backoff base
    ckpt_every: int = 1               # checkpoint cadence (steps)
    # the durability plane: retention (None keeps every step), peer
    # mirrors of the stored shards (on: a restore target must survive a
    # flipped bit), and the emergency dump when the ladder exhausts
    ckpt_keep_last: Optional[int] = None
    ckpt_mirror: bool = True
    emergency_dump: bool = True
    drift_factor: float = 1e3         # NormDriftGuard trip factor
    drift_warmup: int = 3             # clean samples before drift arms
    # the master guard: None = on when a FaultPlan is armed
    master_guard: Optional[bool] = None


class ElasticTrainer:
    """Supervised wrapper around a trainer (``DPTrainer``, ``DDPTrainer``,
    ``FSDPTrainer``, ``ShardedTrainer``: ``step``, ``restore_state``,
    ``cfg.collective``).

    ``plan`` (a ``runtime.chaos.FaultPlan``) is for fault-injection runs:
    the loop arms it a step and routes the step through a
    ``CollectiveQueue`` carrying it, so the queue.issue / queue.wait
    boundaries fire; the collective site fires through the ring tap
    (``chaos.install_collective_tap``) and the staging site through
    ``stage_fn`` (e.g. ``plan.stage``).  With ``plan=None`` the loop is a
    plain supervisor: watchdog, guards, heartbeat, checkpoints, restore on
    failure."""

    def __init__(self, trainer, ckpt_dir: str,
                 cfg: Optional[ElasticConfig] = None, *,
                 plan: Optional[chaos_lib.FaultPlan] = None,
                 stage_fn: Optional[Callable[[Any], Any]] = None,
                 profiler: Optional[Profiler] = None,
                 reshard: Any = None):
        if reshard is not None:
            raise NotImplementedError(
                "ElasticTrainer(reshard=...): the live mesh reshard tier "
                "(parallel/reshard.py, ReshardPolicy) is not ported: "
                "ROADMAP A.8, its reshard slice; every fault takes the "
                "restore tier")
        self.trainer = trainer
        self.cfg = cfg or ElasticConfig()
        self.plan = plan
        self.stage_fn = stage_fn
        self.profiler = profiler or Profiler()
        self.watchdog = Watchdog(self.cfg.step_timeout_s)
        self.heartbeat = Heartbeat(stall_after_s=self.cfg.stall_after_s)
        self.ckpt = Checkpointer(
            ckpt_dir, shards=getattr(trainer, "n", None),
            mirror=self.cfg.ckpt_mirror, keep_last=self.cfg.ckpt_keep_last,
            chaos=plan, recovery=self.profiler.recovery,
            events=self.profiler.events)
        self.loss_guard = chaos_lib.NormDriftGuard(
            factor=self.cfg.drift_factor, warmup=self.cfg.drift_warmup)
        self.gnorm_guard = chaos_lib.NormDriftGuard(
            factor=self.cfg.drift_factor, warmup=self.cfg.drift_warmup)
        self.wnorm_guard = chaos_lib.NormDriftGuard(
            factor=self.cfg.drift_factor, warmup=self.cfg.drift_warmup)
        self._guard_state = (self.cfg.master_guard if self.cfg.master_guard
                             is not None else plan is not None)
        # one step in flight at a time; the queue gives it the issue and
        # wait boundaries (the chaos hooks and the stall accounting)
        self.queue = CollectiveQueue(
            lambda state, batch: self.trainer.step(state, batch),
            trainer.cfg.collective, self.profiler, chaos=plan)
        if plan is not None and plan.events is None:
            plan.events = self.profiler.events

    # -- one attempt (runs inside the watchdog's worker thread) -----------------

    def _attempt(self, state, batch):
        if self.stage_fn is not None:
            batch = self.stage_fn(batch)
        ticket = self.queue.issue(state, batch)
        return self.queue.wait(ticket)

    # -- detection --------------------------------------------------------------

    def _check(self, metrics, step: int) -> Dict:
        """Host verdict on a finished step's outputs; raises
        ``IntegrityError`` on a tripped guard.  Returns the metrics as a
        dict."""
        if not isinstance(metrics, dict):
            metrics = {"loss": metrics}
        chaos_lib.check_step_diag(metrics, step)
        self.loss_guard.check(float(metrics["loss"]), "loss")
        if "grad_norm" in metrics:
            self.gnorm_guard.check(float(metrics["grad_norm"]), "grad_norm")
        return metrics

    def _check_state(self, state, step: int) -> None:
        """Validate what a checkpoint would persist (the masters and the
        optimizer state): non-finite values or a norm jump mean the state
        must not become the restore target.  One reduction each on the
        state's device."""
        if not self._guard_state:
            return
        total = 0.0
        for name in ("w_own", "w_master"):
            leaf = getattr(state, name, None)
            if leaf is None:
                continue
            if name == "w_master" and leaf.dim() == 2:
                leaf = leaf[0]          # DDP: the replicated vector once
            bad = int(torch.count_nonzero(~torch.isfinite(leaf)))
            if bad:
                raise chaos_lib.IntegrityError(
                    f"master shard '{name}' holds {bad} non-finite "
                    f"values after step {step} — refusing to accept "
                    "(a checkpoint of this state would poison recovery)")
            total += float(torch.linalg.vector_norm(
                leaf, dtype=torch.float64)) ** 2
        if total:
            self.wnorm_guard.check(total ** 0.5, "master_norm")
        for k, v in (getattr(state, "opt_state", None) or {}).items():
            if v.is_floating_point() and not bool(torch.isfinite(v).all()):
                raise chaos_lib.IntegrityError(
                    f"optimizer state '{k}' went non-finite at step {step}")

    # -- recovery ---------------------------------------------------------------

    def _classify(self, err: BaseException) -> str:
        if isinstance(err, chaos_lib.InjectedPreemption):
            return "preemption"
        if isinstance(err, DeviceHangError):
            return "hang"
        if isinstance(err, chaos_lib.WireIntegrityError):
            return "wire-corruption"
        if isinstance(err, chaos_lib.IntegrityError):
            return "corruption"
        if isinstance(err, chaos_lib.InjectedFault):
            return err.kind
        return "error"

    def _restore(self):
        """The last verified state of the checkpoint directory: every leaf
        audited, corrupt shards peer-repaired where a clean mirror exists,
        corrupt or torn steps walked past; refused
        (``CheckpointIntegrityError``) when no clean source exists."""
        if self.ckpt.latest_step() is None:
            raise RuntimeError(
                f"no checkpoint under {self.ckpt.directory} to restore "
                "from (run() saves step 0 before the loop; direct step() "
                "callers must checkpoint() first)")
        _step, tree = self.ckpt.restore_latest_verified()
        return self.trainer.restore_state(tree)

    def checkpoint(self, state) -> Optional[str]:
        """Persist ``state`` under the audited commit protocol.  A save
        interrupted by an injected durability fault (kill / diskfull) or
        a real ``OSError`` is absorbed and recorded while a verified
        restore target exists (the commit protocol keeps the previous
        step); a failed first save re-raises."""
        try:
            return self.ckpt.save(int(state.step), state,
                                  shards=getattr(self.trainer, "n", None))
        except (OSError, chaos_lib.InjectedFault) as err:
            if isinstance(err, chaos_lib.InjectedFault) and \
                    err.kind not in chaos_lib.DURABILITY_KINDS:
                raise
            self.profiler.recovery.record_ckpt_save_failure()
            self.profiler.events.instant(
                "ckpt.save_failed", step=int(state.step),
                error=repr(err)[:200])
            if self.ckpt.latest_step(verified=True) is None:
                raise
            return None

    def _emergency_dump(self, state, step_i: int) -> Optional[str]:
        """Dump before dying: when the ladder exhausts, persist the live
        pre-step state (if its tensors still hold their storage), flagged
        ``emergency`` in the manifest."""
        if not self.cfg.emergency_dump or state is None \
                or not chaos_lib.state_buffers_alive(state):
            return None
        try:
            path = self.ckpt.save(int(state.step), state, emergency=True,
                                  shards=getattr(self.trainer, "n", None))
        except Exception as err:  # noqa: BLE001 — dying anyway; stay loud
            self.profiler.events.instant(
                "ckpt.emergency_failed", step=step_i,
                error=repr(err)[:200])
            return None
        self.ckpt.wait_until_finished()
        self.profiler.recovery.record_emergency_dump()
        self.profiler.events.instant("ckpt.emergency", step=step_i,
                                     path=path)
        return path

    # -- the supervised step ----------------------------------------------------

    def step(self, state, batch,
             batch_fn: Optional[Callable[[int], Any]] = None
             ) -> Tuple[Any, Dict]:
        """One training step that survives detected faults: attempt ->
        detect -> (record, re-init if preempted, restore, backoff) ->
        retry, up to ``cfg.max_retries`` recoveries.  ``batch_fn`` (step ->
        batch) re-fetches the batch of a step the restore rewound to."""
        step_i = int(state.step)
        if self.plan is not None:
            self.plan.begin_step(step_i)
        t_fault = None
        event = None
        restored = False
        for attempt in range(self.cfg.max_retries + 1):
            try:
                new_state, metrics = self.watchdog.run(
                    self._attempt, state, batch,
                    timeout_s=self.cfg.step_timeout_s)
                metrics = self._check(metrics, step_i)
                self._check_state(new_state, step_i)
            except Exception as err:  # noqa: BLE001 — the recovery boundary
                kind = self._classify(err)
                now = time.monotonic()
                t_fault = t_fault if t_fault is not None else now
                ev = self.profiler.recovery.record_fault(
                    kind, step_i, site=getattr(err, "site", ""),
                    error=repr(err))
                event = event or ev
                self.profiler.events.instant(
                    "fault", kind=kind, step=step_i,
                    site=getattr(err, "site", ""))
                # a failed attempt's ticket may never complete: drop it
                self.queue.abandon()
                if attempt >= self.cfg.max_retries:
                    self.profiler.recovery.record_failed_recovery()
                    self._emergency_dump(state, step_i)
                    raise RecoveryExhausted(
                        f"step {step_i} failed {attempt + 1} times "
                        f"(last: {kind}); giving up after max_retries="
                        f"{self.cfg.max_retries}") from err
                if kind == "preemption":
                    # the process lost its device: control-plane re-init
                    # (a no-op for one process)
                    multihost.initialize()
                with self.profiler.bucket("restore"):
                    state = self._restore()
                restored = True
                if int(state.step) != step_i:
                    # the restore rewound past this step: the retry trains
                    # the rewound step, on its batch and its fault arming
                    step_i = int(state.step)
                    if batch_fn is not None:
                        batch = batch_fn(step_i)
                    if self.plan is not None:
                        self.plan.begin_step(step_i)
                time.sleep(self.cfg.backoff_s * (2 ** attempt))
            else:
                if t_fault is not None:
                    self.profiler.recovery.record_recovery(
                        time.monotonic() - t_fault, restored=restored,
                        event=event)
                    self.profiler.events.instant(
                        "recovered", step=step_i, restored=restored)
                self.heartbeat.beat()
                return new_state, metrics
        raise AssertionError("unreachable")

    # -- the supervised loop ----------------------------------------------------

    def run(self, state, batch_fn: Union[Callable[[int], Any], list],
            n_steps: int) -> Tuple[Any, Dict]:
        """Drive training to ``state.step == n_steps`` under supervision.
        ``batch_fn(step) -> sharded batch`` (a list works too) is called
        again for replayed steps, so it must be deterministic per step."""
        if callable(batch_fn):
            get_batch = batch_fn
        else:
            batches = list(batch_fn)
            get_batch = lambda i: batches[i]  # noqa: E731
        if self.ckpt.latest_step(verified=True) is None:
            self.checkpoint(state)
        metrics: Dict = {}
        while int(state.step) < n_steps:
            step_i = int(state.step)
            state, metrics = self.step(state, get_batch(step_i),
                                       batch_fn=get_batch)
            if (int(state.step) % self.cfg.ckpt_every == 0
                    or int(state.step) >= n_steps):
                self.checkpoint(state)
        return state, metrics

    def join(self, timeout_s: float = 60.0) -> int:
        """Wait for every timed-out attempt's thread (``Watchdog.join``);
        returns how many still run."""
        return self.watchdog.join(timeout_s)
