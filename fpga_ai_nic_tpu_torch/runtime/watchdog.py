"""Failure detection and recovery — the port of the JAX package's
``runtime/watchdog.py``.

- ``Watchdog.run`` bounds a device-touching call with a wall-clock limit:
  a call that does not return in time raises ``DeviceHangError`` instead
  of blocking the caller forever.
- ``Heartbeat`` is the training loop's liveness probe: steps beat it, a
  monitor (or the loop itself) checks its age.
- ``run_with_recovery`` retries a step from the last known-good state with
  exponential backoff.

A wedged call cannot be cancelled from Python: its thread runs on until
the call returns.  So the worker is a daemon thread (a hung call does not
keep the interpreter alive), and the watchdog keeps every worker it
started: ``join`` waits for them, with a bound, so a caller can make sure
that no timed-out call is still launching work before it moves on (a
daemon thread caught inside a CUDA call at interpreter exit can crash the
process).

Threads and PyTorch: grad mode and the current CUDA stream are per thread.
The worker takes the caller's, so a call runs there as it would have run
on the caller's thread.  CUDA calls return before the card has finished;
a caller that wants the bound to cover the device work synchronises
inside the call (``parallel.elastic`` waits on its ticket there).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Tuple

import torch


class DeviceHangError(RuntimeError):
    """A device-touching call exceeded its watchdog timeout."""


def _caller_modes() -> Tuple[bool, Optional[Any]]:
    """The caller's grad mode and current CUDA stream (None when CUDA was
    never initialised here)."""
    stream = None
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        stream = torch.cuda.current_stream()
    return torch.is_grad_enabled(), stream


class Watchdog:
    """Run device-touching callables under a wall-clock timeout, one
    daemon worker thread a call."""

    def __init__(self, timeout_s: float = 300.0):
        self.timeout_s = timeout_s
        self._threads: List[threading.Thread] = []
        self._lock = threading.Lock()

    def run(self, fn: Callable, *args, timeout_s: Optional[float] = None,
            **kwargs) -> Any:
        result: dict = {}
        done = threading.Event()
        grad, stream = _caller_modes()

        def target():
            try:
                with torch.set_grad_enabled(grad):
                    if stream is not None:
                        with torch.cuda.stream(stream):
                            result["value"] = fn(*args, **kwargs)
                    else:
                        result["value"] = fn(*args, **kwargs)
            except BaseException as e:      # noqa: BLE001 — re-raised below
                result["error"] = e
            finally:
                done.set()

        limit = timeout_s if timeout_s is not None else self.timeout_s
        worker = threading.Thread(target=target, daemon=True,
                                  name="watchdog")
        with self._lock:
            self._threads = [t for t in self._threads if t.is_alive()]
            self._threads.append(worker)
        worker.start()
        if not done.wait(limit):
            raise DeviceHangError(
                f"{getattr(fn, '__name__', fn)!r} exceeded {limit:.1f}s — "
                "the device or its host loop presumed hung")
        if "error" in result:
            raise result["error"]
        return result["value"]

    def join(self, timeout_s: float = 60.0) -> int:
        """Wait up to ``timeout_s`` in all for every worker this watchdog
        started; returns how many are still running after it."""
        deadline = time.monotonic() + timeout_s
        with self._lock:
            threads = list(self._threads)
        for t in threads:
            t.join(max(0.0, deadline - time.monotonic()))
        with self._lock:
            self._threads = [t for t in self._threads if t.is_alive()]
            return len(self._threads)


@dataclass
class Heartbeat:
    """Liveness probe for a training loop: the loop calls ``beat()`` every
    step; anyone may call ``stalled()`` / ``assert_alive()``."""

    stall_after_s: float = 600.0

    def __post_init__(self):
        self._last = time.monotonic()
        self._beats = 0
        self._lock = threading.Lock()

    def beat(self) -> None:
        with self._lock:
            self._last = time.monotonic()
            self._beats += 1

    @property
    def beats(self) -> int:
        return self._beats

    def age_s(self) -> float:
        with self._lock:
            return time.monotonic() - self._last

    def stalled(self) -> bool:
        return self.age_s() > self.stall_after_s

    def assert_alive(self) -> None:
        age = self.age_s()
        if age > self.stall_after_s:
            raise DeviceHangError(
                f"no heartbeat for {age:.1f}s (> {self.stall_after_s:.1f}s)")


def run_with_recovery(step_fn: Callable[[Any, Any], Tuple[Any, Any]],
                      state: Any, batch: Any, *,
                      max_retries: int = 2,
                      backoff_s: float = 1.0,
                      watchdog: Optional[Watchdog] = None,
                      restore_fn: Optional[Callable[[], Any]] = None,
                      on_failure: Optional[Callable[[Exception], None]] = None,
                      ) -> Tuple[Any, Any]:
    """Run one training step with retries from known-good state.

    On failure (``DeviceHangError`` from the watchdog included) the state
    comes from ``restore_fn`` (a checkpoint load), or is the pre-step
    state again (the port's steps make new tensors and update nothing in
    place), and the step is retried after an exponential backoff; the last
    error is raised after ``max_retries``.  A pre-step state whose tensors
    lost their storage (``chaos.state_buffers_alive``) cannot be retried
    without ``restore_fn``: that raises at once."""
    from .chaos import state_buffers_alive

    err: Optional[Exception] = None
    for attempt in range(max_retries + 1):
        src = state if restore_fn is None or attempt == 0 else restore_fn()
        if attempt > 0 and restore_fn is None \
                and not state_buffers_alive(src):
            raise RuntimeError(
                "cannot retry: the failed step released the state's "
                "buffers; pass restore_fn=<checkpoint restore> to "
                "run_with_recovery") from err
        try:
            if watchdog is not None:
                return watchdog.run(step_fn, src, batch)
            return step_fn(src, batch)
        except Exception as e:      # noqa: BLE001 — retry boundary
            err = e
            if on_failure is not None:
                on_failure(e)
            if attempt < max_retries:
                time.sleep(backoff_s * (2 ** attempt))
    raise err
