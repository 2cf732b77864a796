"""The metrics plane: serving-plane request telemetry, the trainers' static
codec facts and step metrics — the port of the JAX package's
``obs/metrics.py`` (``RequestSpans``, ``percentile``,
``codec_static_metrics``, ``Ewma``, ``MetricsSink``, ``use_sink``,
``active_sink``, ``host_observe``, ``tap``, ``codec_observed_error``,
``l2_norm``).

A trainer built with ``TrainConfig(obs_metrics=True)`` hands each step's
metric scalars (0-d tensors: ``loss``, ``grad_norm``, ``codec_obs_rel_err``,
``ef_resid_norm``) to the active sink through ``tap``.  JAX's tap is a
callback inside the compiled step that runs when the device reaches it;
here ``tap`` records the scalars with a CUDA event behind them and syncs
nothing: the sink converts them once the event has completed (its next
delivery looks without waiting; a read of ``latest`` or ``as_dict`` waits),
so they arrive after the step's own loss fetch.  ``tap(..., enabled=False)``
returns its argument and launches nothing (a thunk is never called): the
JAX package's compiled-out contract.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

import torch

from .events import EventStream

__all__ = ["Ewma", "MetricsSink", "RequestSpans", "active_sink",
           "codec_observed_error", "codec_static_metrics", "host_observe",
           "l2_norm", "percentile", "tap", "use_sink"]


class Ewma:
    """Exponentially-weighted moving average seeded with the first
    observation: ``value`` is exactly the first sample until the second
    arrives, never a decay up from zero (a zero-seeded EWMA reads its
    warm-up as a downward shift, which the drift residuals of
    ``tune.adapt`` would inherit)."""

    def __init__(self, alpha: float) -> None:
        assert 0.0 < alpha <= 1.0, alpha
        self.alpha = float(alpha)
        self.value: Optional[float] = None
        self._lock = threading.Lock()

    def update(self, v: float) -> float:
        v = float(v)
        with self._lock:
            self.value = v if self.value is None \
                else (1.0 - self.alpha) * self.value + self.alpha * v
            return self.value


class MetricsSink:
    """Ambient receiver of host-delivered step metrics: latest values,
    EWMAs of the loss and of the time between updates, and every update
    mirrored into an EventStream as counter events when one is attached."""

    def __init__(self, ewma_alpha: float = 0.1,
                 events: Optional[EventStream] = None,
                 static: Optional[Dict[str, Any]] = None) -> None:
        assert 0.0 < ewma_alpha <= 1.0
        self.ewma_alpha = ewma_alpha
        self.events = events
        self.static = dict(static or {})
        self._latest: Dict[str, float] = {}
        self._ewma: Dict[str, Ewma] = {}
        self._n_updates = 0
        self._last_t: Optional[float] = None
        self._lock = threading.Lock()
        # tapped steps not yet converted: (names, values, event or None,
        # host time of the tap)
        self._pending: Deque[Tuple[Tuple[str, ...], torch.Tensor, Any,
                                   float]] = deque()

    def _ewma_update(self, name: str, value: float) -> None:
        e = self._ewma.get(name)
        if e is None:
            e = self._ewma[name] = Ewma(self.ewma_alpha)
        e.update(value)

    def ewma_value(self, name: str) -> Optional[float]:
        e = self._ewma.get(name)
        return None if e is None else e.value

    def update(self, values: Dict[str, float],
               t: Optional[float] = None) -> None:
        """Deliver one step's values (``t``: the step's host time,
        default now)."""
        now = time.perf_counter() if t is None else t
        ev = self.events
        with self._lock:
            self._n_updates += 1
            for name, v in values.items():
                v = float(v)
                self._latest[name] = v
                if name == "loss":
                    self._ewma_update("loss", v)
            if self._last_t is not None:
                self._ewma_update("step_time_s", now - self._last_t)
            self._last_t = now
        if ev is not None:
            for name, v in values.items():
                ev.counter(f"metric.{name}", float(v))

    def defer(self, values: Dict[str, torch.Tensor]) -> None:
        """A tapped step's 0-d tensors, converted once the device has
        computed them: on a card one stacked copy into pinned host memory
        rides the stream behind the step, and an event marks it done.  The
        steps already done are delivered now, without a wait (``drain``)."""
        names = tuple(values)
        vec = torch.stack([values[k].to(torch.float32).reshape(())
                           for k in names])
        event = None
        if vec.is_cuda:
            host = torch.empty(vec.shape, dtype=vec.dtype, pin_memory=True)
            host.copy_(vec, non_blocking=True)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(vec.device))
            vec = host
        with self._lock:
            self._pending.append((names, vec, event, time.perf_counter()))
        self.drain(wait=False)

    def drain(self, wait: bool = True) -> None:
        """Deliver the pending tapped steps in order; without ``wait``,
        stop at the first whose values the device has not finished."""
        while True:
            with self._lock:
                if not self._pending:
                    return
                names, vec, event, t = self._pending[0]
                if event is not None and not event.query():
                    if not wait:
                        return
                    event.synchronize()
                self._pending.popleft()
            self.update(dict(zip(names, vec.tolist())), t=t)

    @property
    def latest(self) -> Dict[str, float]:
        self.drain()
        return self._latest

    @property
    def n_updates(self) -> int:
        self.drain()
        return self._n_updates

    def as_dict(self) -> Dict[str, Any]:
        self.drain()
        with self._lock:
            out: Dict[str, Any] = {
                "n_updates": self._n_updates,
                "latest": dict(self._latest),
                "loss_ewma": self.ewma_value("loss"),
                "step_time_ewma_s": self.ewma_value("step_time_s"),
            }
            if self.static:
                out["static"] = dict(self.static)
        return out


_ACTIVE_SINK: Optional[MetricsSink] = None


def active_sink() -> Optional[MetricsSink]:
    return _ACTIVE_SINK


class use_sink:
    """Context manager binding the ambient sink ``host_observe`` delivers
    to (the previous one restored on exit)."""

    def __init__(self, sink: Optional[MetricsSink]) -> None:
        self.sink = sink

    def __enter__(self) -> Optional[MetricsSink]:
        global _ACTIVE_SINK
        self._prev = _ACTIVE_SINK
        _ACTIVE_SINK = self.sink
        return self.sink

    def __exit__(self, *exc: Any) -> None:
        global _ACTIVE_SINK
        _ACTIVE_SINK = self._prev


def host_observe(values: Dict[str, float]) -> None:
    """Host-side metric delivery (e.g. the drift plane's ``tune.drift.*``
    values): a no-op without an active sink."""
    sink = _ACTIVE_SINK
    if sink is not None:
        sink.update(values)


def tap(out: Any, metrics: Any, enabled: bool = True) -> Any:
    """Hand ``metrics`` (name -> 0-d tensor, or a zero-argument thunk
    returning that dict) to the active sink and return ``out`` unchanged.
    ``enabled=False`` returns ``out`` itself and computes nothing (a thunk
    is never called); without an active sink nothing is computed either.
    No sync: the sink converts the values once the device has them."""
    if not enabled:
        return out
    sink = _ACTIVE_SINK
    if sink is None:
        return out
    if callable(metrics):
        metrics = metrics()
    if metrics:
        sink.defer({k: v.detach() for k, v in sorted(metrics.items())})
    return out


def codec_observed_error(codec: Any, x: torch.Tensor,
                         quantized: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Observed per-unit relative roundtrip error of ``codec`` on ``x``
    (the ranks' rows ``[n, L]``, or one flat vector), the maximum over
    every unit of every rank (JAX's per-device value under ``pmax``):
    max |x - roundtrip(x)| / max |x| over each compression unit of
    ``pad_elems`` elements.  A unit is contiguous in the flat layout (the
    JAX package's definition); in the sublane layout (``unit_elems`` a
    whole (block, 128)-lane tile) it is a tile's column, the block the
    codec scales together.  ``quantized`` is roundtrip(x) where the caller
    has it (the error-feedback wire vector); otherwise one roundtrip is
    spent, every rank's row in one codec call."""
    L = x.shape[-1]
    c = codec.for_payload(L, x.device)
    if quantized is None:
        quantized = c.roundtrip(x.reshape(-1)).reshape(x.shape)
    pe = c.pad_elems
    lanes = c.unit_elems(L) // pe
    units = x.reshape(-1, pe, lanes).to(torch.float32)
    inf = float("inf")        # the max-abs norm: no |x| temporary
    err = torch.linalg.vector_norm(
        units - quantized.reshape(-1, pe, lanes).to(torch.float32), inf,
        dim=1)
    unit_max = torch.linalg.vector_norm(units, inf, dim=1)
    return (err / unit_max.clamp_min(1e-20)).amax()


def l2_norm(x: torch.Tensor) -> torch.Tensor:
    """The global L2 norm of the ranks' rows (JAX's ``psum`` of each
    device's squares, then the square root)."""
    return torch.sqrt((x.to(torch.float32) ** 2).sum())


def codec_static_metrics(codec: Any, n_elems: int) -> Dict[str, Any]:
    """A codec's static facts for a trainer's ``obs_static_metrics``:
    declared compression ratio, declared error bound, wire bytes of one
    pass of an [n_elems] gradient ({} without a codec)."""
    if codec is None:
        return {}
    return {"codec": codec.name,
            "compression_ratio_vs_f32":
                round(float(codec.compression_ratio_vs_f32), 4),
            "declared_error_bound": float(codec.error_bound),
            "wire_bytes_per_pass": int(codec.wire_bytes(n_elems))}


def percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile over an ALREADY-SORTED list — tiny and
    dependency-free so the gate tooling can share it.  An EMPTY series
    returns NaN: the caller gets an explicitly not-a-number answer it
    can flag (RequestSpans.summary's ``*_empty``) instead of an assert
    that turns "no requests completed yet" into a crash in whatever
    thread asked for a summary."""
    assert 0.0 <= q <= 100.0, q
    if not sorted_vals:
        return float("nan")
    idx = min(len(sorted_vals) - 1,
              max(0, int(round(q / 100.0 * (len(sorted_vals) - 1)))))
    return float(sorted_vals[idx])


class RequestSpans:
    """Per-request serving telemetry: bounded sample series for queue
    wait, TTFT (submit -> first new token), TPOT (mean inter-token time
    after the first) and total latency, plus one ``serve.request`` span
    per completion on the event stream (lane="serve", request uid).

    Bounded with honest overflow, same contract as the event ring: at
    most ``max_samples`` per series, every further completion counted in
    ``samples_dropped`` so a truncated summary can never read as
    complete.  Thread-safe (the engine loop records; summaries may be
    read from anywhere)."""

    SERIES: Tuple[str, ...] = ("queue_wait_s", "ttft_s", "tpot_s",
                               "latency_s")

    def __init__(self, events: Optional[EventStream] = None,
                 max_samples: int = 4096) -> None:
        assert max_samples > 0
        self.events = events
        self.max_samples = int(max_samples)
        self._series: Dict[str, List[float]] = {k: [] for k in self.SERIES}
        self.completed = 0
        self.samples_dropped = 0
        self._lock = threading.Lock()

    def record(self, uid: int, *, t_submit: float, t_admit: float,
               t_first: float, t_done: float, n_tokens: int) -> None:
        """One completed request (timestamps in perf_counter seconds)."""
        vals = {"queue_wait_s": t_admit - t_submit,
                "ttft_s": t_first - t_submit,
                "tpot_s": ((t_done - t_first) / (n_tokens - 1)
                           if n_tokens > 1 else 0.0),
                "latency_s": t_done - t_submit}
        with self._lock:
            self.completed += 1
            if len(self._series["latency_s"]) >= self.max_samples:
                self.samples_dropped += 1
            else:
                for k, v in vals.items():
                    self._series[k].append(float(v))
        if self.events is not None:
            self.events.emit(
                "span", "serve.request", t_ns=int(t_submit * 1e9),
                dur_ns=int((t_done - t_submit) * 1e9),
                attrs={"lane": "serve", "uid": uid, "tokens": n_tokens,
                       "ttft_s": round(vals["ttft_s"], 6),
                       "tpot_s": round(vals["tpot_s"], 6),
                       "queue_wait_s": round(vals["queue_wait_s"], 6)})

    def summary(self) -> Dict[str, Any]:
        """mean / p50 / p95 / p99 per series + completion/drop
        accounting.
        An empty series reports not-a-number stats WITH an explicit
        ``<series>_empty: True`` flag — "no samples" must read as no
        samples, never as a silently absent (or zero) latency row.  The
        not-a-number spelling here is ``None`` (JSON null), NOT float
        NaN: summaries land verbatim in banked JSON artifacts, and
        ``json.dump`` would serialize NaN as a bare token strict
        parsers reject."""
        with self._lock:
            series = {k: sorted(v) for k, v in self._series.items()}
            completed, dropped = self.completed, self.samples_dropped
        out: Dict[str, Any] = {"completed": completed,
                               "samples_dropped": dropped}
        for name, vals in series.items():
            base = name[:-2] if name.endswith("_s") else name
            if not vals:
                out[f"{base}_empty"] = True
                out[f"{base}_mean_s"] = None
                out[f"{base}_p50_s"] = None
                out[f"{base}_p95_s"] = None
                out[f"{base}_p99_s"] = None
                continue
            out[f"{base}_mean_s"] = round(sum(vals) / len(vals), 6)
            out[f"{base}_p50_s"] = round(percentile(vals, 50.0), 6)
            out[f"{base}_p95_s"] = round(percentile(vals, 95.0), 6)
            out[f"{base}_p99_s"] = round(percentile(vals, 99.0), 6)
        return out
