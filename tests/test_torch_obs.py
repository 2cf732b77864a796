"""The port's telemetry plane (``obs/``: the event stream, the step metrics'
``tap``, the timeline; ``obs_demo``) against the JAX package's
``tests/test_obs.py`` (all but ``obs_gate``, which the port does not have).

- the event stream: every kind, bounded with drop accounting, the JSONL
  round trip and its schema check, spans recorded on an exception;
- ``tap``: disabled, the identity that computes nothing; enabled, the
  values reach the ambient sink (its counters too) and no sink is a no-op;
- the trainers' ``obs_metrics=True``: ``DPTrainer`` and ``FSDPTrainer``
  deliver JAX's keys with values equal to JAX's (loss at rtol 1e-5,
  norms at 1e-4) and leave the numerics bitwise alone, the codec's
  observed error within its declared bound; ``DDPTrainer`` adds nothing
  and ``QueuedDDPTrainer`` delivers the loss on the host, as JAX's do;
- the timeline: the port's ``chrome_trace`` equal to JAX's on the same
  host events and device intervals, and its CLI;
- the demo, held against JAX's ``chrome_trace`` (JAX's own demo test is
  red, C.4).
"""

import json
import os

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import jax
import jax.numpy as jnp

from fpga_ai_nic_tpu.models import mlp as jax_mlp
from fpga_ai_nic_tpu.obs import MetricsSink as JaxSink
from fpga_ai_nic_tpu.obs import timeline as jax_timeline
from fpga_ai_nic_tpu.obs import use_sink as jax_use_sink
from fpga_ai_nic_tpu.parallel import DPTrainer as JaxDPTrainer, make_mesh
from fpga_ai_nic_tpu.parallel.fsdp import FSDPTrainer as JaxFSDPTrainer
from fpga_ai_nic_tpu.utils import config as jcfg
from fpga_ai_nic_tpu_torch import obs_demo
from fpga_ai_nic_tpu_torch.models import mlp
from fpga_ai_nic_tpu_torch.obs import events as events_lib
from fpga_ai_nic_tpu_torch.obs import metrics as metrics_lib
from fpga_ai_nic_tpu_torch.obs import timeline
from fpga_ai_nic_tpu_torch.obs.events import EventStream, read_jsonl
from fpga_ai_nic_tpu_torch.obs.metrics import MetricsSink, use_sink
from fpga_ai_nic_tpu_torch.parallel import FSDPTrainer
from fpga_ai_nic_tpu_torch.parallel.ddp import DDPTrainer
from fpga_ai_nic_tpu_torch.parallel.mesh import VirtualRanks
from fpga_ai_nic_tpu_torch.parallel.queued import QueuedDDPTrainer
from fpga_ai_nic_tpu_torch.parallel.train import DPTrainer
from fpga_ai_nic_tpu_torch.runtime.queue import CollectiveQueue
from fpga_ai_nic_tpu_torch.utils import config
from fpga_ai_nic_tpu_torch.utils import trace_analysis as ta
from fpga_ai_nic_tpu_torch.utils.observability import Profiler

SIZES = (32, 64, 10)
CPU = torch.device("cpu")
MCFG = config.MLPConfig(layer_sizes=SIZES, dtype="float32")
JMCFG = jcfg.MLPConfig(layer_sizes=SIZES, dtype="float32")


def _data(n=64):
    r = np.random.default_rng(0)
    return (r.standard_normal((n, 32)).astype(np.float32),
            r.integers(0, 10, n).astype(np.int32))


def _jax_params():
    return jax.tree_util.tree_map(np.asarray, jax_mlp.init(
        jax.random.PRNGKey(0), JMCFG))


def _cfg(mod, axis="dp", **kw):
    return mod.TrainConfig(global_batch=64, mesh=mod.MeshConfig(**{axis: 8}),
                           **kw)


def _port(cls=DPTrainer, axis="dp", **kw):
    tr = cls(lambda p, b: mlp.loss_fn(p, b, MCFG), VirtualRanks(8, CPU),
             _cfg(config, axis, **kw))
    state = tr.init_state(mlp.from_jax_params(_jax_params(), "cpu"))
    x, y = _data()
    return tr, state, tr.shard_batch((torch.from_numpy(x),
                                      torch.from_numpy(y)))


def _jax(cls=JaxDPTrainer, axis="dp", **kw):
    tr = cls(lambda p, b: jax_mlp.loss_fn(p, b, JMCFG),
             make_mesh(jcfg.MeshConfig(**{axis: 8})), _cfg(jcfg, axis, **kw))
    state = tr.init_state(jax.tree_util.tree_map(jnp.asarray,
                                                 _jax_params()))
    x, y = _data()
    return tr, state, tr.shard_batch((jnp.asarray(x), jnp.asarray(y)))


def _jax_metrics(**kw):
    tr, state, batch = _jax(**kw)
    sink = JaxSink(static=tr.obs_static_metrics())
    with jax_use_sink(sink):
        _, loss = tr.step(state, batch)
        jax.block_until_ready(loss)
    return sink


# ---------------------------------------------------------------------------
# events
# ---------------------------------------------------------------------------

def test_event_stream_records_all_kinds():
    ev = EventStream()
    with ev.span("phase", stage=1):
        pass
    ev.instant("fault", kind="hang")
    ev.counter("loss", 2.5)
    snap = ev.snapshot()
    assert [e["kind"] for e in snap] == ["span", "instant", "counter"]
    assert snap[0]["dur_ns"] >= 0 and snap[0]["attrs"] == {"stage": 1}
    assert snap[2]["value"] == 2.5
    s = ev.summary()
    assert s["schema_version"] == events_lib.SCHEMA_VERSION
    assert s["spans"]["phase"]["count"] == 1
    assert s["counters"]["loss"] == 2.5
    assert s["events_dropped"] == 0


def test_event_stream_bounded_with_drop_accounting():
    ev = EventStream(capacity=8)
    for i in range(20):
        ev.counter("c", float(i))
    s = ev.summary()
    assert (s["recorded"], s["emitted"], s["events_dropped"]) == (8, 20, 12)
    assert [e["value"] for e in ev.snapshot()] == list(range(12, 20))


def test_event_stream_jsonl_round_trip(tmp_path):
    ev = EventStream()
    with ev.span("step", i=0):
        ev.instant("inner")
    path = ev.dump_jsonl(str(tmp_path / "events.jsonl"))
    header, events = read_jsonl(path)
    assert header["schema_version"] == events_lib.SCHEMA_VERSION
    assert header["events_dropped"] == 0
    assert [e["name"] for e in events] == ["inner", "step"]
    assert abs(events[0]["t_unix_ns"] - header["t0_unix_ns"]) < 60 * 1e9


def test_read_jsonl_rejects_unknown_schema(tmp_path):
    p = tmp_path / "bad.jsonl"
    p.write_text(json.dumps({"schema_version": 999}) + "\n")
    with pytest.raises(ValueError, match="schema"):
        read_jsonl(str(p))


def test_span_records_on_exception():
    ev = EventStream()
    with pytest.raises(RuntimeError):
        with ev.span("dying"):
            raise RuntimeError("x")
    assert ev.summary()["spans"]["dying"]["count"] == 1


# ---------------------------------------------------------------------------
# the tap
# ---------------------------------------------------------------------------

def test_tap_disabled_is_identity_and_computes_nothing():
    x = torch.tensor(1.0)
    called = []

    def thunk():
        called.append(1)
        return {"m": x * 2.0}

    sink = MetricsSink()
    with use_sink(sink):
        assert metrics_lib.tap(x, thunk, enabled=False) is x
    assert not called and sink.n_updates == 0
    # no active sink: nothing computed either
    assert metrics_lib.tap(x, thunk) is x and not called


def test_tap_delivers_to_ambient_sink():
    ev = EventStream()
    sink = MetricsSink(events=ev)
    x = torch.arange(4.0)
    with use_sink(sink):
        out = metrics_lib.tap(x.sum(), {"norm": torch.sqrt((x * x).sum())})
    assert float(out) == 6.0
    assert sink.latest["norm"] == pytest.approx(np.sqrt(14.0))
    assert ev.summary()["counters"]["metric.norm"] == \
        pytest.approx(np.sqrt(14.0))
    metrics_lib.tap(x.sum(), {"norm": x.sum()})     # no sink: a no-op


def test_sink_ewma_and_step_time():
    sink = MetricsSink(ewma_alpha=0.5)
    sink.update({"loss": 4.0})
    sink.update({"loss": 2.0})
    d = sink.as_dict()
    assert d["loss_ewma"] == pytest.approx(3.0)
    assert d["n_updates"] == 2 and d["step_time_ewma_s"] > 0


def test_metric_builders_equal_jax():
    """``codec_observed_error`` (each rank's row against JAX's per-device
    value under pmax) and ``l2_norm`` on the same numpy rows."""
    from fpga_ai_nic_tpu.compress import get_codec as jax_codec
    from fpga_ai_nic_tpu.obs import metrics as jax_metrics
    from fpga_ai_nic_tpu_torch.compress import get_codec
    r = np.random.default_rng(3)
    x = r.standard_normal((4, 2048)).astype(np.float32)
    for name in ("bfp", "int8"):
        want = max(float(jax_metrics.codec_observed_error(
            jax_codec(name), jnp.asarray(row))) for row in x)
        got = float(metrics_lib.codec_observed_error(get_codec(name),
                                                     torch.from_numpy(x)))
        assert got == pytest.approx(want, rel=1e-6)
    assert float(metrics_lib.l2_norm(torch.from_numpy(x))) == \
        pytest.approx(float(jax_metrics.l2_norm(jnp.asarray(x))), rel=1e-6)


# ---------------------------------------------------------------------------
# the trainers' obs_metrics
# ---------------------------------------------------------------------------

def test_trainer_metrics_disabled_deliver_nothing():
    tr, state, batch = _port(collective=config.CollectiveConfig(
        impl="ring"), obs_metrics=False)
    sink = MetricsSink()
    with use_sink(sink):
        tr.step(state, batch)
    assert sink.n_updates == 0


def test_trainer_metrics_enabled_equal_jax_and_preserve_numerics():
    coll = dict(collective=config.CollectiveConfig(impl="ring"))
    tr0, state0, batch = _port(obs_metrics=False, **coll)
    tr1, state1, _ = _port(obs_metrics=True, **coll)
    sink = MetricsSink(static=tr1.obs_static_metrics())
    with use_sink(sink):
        state1, loss1 = tr1.step(state1, batch)
    state0, loss0 = tr0.step(state0, batch)
    assert float(loss1) == float(loss0)
    assert torch.equal(state1.w_own, state0.w_own)
    assert set(sink.latest) == {"grad_norm", "loss"}
    want = _jax_metrics(collective=jcfg.CollectiveConfig(impl="ring"),
                        obs_metrics=True).latest
    assert set(want) == set(sink.latest)
    assert sink.latest["loss"] == pytest.approx(want["loss"], rel=1e-5)
    assert sink.latest["grad_norm"] == pytest.approx(want["grad_norm"],
                                                     rel=1e-4)
    assert sink.static["n_devices"] == 8


@pytest.mark.parametrize("codec", ["bfp", "topk"])
def test_trainer_codec_metrics_declared_vs_observed(codec):
    """BFP's observed per-unit relative error respects its declared bound;
    the error-feedback codec (top-k) reports its residual mass; the keys
    are JAX's and the loss and norms equal its values."""
    tr, state, batch = _port(collective=config.CollectiveConfig(
        impl="ring", codec=codec), obs_metrics=True)
    sink = MetricsSink(static=tr.obs_static_metrics())
    with use_sink(sink):
        tr.step(state, batch)
    want = _jax_metrics(collective=jcfg.CollectiveConfig(impl="ring",
                                                         codec=codec),
                        obs_metrics=True).latest
    assert set(sink.latest) == set(want)
    for k in ("loss", "grad_norm") + (("ef_resid_norm",)
                                      if codec == "topk" else ()):
        assert sink.latest[k] == pytest.approx(want[k], rel=1e-4), k
    if codec == "bfp":
        bound = sink.static["declared_error_bound"]
        assert 0 < sink.latest["codec_obs_rel_err"] <= bound * (1 + 1e-6)
        assert want["codec_obs_rel_err"] <= bound * (1 + 1e-6)
    else:
        assert sink.latest["ef_resid_norm"] > 0
        assert sink.static["codec"] == "topk"


@pytest.mark.parametrize("coll", [
    dict(compression=config.BFPConfig(codec="pallas"), fused_kernel=True,
         fused_optimizer=True),
    dict(codec="int8", codec_opts=(("backend", "pallas"),),
         fused_optimizer=True),
], ids=["bfp-sublane-fused", "int8-sublane"])
def test_sublane_codecs_stay_within_declared_bound(coll):
    """The main path's codecs (the sublane layout the card's kernels
    take, here their plain versions): the observed error, a block being a
    tile's column there, stays within the declared bound."""
    tr, state, batch = _port(collective=config.CollectiveConfig(
        impl="ring", **coll), obs_metrics=True)
    sink = MetricsSink(static=tr.obs_static_metrics())
    with use_sink(sink):
        tr.step(state, batch)
    bound = sink.static["declared_error_bound"]
    assert 0 < sink.latest["codec_obs_rel_err"] <= bound


def test_trainer_metrics_fused_route_with_integrity():
    """The fused optimizer route reads ``grad_norm`` from the reduced
    shard (with integrity on: the diag's), and the values equal the
    unfused route's."""
    out = {}
    for fused in (False, True):
        tr, state, batch = _port(collective=config.CollectiveConfig(
            impl="ring", codec="bfp", fused_optimizer=fused,
            integrity_check=fused), obs_metrics=True)
        sink = MetricsSink()
        with use_sink(sink):
            tr.step(state, batch)
        out[fused] = sink.latest
    assert out[True]["grad_norm"] == pytest.approx(out[False]["grad_norm"],
                                                   rel=1e-6)
    assert out[True]["loss"] == out[False]["loss"]


def test_fsdp_metrics_tap():
    coll = config.CollectiveConfig(impl="ring", codec="topk")
    tr, state, batch = _port(FSDPTrainer, "fsdp", collective=coll,
                             obs_metrics=True)
    sink = MetricsSink()
    with use_sink(sink):
        tr.step(state, batch)
    want = _jax_metrics(cls=JaxFSDPTrainer, axis="fsdp",
                        collective=jcfg.CollectiveConfig(impl="ring",
                                                         codec="topk"),
                        obs_metrics=True).latest
    assert set(sink.latest) == set(want) == {
        "grad_norm", "loss", "ef_resid_norm", "codec_obs_rel_err"}
    for k in ("loss", "grad_norm", "ef_resid_norm"):
        assert sink.latest[k] == pytest.approx(want[k], rel=1e-4), k
    tr2, state2, _ = _port(FSDPTrainer, "fsdp", collective=config.
                           CollectiveConfig(impl="ring"), obs_metrics=True)
    sink2 = MetricsSink()
    with use_sink(sink2):
        tr2.step(state2, batch)
    assert set(sink2.latest) == {"grad_norm", "loss"}


def test_ddp_adds_nothing_and_queued_delivers_the_loss():
    ranks = VirtualRanks(8, CPU)
    cfg = _cfg(config, collective=config.CollectiveConfig(impl="ring"),
               obs_metrics=True)
    x, y = _data()
    out = {}
    for cls in (DDPTrainer, QueuedDDPTrainer):
        tr = cls(lambda p, b: mlp.loss_fn(p, b, MCFG), ranks, cfg)
        st = tr.init_state(mlp.from_jax_params(_jax_params(), "cpu"))
        sink = MetricsSink()
        with use_sink(sink):
            st, loss = tr.step(st, tr.shard_batch((torch.from_numpy(x),
                                                   torch.from_numpy(y))))
        out[cls] = (sink, float(loss))
    assert out[DDPTrainer][0].n_updates == 0
    sink, loss = out[QueuedDDPTrainer]
    assert sink.latest == {"loss": loss}


# ---------------------------------------------------------------------------
# queue tickets and the timeline
# ---------------------------------------------------------------------------

def _queue_run():
    prof = Profiler()
    q = CollectiveQueue(lambda a: a * 2.0,
                        config.CollectiveConfig(impl="ring"), prof)
    with prof.bucket("grads"):
        t1 = q.issue(torch.ones(64), raw_bytes=256, wire_bytes=64)
        t2 = q.issue(torch.ones(64), raw_bytes=256, wire_bytes=64)
    q.wait(t1)
    q.wait(t2)
    return prof


def test_queue_emits_ticket_spans():
    spans = [e for e in _queue_run().events.snapshot()
             if e["kind"] == "span" and e["name"] == "collective"]
    assert len(spans) == 2
    a = spans[0]["attrs"]
    assert a["lane"] == "queue" and a["uid"] == 1
    assert a["wire_bytes"] == 64 and a["raw_bytes"] == 256
    assert a["stall_s"] >= 0 and a["overlap_s"] >= 0


_DEV = [{"plane": "/device:GPU:0", "line": "stream 7",
         "name": "gemm", "start_ns": 1000, "end_ns": 5000, "cls": "sync"},
        {"plane": "/device:GPU:0", "line": "stream 13",
         "name": "ring_rs_kernel", "start_ns": 2000, "end_ns": 9000,
         "cls": "async"}]


@pytest.mark.parametrize("anchored", [True, False])
def test_timeline_equals_jax_chrome_trace(tmp_path, anchored):
    """Host spans, queue tickets and device intervals on one axis: the
    port's ``chrome_trace`` is JAX's, event for event (with the anchor
    span present, and without: the offset_unknown marker)."""
    prof = _queue_run()
    if anchored:
        with prof.events.span(timeline.DEFAULT_ANCHOR_SPAN):
            pass
    path = prof.dump_events(str(tmp_path / "events.jsonl"))
    header, host_events = read_jsonl(path)
    mine = timeline.chrome_trace(host_events, _DEV, header=header)
    want = jax_timeline.chrome_trace(
        host_events, _DEV, anchor_span=timeline.DEFAULT_ANCHOR_SPAN,
        header=header)
    assert json.loads(json.dumps(mine)) == json.loads(json.dumps(want))
    od = mine["otherData"]
    assert od["device_alignment"] == ("anchored" if anchored
                                      else "offset_unknown")
    assert od["device_offset_ns"] != 0
    assert {e["pid"] for e in mine["traceEvents"] if e["ph"] == "X"} == \
        {1, 2, 3}
    assert min(e["ts"] for e in mine["traceEvents"] if e["ph"] == "X") >= 0


def test_timeline_cli_writes_perfetto_json(tmp_path):
    events_path = _queue_run().dump_events(str(tmp_path / "events.jsonl"))
    out = str(tmp_path / "timeline.json")
    assert timeline.main([events_path, "-o", out]) == 0
    assert json.load(open(out))["traceEvents"]
    with pytest.raises(ValueError, match="exactly one"):
        timeline.build()


def test_trace_analysis_cli_error_path(tmp_path):
    assert ta.main([str(tmp_path / "nonexistent-trace-dir")]) == 1


# ---------------------------------------------------------------------------
# the demo
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("trace", [False, True])
def test_obs_demo_emits_loadable_timeline(tmp_path, trace):
    out = str(tmp_path / "demo")
    summary = obs_demo.run(steps=3, out_dir=out, trace=trace, device="cpu")
    tl = json.load(open(os.path.join(out, "timeline.json")))
    pids = {e["pid"] for e in tl["traceEvents"] if e["ph"] == "X"}
    assert {1, 2} <= pids                  # host spans + queue tickets
    assert summary["metrics"]["latest"]["loss"] == \
        pytest.approx(summary["final_loss"])
    assert set(summary["metrics"]["latest"]) == {
        "codec_obs_rel_err", "grad_norm", "integrity_err", "loss"}
    assert summary["metrics"]["n_updates"] == 3
    assert summary["profiler"]["collectives"]["completed"] == 3
    header, events = read_jsonl(os.path.join(out, "events.jsonl"))
    assert header["events_dropped"] == 0
    assert any(e["name"] == "collective" for e in events)
    names = {e["name"] for e in events}
    assert (timeline.DEFAULT_ANCHOR_SPAN in names) == trace
    # the timeline is JAX's rendering of the same events file
    want = jax_timeline.chrome_trace(
        events, anchor_span=timeline.DEFAULT_ANCHOR_SPAN, header=header)
    assert tl == json.loads(json.dumps(want))
    if trace:
        rep = ta.summarize(ta.analyze_any(os.path.join(out, "torch_trace")))
        assert rep["sync_busy_s"] > 0 and rep["async_s"] == 0.0
