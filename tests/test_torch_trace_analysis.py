"""The port's trace analysis (``utils/trace_analysis.py``, on the chrome-trace
JSON ``torch.profiler`` exports) against the JAX package's
``tests/test_trace_analysis.py``: the interval math equal to JAX's
functions, the whole-name classification of the port's ring and codec
kernels, the per-card report on fixture traces in kineto's format (two
streams, copies, a collective hidden by the side stream, one exposed) equal
to JAX's ``_attribution_report`` where compute runs on other streams than
the collectives, ``summarize`` equal to JAX's, the device intervals, the
CPU fallback on a real ``torch.profiler`` trace, and the CLI.
"""

import gzip
import json

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from fpga_ai_nic_tpu.utils import trace_analysis as jta
from fpga_ai_nic_tpu_torch.utils import trace_analysis as ta

BASE_NS = 1_792_000_000_000_000_000


def _kernel(name, ts_us, dur_us, stream, device=0, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "pid": device,
            "tid": stream, "ts": ts_us, "dur": dur_us,
            "args": {"device": device, "stream": stream,
                     "correlation": 1, "External id": 1}}


def _fixture(tmp_path, events, gz=False, base=BASE_NS):
    """A kineto-shaped trace directory: metadata, host events, flow
    events and the given device events."""
    evs = [{"ph": "M", "name": "process_name", "pid": 0,
            "args": {"name": "GPU 0"}},
           {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 4242,
            "tid": 4242, "ts": 0.0, "dur": 50.0, "args": {}},
           {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "pid": 4242, "tid": 4242, "ts": 1.0, "dur": 2.0, "args": {}},
           {"ph": "f", "id": 1, "pid": 0, "tid": 7, "ts": 10.0,
            "cat": "ac2g", "name": "ac2g"}] + events
    data = {"schemaVersion": 1, "deviceProperties": [],
            "baseTimeNanoseconds": base, "displayTimeUnit": "ms",
            "traceEvents": evs}
    d = tmp_path / "trace"
    d.mkdir(exist_ok=True)
    name = "host_4242.1.pt.trace.json" + (".gz" if gz else "")
    if gz:
        with gzip.open(d / name, "wt") as f:
            json.dump(data, f)
    else:
        (d / name).write_text(json.dumps(data))
    return str(d)


# the explicit queue's picture: compute on stream 7, the ring on the side
# stream 13 (half hidden), a codec kernel exposed, a copy, a memset
QUEUED = [
    _kernel("void gemm_kernel<128>(float const*, float*)", 10.0, 40.0, 7),
    _kernel("ring_rs_kernel(RsArgs)", 30.0, 40.0, 13),
    _kernel("void ring_ag_kernel(float const*, float*, int, long long, "
            "int, int)", 70.0, 10.0, 13),
    _kernel("Memcpy DtoD (Device -> Device)", 80.0, 5.0, 7,
            cat="gpu_memcpy"),
    _kernel("Memset (Device)", 90.0, 2.0, 7, cat="gpu_memset"),
    _kernel("void at::native::vectorized_elementwise_kernel<4>(int)",
            60.0, 15.0, 7),
]


# ---------------------------------------------------------------------------
# interval math: equal to JAX's
# ---------------------------------------------------------------------------

def test_merge_intervals_coalesces_and_sorts():
    ivs = [(5, 7), (0, 2), (1, 3), (7, 7), (10, 12)]
    assert ta.merge_intervals(ivs) == [(0, 3), (5, 7), (10, 12)]
    assert ta.total_len(ta.merge_intervals(ivs)) == 7
    assert ta.merge_intervals([(3, 3), (5, 4)]) == []


def test_overlap_len_partial_and_spanning():
    merged = [(0, 10), (20, 30)]
    assert ta.overlap_len((5, 25), merged) == 10
    assert ta.overlap_len((10, 20), merged) == 0
    assert ta.overlap_len((-5, 50), merged) == 20


@pytest.mark.parametrize("seed", range(4))
def test_interval_math_equals_jax_on_random_sets(seed):
    r = np.random.default_rng(seed)
    ivs = [tuple(sorted(r.integers(0, 1000, 2).tolist())) for _ in range(60)]
    merged = ta.merge_intervals(ivs)
    assert merged == jta.merge_intervals(ivs)
    assert ta.total_len(merged) == jta.total_len(merged)
    for _ in range(40):
        iv = tuple(sorted(r.integers(-50, 1050, 2).tolist()))
        assert ta.overlap_len(iv, merged) == jta.overlap_len(iv, merged)


# ---------------------------------------------------------------------------
# classification: whole kernel names
# ---------------------------------------------------------------------------

def test_collective_classification_is_whole_name():
    for name in ("ring_rs_kernel(RsArgs)", "void ring_rs_kernel<1>(RsArgs)",
                 "void ring_ag_kernel(float const*, float*, int)",
                 "bfp_encode_kernel(float const*, signed char*)",
                 "bfp_decode_kernel", "int8_encode_kernel(float const*)",
                 "void int8_decode_kernel(signed char const*)",
                 "void ns::ring_ag_kernel(float)"):
        assert ta.is_collective(name), name
    for name in ("my_ring_rs_kernel(int)", "ring_rs_kernel_like_fusion",
                 "void gemm_kernel<128>(float const*)",
                 "row_checksums_kernel(Table, long long, unsigned*)",
                 "flash_fwd_kernel<true, 64>(Params)", "aten::mm",
                 "Memcpy DtoD (Device -> Device)"):
        assert not ta.is_collective(name), name
    assert ta.kernel_base("void ns::ring_rs_kernel<0, 1>(RsArgs)") == \
        "ring_rs_kernel"


# ---------------------------------------------------------------------------
# the report on fixture traces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gz", [False, True])
def test_queued_fixture_report_by_hand(tmp_path, gz):
    rep = ta.analyze_trace(_fixture(tmp_path, QUEUED, gz=gz))
    d = rep["devices"]["/device:GPU:0"]
    # compute on stream 7: gemm [10, 50) and elementwise [60, 75)
    assert d["sync_busy_s"] == pytest.approx(55e-6)
    assert d["async_collective_s"] == pytest.approx(50e-6)
    assert d["async_dma_s"] == pytest.approx(7e-6)
    assert d["async_s"] == pytest.approx(57e-6)
    # ring_rs [30, 70): stream 7 covers [30, 50) and [60, 70) -> 30 us;
    # ring_ag [70, 80): [70, 75) -> 5 us; the copy and memset sit on
    # stream 7 itself, so nothing else covers them
    assert d["overlapped_s"] == pytest.approx(35e-6)
    assert d["exposed_s"] == pytest.approx(22e-6)
    assert d["overlap_frac"] == pytest.approx(35 / 57)
    assert d["exposed_by_op"]["ring_rs_kernel"] == pytest.approx(10e-6)
    assert d["top_exposed"][0][0] == "ring_rs_kernel"
    assert d["n_streams"] == 2
    assert rep["trace"].endswith(".pt.trace.json" + (".gz" if gz else ""))


def test_report_equals_jax_attribution_when_compute_is_elsewhere(tmp_path):
    """With no async event on a compute stream, 'covered by compute on
    another stream' is JAX's 'covered by sync compute': the port's report
    equals JAX's ``_attribution_report`` on the same intervals."""
    evs = [e for e in QUEUED if e["cat"] == "kernel"]
    rep = ta.analyze_trace(_fixture(tmp_path, evs))
    d = rep["devices"]["/device:GPU:0"]
    sync, asy = [], []
    for ev in ta._device_events(json.load(open(rep["trace"]))):
        iv = (ev["start_ns"], ev["end_ns"])
        (sync.append(iv) if ev["cls"] == "compute"
         else asy.append((ev["name"], iv)))
    want = jta._attribution_report(
        sync, asy, classify=lambda name: "async_collective_s")
    for k in ("sync_busy_s", "async_s", "async_collective_s", "async_dma_s",
              "overlapped_s", "exposed_s", "overlap_frac", "top_exposed",
              "exposed_by_op"):
        assert d[k] == pytest.approx(want[k]), k


def test_one_stream_overlaps_nothing(tmp_path):
    """The fused route: every kernel on one stream, so the collectives are
    all exposed (overlap_frac 0)."""
    evs = [_kernel("gemm", 0.0, 10.0, 7), _kernel("ring_rs_kernel", 10.0,
                                                  5.0, 7),
           _kernel("ring_ag_kernel", 15.0, 5.0, 7), _kernel("gemm", 20.0,
                                                            10.0, 7)]
    s = ta.summarize(ta.analyze_trace(_fixture(tmp_path, evs)))
    assert s["overlap_frac"] == 0.0 and s["exposed_s"] == \
        pytest.approx(10e-6)


def test_two_cards_and_device_intervals(tmp_path):
    evs = QUEUED + [_kernel("ring_ag_kernel", 5.0, 10.0, 20, device=1)]
    path = _fixture(tmp_path, evs)
    rep = ta.analyze_trace(path)
    assert sorted(rep["devices"]) == ["/device:GPU:0", "/device:GPU:1"]
    ivs = ta.device_intervals(path)
    assert len(ivs) == len(evs)
    first = ivs[0]
    assert first == {"plane": "/device:GPU:0", "line": "stream 7",
                     "name": "gemm_kernel", "start_ns": BASE_NS + 10_000,
                     "end_ns": BASE_NS + 50_000, "cls": "sync"}
    assert {iv["cls"] for iv in ivs if iv["name"] == "ring_rs_kernel"} == \
        {"async"}
    assert [iv["cls"] for iv in ivs if iv["line"] == "stream 7"].count(
        "async") == 2                       # the copy and the memset


def test_summarize_aggregates_planes_as_jax():
    rep = {"devices": {
        "/device:GPU:0": {"sync_busy_s": 1.0, "async_s": 0.5,
                          "async_collective_s": 0.3, "async_dma_s": 0.2,
                          "overlapped_s": 0.4, "exposed_s": 0.1,
                          "top_exposed": [("ring_rs_kernel", 0.08),
                                          ("Memcpy DtoD", 0.02)]},
        "/device:GPU:1": {"sync_busy_s": 2.0, "async_s": 0.5,
                          "async_collective_s": 0.5, "async_dma_s": 0.0,
                          "overlapped_s": 0.25, "exposed_s": 0.25,
                          "top_exposed": [("ring_rs_kernel", 0.25)]},
    }}
    s = ta.summarize(rep)
    assert s == jta.summarize(rep)
    assert s["n_devices"] == 2 and s["sync_busy_s"] == 3.0
    assert s["overlap_frac"] == pytest.approx(0.65)
    assert s["top_exposed"][0] == ("ring_rs_kernel", pytest.approx(0.33))


def test_find_trace_missing_and_no_device_events(tmp_path):
    with pytest.raises(FileNotFoundError):
        ta.find_trace(str(tmp_path))
    path = _fixture(tmp_path, [])
    with pytest.raises(ValueError, match="no device events"):
        ta.analyze_trace(path)
    rep = ta.analyze_any(path)                  # the host fallback
    assert rep["devices"]["cpu"]["sync_busy_s"] == pytest.approx(50e-6)


def test_cpu_fallback_on_a_real_profiler_trace(tmp_path):
    from torch.profiler import ProfilerActivity, profile
    x = torch.randn(128, 128)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            (x @ x).sum()
    (tmp_path / "t").mkdir()
    prof.export_chrome_trace(str(tmp_path / "t" / "cpu.pt.trace.json"))
    s = ta.summarize(ta.analyze_any(str(tmp_path / "t")))
    assert s["sync_busy_s"] > 0 and s["async_s"] == 0.0
    assert s["overlap_frac"] == 1.0


def test_cli_summary_per_plane_and_intervals(tmp_path, capsys):
    path = _fixture(tmp_path, QUEUED)
    assert ta.main([path]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["overlap_frac"] == pytest.approx(35 / 57)
    dump = tmp_path / "ivs.json"
    assert ta.main([path, "--per-plane", "--intervals", str(dump)]) == 0
    out = json.loads(capsys.readouterr().out)
    assert "/device:GPU:0" in out["devices"]
    assert len(json.load(open(dump))) == len(QUEUED)
    assert ta.main([str(tmp_path / "missing")]) == 1
    assert "error" in json.loads(capsys.readouterr().out)
