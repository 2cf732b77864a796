"""The port's ``ops.ring_cost`` against the JAX package's, on JAX's test
inputs (``tests/test_ring_cost.py``) and more: pure arithmetic, so every
function must return exactly what JAX's returns."""

import pytest
from torch_threads import one_torch_thread  # noqa: F401

from fpga_ai_nic_tpu import compress as jax_compress
from fpga_ai_nic_tpu.ops import ring_cost as jax_rc
from fpga_ai_nic_tpu_torch import compress
from fpga_ai_nic_tpu_torch.ops import ring_cost as rc

PIPELINE_CASES = [
    ({"skeleton": 1.0, "encode": 3.0, "decode": 4.0, "rdma": 2.0}, 6.5,
     False),
    ({"skeleton": 0.5, "encode": 1.0, "decode": 1.0, "rdma": 9.0,
      "hbm": 4.0}, 10.0, False),
    ({"skeleton": 2.0, "encode": 2.1, "decode": 2.05, "rdma": 0.1}, None,
     False),
    ({"encode": -0.1, "decode": 0.0, "rdma": 3.0}, 5.0, False),
    ({"skeleton": 1.0, "encode": 3.0, "decode": -1.0, "rdma": 2.0}, 6.0,
     False),
    ({"skeleton": 1.0, "encode": 3.0, "decode": 4.0, "rdma": 2.0,
      "update": 1.5}, 7.0, True),
    ({"skeleton": 1.0, "encode": 3.0, "decode": 4.0, "rdma": 2.0}, 7.0,
     True),
    ({}, None, False),
]


@pytest.mark.parametrize("stage_s,full_s,expect_update", PIPELINE_CASES)
def test_model_pipeline_equals_jax(stage_s, full_s, expect_update):
    assert rc.model_pipeline(stage_s, full_s, expect_update) == \
        jax_rc.model_pipeline(stage_s, full_s, expect_update)


@pytest.mark.parametrize("streaming", [False, True])
@pytest.mark.parametrize("fused_opt", [False, True])
def test_stages_for_equals_jax(streaming, fused_opt):
    assert tuple(rc.stages_for(streaming, fused_opt)) == \
        tuple(jax_rc.stages_for(streaming, fused_opt))
    assert rc.STAGES_RESIDENT == jax_rc.STAGES_RESIDENT
    assert rc.STAGES_STREAMING == jax_rc.STAGES_STREAMING


@pytest.mark.parametrize("kind", ["sgd", "momentum", "adamw"])
@pytest.mark.parametrize("hbm", [0.0, 3350.0])
def test_optimizer_roofline_equals_jax(kind, hbm):
    assert rc.optimizer_roofline(kind, 4 << 20, hbm) == \
        jax_rc.optimizer_roofline(kind, 4 << 20, hbm)


CODEC_RATE_CASES = [
    {"skeleton": {"t_ms": 2.0}, "encode": {"t_ms": 6.0},
     "decode": {"t_ms": 10.0}},
    {"skeleton": {"t_ms": 5.0}, "encode": {"t_ms": 5.0},
     "decode": {"t_ms": 6.0}},
    {"encode": {"t_ms": 1.0}},
    {"encode": {"t_ms": 3.0}, "decode": {"t_ms": 4.0}},
]


@pytest.mark.parametrize("stages", CODEC_RATE_CASES)
def test_codec_rates_equals_jax(stages):
    payload = 8 * 10 ** 9 // 1000
    assert rc.codec_rates(stages, payload) == \
        jax_rc.codec_rates(stages, payload)


class _Calibration:
    def __init__(self, calibrated, gbps=7.77777, source="banked"):
        self.inter_calibrated = calibrated
        self.inter_gbps = gbps
        self.inter_source = source


@pytest.mark.parametrize("calibration", [None, _Calibration(False),
                                         _Calibration(True),
                                         _Calibration(True, 45.0)])
def test_link_rate_candidates_equals_jax(calibration):
    """With no calibration the port returns JAX's documented fallback (no
    tuner is loaded); with one, JAX's merge."""
    got = rc.link_rate_candidates(calibration)
    if calibration is not None:
        assert got == jax_rc.link_rate_candidates(calibration)
    else:
        assert got == {"rates": tuple(jax_rc.DEFAULT_LINK_RATES),
                       "calibrated": False, "measured_gbps": None,
                       "source": "DEFAULT_LINK_RATES (documented fallback)"}
    assert rc.DEFAULT_LINK_RATES == jax_rc.DEFAULT_LINK_RATES


@pytest.mark.parametrize("args", [
    (1e6, 2.6e5, 5.0, 30.0, 30.0), (1e6, 2.6e5, 90.0, 30.0, 30.0),
    (1e6, 1e6, 12.5, 0.0, 0.0), (4e6, 1e6, 0.0, 10.0, float("inf")),
    (2e6, 5e5, 45.0, 100.0, 50.0)])
def test_hop_cost_equals_jax(args):
    assert rc.hop_cost(*args) == jax_rc.hop_cost(*args)


@pytest.mark.parametrize("n,ni", [(8, 1), (8, 2), (8, 4), (8, 8), (6, 3),
                                  (8, 0)])
@pytest.mark.parametrize("codec", [None, "bfp", "int8"])
def test_hier_phase_bytes_equals_jax(n, ni, codec):
    L = 8 * 3 * 16 * 1024
    price = (None if codec is None
             else compress.get_codec(codec).wire_bytes)
    jprice = (None if codec is None
              else jax_compress.get_codec(codec).wire_bytes)
    assert rc.hier_phase_bytes(L, n, ni, price) == \
        jax_rc.hier_phase_bytes(L, n, ni, jprice)


@pytest.mark.parametrize("args", [
    (30.0, 30.0, 3.5, 3.76), (0.0, 0.0, 3.5, 3.76), (1e6, 1e6, 3.5, 3.76),
    (12.0, 40.0, 3.2, 3.76)])
@pytest.mark.parametrize("calibrated", [False, True])
def test_break_even_equals_jax(args, calibrated):
    kw = dict(source="measured", calibrated=calibrated)
    assert rc.break_even(*args, **kw) == jax_rc.break_even(*args, **kw)
    rates = (5.0, 7.5, 400.0)
    assert rc.break_even(*args, link_rates=rates) == \
        jax_rc.break_even(*args, link_rates=rates)


@pytest.mark.parametrize("name,opts", [("bfp", {}), ("int8", {}),
                                       ("topk", {"bucket_elems": 256,
                                                 "k": 32})])
def test_codec_break_even_equals_jax(name, opts):
    got = rc.codec_break_even(compress.get_codec(name, opts), 30.0, 20.0)
    want = jax_rc.codec_break_even(jax_compress.get_codec(name, opts), 30.0,
                                   20.0)
    assert got == want


@pytest.mark.parametrize("n_elems", [1 << 16, 1000])
def test_codec_table_equals_jax(n_elems):
    assert rc.codec_table(n_elems) == jax_rc.codec_table(n_elems)


def _measures():
    times = {None: 10e-3, "skeleton": 1e-3, "encode": 3e-3, "decode": 4e-3,
             "rdma": 6e-3, "hbm": 5e-3, "update": 2e-3}

    def crash_hbm(ab):
        if ab == "hbm":
            raise RuntimeError("compile failure")
        return {None: 10e-3}.get(ab, 2e-3)

    return {"ok": lambda ab: times[ab],
            "crash": crash_hbm,
            "failed_full": lambda ab: -1.0 if ab is None else 1e-3,
            "drowned_stage": lambda ab: -1.0 if ab == "decode"
            else times[ab]}


@pytest.mark.parametrize("measure", sorted(_measures()))
@pytest.mark.parametrize("streaming", [False, True])
@pytest.mark.parametrize("fused_opt", [False, True])
def test_decompose_equals_jax(measure, streaming, fused_opt):
    fn = _measures()[measure]
    kw = dict(streaming=streaming, payload_bytes=12 * (1 << 20),
              fused_opt=fused_opt)
    assert rc.decompose(fn, **kw) == jax_rc.decompose(fn, **kw)


def test_decompose_keeps_jax_best_effort_contract():
    """A failing stage costs that stage only: the full rate is kept, the
    error recorded, and no confident model claim is made."""
    out = rc.decompose(_measures()["crash"], streaming=True,
                       payload_bytes=1 << 20)
    assert out["pipeline_gbps"] > 0 and out["t_ms"] == pytest.approx(10.0)
    assert not out["valid"] and "compile" in out["stage_errors"]["hbm"]
    assert "modeled_t_ms" not in out and "pipeline_efficiency" not in out
