"""The port's drift observatory and plan adaptation
(``fpga_ai_nic_tpu_torch.tune.adapt``) against the JAX package's
``tune.adapt``, on the CPU.

- ``DriftDetector``, ``Attribution`` and ``AdaptiveController`` on
  scripted residual and step-time sequences: the same trips, decisions
  (target and evidence) and ``tune.drift.*`` values (through each
  package's ``MetricsSink``) as JAX's, float for float;
- ``AdaptiveTrainer`` at dp=4 with the same injected plans and
  calibration and a forced switch, on a loss whose gradients are exact
  (``sum(params * c)``, per-rank coefficients) and the fused update
  formula (``fused_optimizer=True``: the unfused optimizer rounds the
  division by n apart from JAX's by an ulp): the masters after every
  step equal JAX's ``AdaptiveTrainer`` on its 8-device CPU mesh bit for
  bit, through a codec switch (re-padded masters) and a same-codec one
  (the state untouched), with ``recompiles_across_switch == 0``;
- ``live_calibrate`` on CPU ranks (live sources, dryrun), and
  ``DDPTrainer`` / ``FSDPTrainer`` with ``codec="auto"`` against JAX's on
  the same loss.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import jax
import jax.numpy as jnp

from fpga_ai_nic_tpu import tune as jtune
from fpga_ai_nic_tpu.obs.metrics import MetricsSink as JaxSink
from fpga_ai_nic_tpu.obs.metrics import use_sink as jax_use_sink
from fpga_ai_nic_tpu.parallel import make_mesh
from fpga_ai_nic_tpu.parallel.ddp import DDPTrainer as JaxDDPTrainer
from fpga_ai_nic_tpu.parallel.fsdp import FSDPTrainer as JaxFSDPTrainer
from fpga_ai_nic_tpu.tune import adapt as jadapt
from fpga_ai_nic_tpu.utils import config as jcfg
from fpga_ai_nic_tpu_torch import tune
from fpga_ai_nic_tpu_torch.obs.events import EventStream
from fpga_ai_nic_tpu_torch.obs.metrics import Ewma, MetricsSink, use_sink
from fpga_ai_nic_tpu_torch.ops import fused_update
from fpga_ai_nic_tpu_torch.parallel.ddp import DDPTrainer
from fpga_ai_nic_tpu_torch.parallel.fsdp import FSDPTrainer
from fpga_ai_nic_tpu_torch.parallel.mesh import VirtualRanks, make_ranks
from fpga_ai_nic_tpu_torch.tune import adapt
from fpga_ai_nic_tpu_torch.utils import config as pcfg

N = 4
CPU = torch.device("cpu")
# a tree whose leaves start on whole BFP and int8 units at dp=4
SHAPES = {"a": [(64, 128)], "b": [(512,), (16, 96)]}
RESID = [0.1, 0.0, 2.5, -0.3, 0.9, 0.9, 1.2, 1.5, 0.2, -1.1, -1.4, -1.6,
         -2.0, 0.0, 0.0, 3.9, 4.2, 0.1, -0.2, 0.8]
# seconds a step: warm-up, calm, a spike, a sustained slowdown, calm again
STEP_S = ([0.010, 0.011, 0.0105, 0.0102, 0.0101, 0.030, 0.0103]
          + [0.031, 0.029, 0.033, 0.030, 0.032, 0.034] + [0.010] * 6
          + [0.002, 0.0021, 0.0019, 0.002])


def _fixture(**kw):
    return (jtune.calibration.fixture_calibration(**kw),
            tune.fixture_calibration(**kw))


# -- detection, attribution, the controller ---------------------------------------

@pytest.mark.parametrize("drift,threshold,cooldown", [
    (0.75, 3.0, 8), (0.5, 1.0, 2), (0.1, 0.5, 0)])
def test_drift_detector_trips_like_jax(drift, threshold, cooldown):
    j = jadapt.DriftDetector(drift_rel=drift, threshold=threshold,
                             cooldown_steps=cooldown)
    p = adapt.DriftDetector(drift_rel=drift, threshold=threshold,
                            cooldown_steps=cooldown)
    for r in RESID:
        assert p.update(r) == j.update(r)
        assert (p.pos, p.neg, p.cooldown, p.trips) == (
            j.pos, j.neg, j.cooldown, j.trips)
    assert p.trips > 0


@pytest.mark.parametrize("warmup", [1, 3])
def test_attribution_records_like_jax(warmup):
    modeled = {"collective_s": 0.004, "stream_s": 0.003,
               "overhead_s": 0.001}
    j = jadapt.Attribution(modeled, warmup_steps=warmup, ewma_alpha=0.3)
    p = adapt.Attribution(modeled, warmup_steps=warmup, ewma_alpha=0.3)
    for i, t in enumerate(STEP_S):
        if i == 12:
            j.rebase({"collective_s": 0.001})
            p.rebase({"collective_s": 0.001})
        assert p.observe(t) == j.observe(t)
        assert (p.baseline_step_s, p.compute_s, p.warmed_up) == (
            j.baseline_step_s, j.compute_s, j.warmed_up)


def _plans(pkg, calib, payload, k=3):
    return pkg.tune_topk(payload, N, k, calibration=calib, depths=(1,))


@pytest.mark.parametrize("inter", [50.0, 2.0])
def test_controller_decisions_and_drift_values_like_jax(inter):
    """The scripted step times through both controllers: every record,
    every ``tune.drift.*`` value delivered to the sink, every armed
    decision (target and evidence), the switches noted, the injected
    shift's target."""
    jc, pc = _fixture(inter_gbps=inter)
    E = 200_000
    kw = dict(payload_elems=E, n=N, warmup_steps=3, ewma_alpha=0.25,
              drift_rel=0.5, cusum_threshold=1.5, cooldown_steps=2)
    jctl = jadapt.AdaptiveController(_plans(jtune, jc, E), jc, **kw)
    pctl = adapt.AdaptiveController(_plans(tune, pc, E), pc, **kw)
    jsink, psink = JaxSink(), MetricsSink()
    decisions = 0
    for i, t in enumerate(STEP_S):
        with jax_use_sink(jsink):
            jctl.observe(t, step=i)
        with use_sink(psink):
            pctl.observe(t, step=i)
        assert pctl.last_record == jctl.last_record
        drift = {k: v for k, v in psink.latest.items()
                 if k.startswith("tune.drift.")}
        assert drift == {k: v for k, v in jsink.latest.items()
                         if k.startswith("tune.drift.")}
        jd, pd = jctl.take_pending(), pctl.take_pending()
        assert (jd is None) == (pd is None)
        if pd is not None:
            decisions += 1
            assert (pd.target, pd.evidence) == (jd.target, jd.evidence)
            jctl.note_switch(jd.target)
            pctl.note_switch(pd.target)
        assert pctl.active == jctl.active
    assert decisions >= 1 and len(psink.latest) >= 7
    for rate in (1e-4, 0.5, 5.0, 500.0):
        jctl.inject_shift(rate, step=99)
        pctl.inject_shift(rate, step=99)
        jd, pd = jctl.take_pending(), pctl.take_pending()
        assert (pd.target, pd.evidence) == (jd.target, jd.evidence)
        assert pctl.effective_inter_gbps(0.002) == \
            jctl.effective_inter_gbps(0.002)


def test_ewma_and_sink_like_jax():
    from fpga_ai_nic_tpu.obs.metrics import Ewma as JaxEwma
    j, p = JaxEwma(0.3), Ewma(0.3)
    for v in (5.0, 1.0, 2.0, 8.0):
        assert p.update(v) == j.update(v)
    assert p.value == j.value
    sink = MetricsSink(events=EventStream())
    assert tune.adapt.host_observe is not None
    with use_sink(sink):
        tune.adapt.host_observe({"loss": 2.0, "x": 1.0})
        tune.adapt.host_observe({"loss": 1.0})
    d = sink.as_dict()
    assert d["n_updates"] == 2 and d["latest"]["x"] == 1.0
    assert d["loss_ewma"] == pytest.approx(0.9 * 2.0 + 0.1 * 1.0)
    tune.adapt.host_observe({"loss": 3.0})      # no sink: a no-op
    assert sink.n_updates == 2


# -- the adaptive trainer -----------------------------------------------------------

def _lin_jax(p, b):
    return sum(jnp.sum(leaf * c[0])
               for leaf, c in zip(jax.tree_util.tree_leaves(p), b))


def _lin_port(p, b):
    return sum((leaf * c[0]).sum()
               for leaf, c in zip(fused_update.tree_leaves(p), b))


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {k: [(rng.standard_normal(s) * 0.1).astype(np.float32)
                for s in v] for k, v in SHAPES.items()}


def _coefs(steps, seed=1):
    rng = np.random.default_rng(seed)
    shapes = [s for k in sorted(SHAPES) for s in SHAPES[k]]
    return [[(rng.standard_normal((N,) + s) * 2).astype(np.float32)
             for s in shapes] for _ in range(steps)]


def _tcfg(mod, **adapt_kw):
    kw = dict(enabled=True, n_candidates=3, live_calibration=False,
              warmup_steps=2, cooldown_steps=3)
    kw.update(adapt_kw)
    return mod.TrainConfig(
        global_batch=N, mesh=mod.MeshConfig(dp=N),
        collective=mod.CollectiveConfig(impl="ring", codec="auto",
                                        fused_optimizer=True),
        optimizer=mod.OptimizerConfig(kind="momentum", learning_rate=0.05),
        adapt=mod.AdaptConfig(**kw))


def _pair(plans_fn=None, **fixture):
    jc, pc = _fixture(**fixture)
    payload = sum(int(np.prod(s)) for v in SHAPES.values() for s in v)
    jplans, pplans = _plans(jtune, jc, payload), _plans(tune, pc, payload)
    if plans_fn is not None:
        jplans, pplans = plans_fn(jplans), plans_fn(pplans)
    params = _params()
    jat = jadapt.AdaptiveTrainer(_lin_jax, make_mesh(jcfg.MeshConfig(dp=N)),
                                 _tcfg(jcfg), calibration=jc, plans=jplans)
    js = jat.init_state(jax.tree_util.tree_map(jnp.asarray, params))
    pat = adapt.AdaptiveTrainer(_lin_port, VirtualRanks(N, CPU), _tcfg(pcfg),
                                calibration=pc, plans=pplans)
    ps = pat.init_state({k: [torch.from_numpy(a) for a in v]
                         for k, v in params.items()})
    return jat, js, pat, ps


def _step_both(jat, js, pat, ps, coef):
    js, _ = jat.step(js, jat.shard_batch(tuple(map(jnp.asarray, coef))))
    ps, _ = pat.step(ps, pat.shard_batch(tuple(map(torch.from_numpy,
                                                   coef))))
    np.testing.assert_array_equal(ps.w_own.numpy(),
                                  np.asarray(js.w_own).reshape(N, -1))
    for k, v in ps.opt_state.items():
        np.testing.assert_array_equal(
            v.numpy(), np.asarray(js.opt_state[k]).reshape(N, -1))
    for a, b in zip(fused_update.tree_leaves(ps.params),
                    jax.tree_util.tree_leaves(js.params)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    return js, ps


def test_adaptive_trainer_codec_switch_matches_jax():
    """The fixture's three plans (the uncompressed ring, then two codec
    groups); a shift injected at step 2 to a near-zero link rate: both
    switch to the same codec plan, the masters re-padded, and every
    step's masters, moments and params equal JAX's bit for bit; no
    library or trainer added across the switch."""
    jat, js, pat, ps = _pair()
    assert [p.candidate.codec for p in pat.plans] == \
        [p.candidate.codec for p in jat.plans]
    assert pat.plans[0].candidate.codec is None
    for i, coef in enumerate(_coefs(5)):
        if i == 2:
            jat.controller.inject_shift(1e-4, step=i)
            pat.controller.inject_shift(1e-4, step=i)
        js, ps = _step_both(jat, js, pat, ps, coef)
    assert pat.switches == jat.switches == 1
    assert pat.active == jat.active != 0
    ev, jev = pat.switch_events[0], jat.switch_events[0]
    assert (ev["step"], ev["from_plan"], ev["to_plan"], ev["bitwise"],
            ev["evidence"]) == (jev["step"], jev["from_plan"],
                                jev["to_plan"], jev["bitwise"],
                                jev["evidence"])
    assert ev["bitwise"] is False
    assert pat.recompiles_across_switch == 0
    assert set(pat.trace_counts()) == set(jat.trace_counts())
    st = pat.obs_static_metrics()["adapt"]
    assert (st["switches"], st["active"], st["n_candidates"]) == (
        1, pat.active, 3)


def test_adaptive_trainer_same_codec_switch_is_bitwise_like_jax():
    """Two plans of one codec (another bucket): the switch passes the
    state through untouched, and the run equals JAX's and a run that
    never switched."""
    def two(plans):
        base = plans[0]
        return [base, dataclasses.replace(base, candidate=dataclasses.replace(
            base.candidate, bucket_elems=1 << 20))]
    jat, js, pat, ps = _pair(two)
    ref = adapt.AdaptiveTrainer(_lin_port, VirtualRanks(N, CPU), _tcfg(pcfg),
                                calibration=pat.calibration,
                                plans=pat.plans[:1])
    rs = ref.init_state({k: [torch.from_numpy(a) for a in v]
                         for k, v in _params().items()})
    for i, coef in enumerate(_coefs(4)):
        if i == 1:
            for ctl in (jat.controller, pat.controller):
                ctl._pending = type(ctl.take_pending() or
                                    adapt.SwitchDecision(0, {}))(
                    1, {"direction": "test", "detected_step": i})
        before = ps
        js, ps = _step_both(jat, js, pat, ps, coef)
        rs, _ = ref.step(rs, ref.shard_batch(tuple(map(torch.from_numpy,
                                                       coef))))
        assert torch.equal(ps.w_own, rs.w_own)
        if i == 1:
            assert pat._migrate(before, 0, 1) is before
    assert pat.switch_events[0]["bitwise"] is True
    assert pat.active == jat.active == 1
    assert pat.recompiles_across_switch == 0


def test_adaptive_trainer_refuses_like_jax():
    cfg = _tcfg(pcfg)
    with pytest.raises(ValueError, match="auto"):
        adapt.AdaptiveTrainer(_lin_port, VirtualRanks(N, CPU),
                              dataclasses.replace(
                                  cfg, collective=pcfg.CollectiveConfig(
                                      impl="ring", codec="bfp")))
    with pytest.raises(ValueError, match="enabled"):
        adapt.AdaptiveTrainer(_lin_port, VirtualRanks(N, CPU),
                              dataclasses.replace(cfg,
                                                  adapt=pcfg.AdaptConfig()))


def test_adaptive_trainer_streams_drift_and_events():
    """Steps through the timing path: ``tune.drift.*`` reach the sink,
    the attribution lane's spans the event stream."""
    events = EventStream()
    sink = MetricsSink()
    pc = tune.fixture_calibration()
    at = adapt.AdaptiveTrainer(_lin_port, VirtualRanks(N, CPU), _tcfg(pcfg),
                               events=events, calibration=pc)
    st = at.init_state({k: [torch.from_numpy(a) for a in v]
                        for k, v in _params().items()})
    with use_sink(sink):
        for coef in _coefs(5):
            st, _ = at.step(st, at.shard_batch(tuple(map(torch.from_numpy,
                                                         coef))))
    assert "tune.drift.resid_rel" in sink.latest
    spans = [e for e in events.snapshot() if e["kind"] == "span"
             and (e.get("attrs") or {}).get("lane") == "attribution"]
    assert {"measured step", "compute (baseline)",
            "collective (modeled)"} <= {e["attrs"]["stage"] for e in spans}


def test_live_calibrate_on_cpu_ranks():
    """The startup microbenches on CPU ranks: a measured ring rate and
    every registered codec's rates at the live tier, dryrun."""
    base = tune.fixture_calibration(inter_gbps=12.0)
    cal = adapt.live_calibrate(VirtualRanks(N, CPU), base=base,
                               payload_elems=1 << 14, repeats=1)
    assert cal.inter_live and cal.inter_calibrated and cal.inter_dryrun
    assert cal.inter_source.startswith("live:") and "cpu" in \
        cal.inter_source
    assert cal.inter_gbps > 0 and cal.inter_gbps != 12.0
    assert set(cal.codec_rates) == {"bfp", "int8", "topk"}
    for by_class in cal.codec_rates.values():
        for r in by_class.values():
            assert r.live and r.dryrun and r.source.startswith("live:")
            assert r.encode_gbps > 0 and r.decode_gbps > 0
    gbps, t = adapt.measure_ring_gbps(VirtualRanks(N, CPU),
                                      payload_elems=4096, repeats=1)
    assert gbps > 0 and t > 0


# -- DDP and FSDP with codec="auto" ---------------------------------------------

@pytest.mark.parametrize("kind", ["ddp", "fsdp"])
def test_ddp_and_fsdp_auto_match_jax(monkeypatch, kind):
    """With a slow wire the tuner picks a codec; the resolved trainer's
    masters after three steps on the exact-gradient loss equal JAX's."""
    jc, pc = _fixture(inter_gbps=2.0)
    monkeypatch.setattr(jtune.autotune, "load_calibration", lambda: jc)
    monkeypatch.setattr(tune.autotune, "load_calibration", lambda: pc)
    params = _params()

    def cfg(mod):
        mesh = (mod.MeshConfig(fsdp=N) if kind == "fsdp"
                else mod.MeshConfig(dp=N))
        return mod.TrainConfig(global_batch=N, mesh=mesh,
                               collective=mod.CollectiveConfig(
                                   impl="ring", codec="auto"),
                               optimizer=mod.OptimizerConfig(
                                   kind="sgd", learning_rate=0.05))
    jcls, pcls = ((JaxFSDPTrainer, FSDPTrainer) if kind == "fsdp"
                  else (JaxDDPTrainer, DDPTrainer))
    jt = jcls(_lin_jax, make_mesh(cfg(jcfg).mesh), cfg(jcfg))
    js = jt.init_state(jax.tree_util.tree_map(jnp.asarray, params))
    pt = pcls(_lin_port, make_ranks(cfg(pcfg).mesh, "cpu"), cfg(pcfg))
    ps = pt.init_state({k: [torch.from_numpy(a) for a in v]
                        for k, v in params.items()})
    assert pt.cfg.collective.codec == jt.cfg.collective.codec is not None
    assert pt.cfg.collective.bucket_elems == jt.cfg.collective.bucket_elems
    for coef in _coefs(3):
        js, _ = jt.step(js, jt.shard_batch(tuple(map(jnp.asarray, coef))))
        ps, _ = pt.step(ps, pt.shard_batch(tuple(map(torch.from_numpy,
                                                     coef))))
    want = np.asarray(js.w_own if kind == "fsdp" else js.w_master)
    got = (ps.w_own if kind == "fsdp" else ps.w_master).numpy()
    # DDP's masters replicate (one row a rank), FSDP's shard
    want = want.reshape(1 if kind == "ddp" else N, -1)
    np.testing.assert_allclose(got, np.broadcast_to(want, got.shape),
                               rtol=1e-6, atol=1e-7)
