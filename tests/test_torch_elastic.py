"""The port's elastic loop, restore tier (``parallel/elastic.py``), against
the JAX package's ``tests/test_chaos.py`` on the tiny MLP over 8 virtual
ranks: JAX's seven fault cells, the replay, rewind, abandoned-ticket and
max-retries cases, and the six cases that are red on the JAX side (its
integrity-on ring trainer fails a varying-axes check of its scan carry on
this CPU mesh, before any checkpoint logic runs): the master guard, the
durability cells and the emergency dump.  Each finishes with masters
bit-equal to the port's fault-free run, which tracks JAX's fault-free
``DPTrainer`` within f32 reassociation (the GEMMs sum in other orders);
the checkpoints are held against JAX's ``Checkpointer.audit_step``
verdict on the same files."""

import tempfile

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import jax
import jax.numpy as jnp

from fpga_ai_nic_tpu.models import mlp as jax_mlp
from fpga_ai_nic_tpu.parallel import DPTrainer as JaxDPTrainer, make_mesh
from fpga_ai_nic_tpu.parallel.elastic import ElasticConfig as JaxECfg
from fpga_ai_nic_tpu.utils import checkpoint as jax_ckpt
from fpga_ai_nic_tpu.utils import config as jcfg
from fpga_ai_nic_tpu.utils.observability import Profiler as JaxProfiler
from fpga_ai_nic_tpu_torch.models import mlp
from fpga_ai_nic_tpu_torch.parallel.elastic import (ElasticConfig,
                                                    ElasticTrainer,
                                                    RecoveryExhausted)
from fpga_ai_nic_tpu_torch.parallel.mesh import VirtualRanks
from fpga_ai_nic_tpu_torch.parallel.train import DPTrainer
from fpga_ai_nic_tpu_torch.runtime import chaos
from fpga_ai_nic_tpu_torch.utils import config
from fpga_ai_nic_tpu_torch.utils.observability import Profiler

SIZES = (32, 64, 64, 10)


def _cfg(mod, compression=None, integrity=True):
    return mod.TrainConfig(
        iters=6, global_batch=64, mesh=mod.MeshConfig(dp=8),
        collective=mod.CollectiveConfig(impl="ring", compression=compression,
                                        integrity_check=integrity),
        optimizer=mod.OptimizerConfig())


def _data(n=64):
    r = np.random.default_rng(0)
    x = r.standard_normal((n, 32)).astype(np.float32)
    w = r.standard_normal((32, 10)).astype(np.float32)
    return x, (x @ w).argmax(-1).astype(np.int32)


def _jax_params():
    return jax.tree_util.tree_map(np.asarray, jax_mlp.init(
        jax.random.PRNGKey(0), jcfg.MLPConfig(layer_sizes=SIZES,
                                              dtype="float32")))


def _make_trainer():
    m = config.MLPConfig(layer_sizes=SIZES, dtype="float32")
    tr = DPTrainer(lambda p, b: mlp.loss_fn(p, b, m),
                   VirtualRanks(8, torch.device("cpu")), _cfg(config))
    state = tr.init_state(mlp.from_jax_params(_jax_params(), "cpu"))
    x, y = _data()
    return tr, state, tr.shard_batch((torch.from_numpy(x),
                                      torch.from_numpy(y)))


_CLEAN = {}


def _clean(n_steps):
    """The port's fault-free masters after ``n_steps`` plain steps."""
    if n_steps not in _CLEAN:
        tr, state, batch = _make_trainer()
        for _ in range(n_steps):
            state, _ = tr.step(state, batch)
        _CLEAN[n_steps] = state.w_own.clone()
    return _CLEAN[n_steps]


@pytest.fixture
def tap():
    chaos.install_collective_tap()
    yield
    chaos.uninstall_collective_tap()


_ECFG = ElasticConfig(step_timeout_s=2.0, stall_after_s=60.0, max_retries=3,
                      backoff_s=0.01, ckpt_every=1)


def test_elastic_config_defaults_equal_jax():
    import dataclasses
    assert {f.name: getattr(ElasticConfig(), f.name)
            for f in dataclasses.fields(ElasticConfig)} == {
        f.name: getattr(JaxECfg(), f.name)
        for f in dataclasses.fields(JaxECfg)}


def test_clean_run_tracks_jax_trainer():
    """The fault-free reference: six steps of the port against JAX's
    DPTrainer (integrity off: JAX's integrity-on ring trainer is red on
    this mesh, C.4) from the same weights, within f32 reassociation."""
    jt = JaxDPTrainer(
        lambda p, b: jax_mlp.loss_fn(p, b, jcfg.MLPConfig(
            layer_sizes=SIZES, dtype="float32")),
        make_mesh(jcfg.MeshConfig(dp=8)), _cfg(jcfg, integrity=False))
    js = jt.init_state(jax.tree_util.tree_map(jnp.asarray, _jax_params()))
    x, y = _data()
    jb = jt.shard_batch((jnp.asarray(x), jnp.asarray(y)))
    for _ in range(6):
        js, _ = jt.step(js, jb)
    np.testing.assert_allclose(_clean(6).numpy(),
                               np.asarray(js.w_own).reshape(8, -1),
                               rtol=0, atol=1e-6)


# (kind, site, mode): JAX's cells (tests/test_chaos.py:226-234)
_CELLS = [
    ("exception", "queue.issue", "nan"),
    ("preemption", "queue.issue", "nan"),
    ("hang", "queue.wait", "nan"),
    ("slowdown", "staging", "nan"),
    ("corruption", "staging", "nan"),
    ("corruption", "queue.wait", "nan"),
    ("corruption", "collective", "scale"),
]


@pytest.mark.parametrize("kind,site,mode",
                         _CELLS, ids=[f"{k}@{s}" for k, s, _ in _CELLS])
def test_elastic_loop_survives_fault(tap, tmp_path, kind, site, mode):
    tr, state, batch = _make_trainer()
    plan = chaos.FaultPlan(
        [chaos.FaultSpec(kind, site, step=3, mode=mode,
                         duration_s=(3.0 if kind == "hang" else 0.2))],
        seed=11)
    with chaos.activate(plan):
        et = ElasticTrainer(tr, str(tmp_path), _ECFG, plan=plan,
                            stage_fn=plan.stage)
        state, metrics = et.run(state, lambda i: batch, 6)
    assert et.join(10.0) == 0
    rec = et.profiler.recovery.as_dict()
    assert state.step == 6 and len(plan.fired) == 1
    assert np.isfinite(float(metrics["loss"]))
    assert torch.equal(state.w_own, _clean(6))
    if kind == "slowdown":
        assert rec["faults_total"] == 0, rec
    else:
        assert rec["faults_total"] >= 1, rec
        assert rec["recoveries"] >= 1, rec
        assert rec["checkpoint_restores"] >= 1, rec
        assert rec["mttr_mean_s"] > 0, rec
        assert set(rec["faults"]) <= {kind, "corruption", "error"}, rec
    assert et.profiler.report()["recovery"] == rec
    # the last step on disk audits clean in both packages
    last = et.ckpt.latest_step()
    assert last == 6 and et.ckpt.audit_step(last).ok
    assert jax_ckpt.Checkpointer(str(tmp_path)).audit_step(last).ok


def test_elastic_recovery_replays_to_identical_loss(tap):
    finals = []
    for faults in ([], [chaos.FaultSpec("exception", "queue.issue", step=2)]):
        tr, state, batch = _make_trainer()
        plan = chaos.FaultPlan(faults, seed=11)
        with tempfile.TemporaryDirectory() as d, chaos.activate(plan):
            et = ElasticTrainer(tr, d, _ECFG, plan=plan)
            state, metrics = et.run(state, lambda i: batch, 5)
        finals.append((float(metrics["loss"]), state.w_own))
    assert finals[0][0] == finals[1][0]
    assert torch.equal(finals[0][1], finals[1][1])


def test_elastic_rewind_refetches_batches(tap):
    """ckpt_every=2: a fault at an odd step restores an earlier step, and
    the retry trains the rewound step on that step's batch."""
    finals = []
    for faults in ([], [chaos.FaultSpec("exception", "queue.issue", step=3)]):
        tr, state, batch = _make_trainer()
        x, y = batch
        batches = [(x + 0.01 * i, y) for i in range(6)]
        plan = chaos.FaultPlan(faults, seed=11)
        cfg = ElasticConfig(step_timeout_s=2.0, max_retries=3,
                            backoff_s=0.01, ckpt_every=2)
        with tempfile.TemporaryDirectory() as d, chaos.activate(plan):
            et = ElasticTrainer(tr, d, cfg, plan=plan)
            state, metrics = et.run(state, batches, 6)
        finals.append((float(metrics["loss"]), state.w_own))
    assert finals[0][0] == finals[1][0]
    assert torch.equal(finals[0][1], finals[1][1])


def test_hung_tickets_abandoned_on_recovery(tap, tmp_path):
    tr, state, batch = _make_trainer()
    plan = chaos.FaultPlan([chaos.FaultSpec("preemption", "queue.wait",
                                            step=2)])
    with chaos.activate(plan):
        et = ElasticTrainer(tr, str(tmp_path), _ECFG, plan=plan)
        state, _ = et.run(state, lambda i: batch, 4)
    assert state.step == 4
    assert et.queue.outstanding == 0
    assert et.profiler.collectives.abandoned >= 1


def test_elastic_gives_up_after_max_retries(tap, tmp_path):
    tr, state, batch = _make_trainer()
    plan = chaos.FaultPlan([chaos.FaultSpec("exception", "queue.issue",
                                            step=2) for _ in range(3)])
    cfg = ElasticConfig(step_timeout_s=2.0, max_retries=1, backoff_s=0.01)
    with chaos.activate(plan):
        et = ElasticTrainer(tr, str(tmp_path), cfg, plan=plan)
        with pytest.raises(RecoveryExhausted, match="step 2"):
            et.run(state, lambda i: batch, 5)
    assert et.profiler.recovery.failed_recoveries == 1


def test_recovery_stats_shape_equals_jax():
    dicts = []
    for prof in (Profiler(), JaxProfiler()):
        ev = prof.recovery.record_fault("hang", 3, site="queue.wait",
                                        error="boom")
        prof.recovery.record_recovery(0.5, restored=True, event=ev)
        dicts.append(prof.report()["recovery"])
    assert dicts[0] == dicts[1]
    d = dicts[0]
    assert d["faults"] == {"hang": 1}
    assert d["recoveries"] == 1 and d["checkpoint_restores"] == 1
    assert d["events"][0]["recovered_in_s"] == pytest.approx(0.5)


def test_reshard_tier_is_the_next_slice(tmp_path):
    tr, _, _ = _make_trainer()
    with pytest.raises(NotImplementedError, match="reshard slice"):
        ElasticTrainer(tr, str(tmp_path), _ECFG, reshard=object())


# ---------------------------------------------------------------------------
# the six cases red on the JAX side, held against the port's fault-free
# run and JAX's audit of the same files
# ---------------------------------------------------------------------------

def test_master_guard_blocks_poisoned_checkpoint(tap, tmp_path):
    tr, state, batch = _make_trainer()
    plan = chaos.FaultPlan([chaos.FaultSpec("corruption", "queue.wait",
                                            step=2, mode="nan")], seed=9)
    with chaos.activate(plan):
        et = ElasticTrainer(tr, str(tmp_path), _ECFG, plan=plan)
        state, metrics = et.run(state, lambda i: batch, 4)
    assert state.step == 4
    assert et.profiler.recovery.faults.get("corruption", 0) >= 1
    assert torch.equal(state.w_own, _clean(4))
    for step in et.ckpt._all_steps():
        restored = et.ckpt.restore(step)
        assert np.isfinite(restored["w_own"]).all()
        assert jax_ckpt.Checkpointer(str(tmp_path)).audit_step(step).ok


def _durability(tmp_path, faults):
    finals, recs, dirs = [], [], []
    for i, fs in enumerate(([], faults)):
        tr, state, batch = _make_trainer()
        plan = chaos.FaultPlan(fs, seed=11)
        d = str(tmp_path / f"run{i}")
        with chaos.activate(plan):
            et = ElasticTrainer(tr, d, _ECFG, plan=plan)
            state, metrics = et.run(state, lambda i: batch, 5)
        finals.append((float(metrics["loss"]), state.w_own))
        recs.append(et.profiler.recovery.as_dict())
        dirs.append(d)
    assert finals[0][0] == finals[1][0]
    assert torch.equal(finals[0][1], finals[1][1])
    assert torch.equal(finals[1][1], _clean(5))
    return recs[1], dirs[1]


def test_durability_bitflip_repaired_bit_exact(tap, tmp_path):
    rec, d = _durability(tmp_path, [
        chaos.FaultSpec("corruption", "ckpt.save", step=2, mode="wirebit"),
        chaos.FaultSpec("preemption", "queue.issue", step=3)])
    assert rec["ckpt_repairs"] >= 1, rec
    assert rec["ckpt_repair_wire_bytes"] > 0
    assert rec["checkpoint_restores"] >= 1
    # the repaired step audits clean in JAX's Checkpointer too
    assert jax_ckpt.Checkpointer(d).audit_step(2).ok


def test_durability_stale_manifest_walks_back(tap, tmp_path):
    rec, d = _durability(tmp_path, [
        chaos.FaultSpec("corruption", "ckpt.save", step=2,
                        mode="stale_manifest"),
        chaos.FaultSpec("preemption", "queue.issue", step=3)])
    assert rec["ckpt_repairs"] == 0
    assert rec["checkpoint_restores"] >= 1


@pytest.mark.parametrize("kind", ["kill", "diskfull"])
def test_durability_save_interrupt_absorbed(tap, tmp_path, kind):
    rec, d = _durability(tmp_path, [
        chaos.FaultSpec(kind, "ckpt.save", step=2, fraction=0.5),
        chaos.FaultSpec("preemption", "queue.issue", step=3)])
    assert rec["ckpt_save_failures"] == 1, rec
    assert rec["checkpoint_restores"] >= 1
    assert jax_ckpt.Checkpointer(d).latest_step(verified=True) == 5


def test_emergency_dump_on_ladder_exhaustion(tap, tmp_path):
    tr, state, batch = _make_trainer()
    plan = chaos.FaultPlan(
        [chaos.FaultSpec("exception", "queue.issue", step=2)
         for _ in range(_ECFG.max_retries + 1)], seed=11)
    with chaos.activate(plan):
        et = ElasticTrainer(tr, str(tmp_path), _ECFG, plan=plan)
        with pytest.raises(RecoveryExhausted):
            et.run(state, lambda i: batch, 5)
    rec = et.profiler.recovery.as_dict()
    assert rec["emergency_dumps"] == 1, rec
    dump_step = et.ckpt.latest_step(verified=True)
    assert dump_step == 2
    assert et.ckpt.is_emergency(dump_step)
    assert et.ckpt.audit_step(dump_step, repair="probe").restorable
    jc = jax_ckpt.Checkpointer(str(tmp_path))
    assert jc.is_emergency(dump_step) and jc.audit_step(dump_step).ok
    restored = tr.restore_state(et.ckpt.restore(dump_step))
    assert restored.step == 2
    assert torch.equal(restored.w_own, _clean(2))
