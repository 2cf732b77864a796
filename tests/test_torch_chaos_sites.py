"""The port's fault plans at every site but the reshard wire
(``runtime/chaos.py``) against the JAX package's: the seeded plans, the
damaged bytes of ``corrupt`` / ``stage`` / ``collective_payload`` /
``damage_checkpoint``, the derived site tuples, JAX's spec validation,
and the boundaries that fire them (the queue, the stager, the serving
tick)."""

import os

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from fpga_ai_nic_tpu.runtime import chaos as jax_chaos
from fpga_ai_nic_tpu.utils import checkpoint as jax_ckpt
from fpga_ai_nic_tpu_torch.models import llama
from fpga_ai_nic_tpu_torch.parallel.train import TrainState
from fpga_ai_nic_tpu_torch.runtime import chaos, staging
from fpga_ai_nic_tpu_torch.runtime.queue import CollectiveQueue
from fpga_ai_nic_tpu_torch.serve import ServeConfig, ServeEngine
from fpga_ai_nic_tpu_torch.utils import checkpoint as ckpt
from fpga_ai_nic_tpu_torch.utils.config import CollectiveConfig

MODS = {"jax": jax_chaos, "port": chaos}


def _specs(plan):
    return [(s.kind, s.site, s.step, s.duration_s, s.mode, s.fraction)
            for s in plan.faults]


def test_site_tuples_equal_jax():
    for name in ("FAULT_KINDS", "DURABILITY_KINDS", "TRAIN_SITES",
                 "SERVE_SITES", "WIRE_SITES", "CKPT_SITES", "SITES",
                 "CORRUPTION_MODES"):
        assert getattr(chaos, name) == getattr(jax_chaos, name), name


@pytest.mark.parametrize("seed", [0, 7, 8, 123])
@pytest.mark.parametrize("sites", ["train", "serve"])
def test_random_plan_equals_jax(seed, sites):
    kw = ({} if sites == "train" else
          dict(sites=chaos.SERVE_SITES[:1], rate=0.5, duration_s=0.1))
    got = chaos.FaultPlan.random(seed, 64, **kw)
    want = jax_chaos.FaultPlan.random(seed, 64, **kw)
    assert _specs(got) == _specs(want) and len(got.faults) > 0
    assert got.seed == want.seed == seed
    assert _specs(chaos.FaultPlan.random(seed, 64, **kw)) == _specs(got)


def test_sustained_plan_equals_jax():
    for mod in MODS.values():
        with pytest.raises((AssertionError, ValueError)):
            mod.FaultPlan.sustained("slowdown", "collective", start_step=0,
                                    n_steps=0)
    args = dict(start_step=3, n_steps=5, duration_s=0.3, mode="scale",
                fraction=0.1, seed=4)
    got = chaos.FaultPlan.sustained("slowdown", "collective", **args)
    want = jax_chaos.FaultPlan.sustained("slowdown", "collective", **args)
    assert _specs(got) == _specs(want)
    assert len({id(s) for s in got.faults}) == 5     # one instance a step


def _spec_outcome(mod, kw):
    try:
        mod.FaultSpec(step=0, **kw)
        return "ok"
    except ValueError as e:
        return ("ValueError", str(e).split(":")[0][:40])
    except AssertionError:
        return "ValueError-assert"


@pytest.mark.parametrize("kw", [
    dict(kind="kill", site="ckpt.save", fraction=0.5),
    dict(kind="diskfull", site="ckpt.save"),
    dict(kind="kill", site="queue.issue"),
    dict(kind="diskfull", site="ckpt.restore"),
    dict(kind="corruption", site="ckpt.save", mode="wirebit"),
    dict(kind="corruption", site="ckpt.restore", mode="stale_manifest"),
    dict(kind="corruption", site="ckpt.save", mode="nan"),
    dict(kind="corruption", site="staging", mode="stale_manifest"),
    dict(kind="hang", site="ckpt.save"),
    dict(kind="exception", site="collective"),
    dict(kind="preemption", site="collective"),
    dict(kind="hang", site="collective"),
    dict(kind="corruption", site="serve.step", mode="wirebit"),
    dict(kind="preemption", site="serve.step"),
])
def test_spec_validation_matches_jax(kw):
    assert _spec_outcome(chaos, kw) == _spec_outcome(jax_chaos, kw)


def test_unknown_and_reshard_specs_raise():
    with pytest.raises(ValueError):
        chaos.FaultSpec("corruption", "nowhere", step=0)
    with pytest.raises(ValueError):
        chaos.FaultSpec("melt", "staging", step=0)
    # the live reshard tier's wire is the next slice of ROADMAP A.8
    with pytest.raises(NotImplementedError, match="reshard"):
        chaos.FaultSpec("corruption", "reshard.transfer", step=0,
                        mode="wirebit")


def test_site_and_step_routing_fires_each_spec_once():
    plan = chaos.FaultPlan([
        chaos.FaultSpec("exception", "queue.issue", step=2),
        chaos.FaultSpec("exception", "staging", step=3),
    ])
    plan.begin_step(1)
    plan.fire("queue.issue")                  # wrong step: nothing
    plan.fire("staging")
    plan.begin_step(2)
    plan.fire("staging")                      # wrong site: nothing
    with pytest.raises(chaos.InjectedFault) as ei:
        plan.fire("queue.issue")
    assert ei.value.site == "queue.issue" and ei.value.kind == "exception"
    plan.fire("queue.issue")                  # fired once, now clean
    plan.begin_step(3)
    with pytest.raises(chaos.InjectedFault):
        plan.fire("staging")
    assert len(plan.fired) == 2 and plan.step == 3


@pytest.mark.parametrize("mode", ["nan", "bitflip", "scale", "wirebit"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", [5, 11])
def test_corrupt_changes_the_same_bytes_as_jax(mode, dtype, seed):
    """``corrupt`` at a host site damages the largest float leaf (the
    labels stay) in the same words as JAX's.  bfloat16: JAX's corrupt
    leaves an ml_dtypes leaf alone (numpy does not count it floating), so
    the port's bytes are held against JAX's damage of the f32 values
    rounded back to bf16 (value modes) or of the uint16 words
    (wirebit)."""
    x = np.linspace(-1.0, 1.0, 4096, dtype=np.float32).reshape(64, 64)
    y = np.arange(64, dtype=np.int32)
    spec = dict(kind="corruption", site="staging", step=3, mode=mode,
                fraction=0.01)
    tx = torch.from_numpy(x.copy())
    if dtype == "bfloat16":
        tx = tx.to(torch.bfloat16)
    plan = chaos.FaultPlan([chaos.FaultSpec(**spec)], seed=seed)
    plan.begin_step(3)
    gx, gy = plan.corrupt("staging", (tx, torch.from_numpy(y)))
    assert torch.equal(gy, torch.from_numpy(y))
    jplan = jax_chaos.FaultPlan([jax_chaos.FaultSpec(**spec)], seed=seed)
    jplan.begin_step(3)
    if dtype == "float32":
        jx, jy = jplan.corrupt("staging", (x.copy(), y))
        assert gx.numpy().tobytes() == np.asarray(jx).tobytes()
    elif mode == "wirebit":
        u16 = tx.view(torch.int16).numpy().view(np.uint16).copy()
        want = jplan._corrupt_array(u16, jplan.faults[0])
        assert gx.view(torch.int16).numpy().view(np.uint16).tobytes() == \
            want.tobytes()
    else:
        f = tx.float().numpy().copy()
        want = torch.from_numpy(jplan._corrupt_array(
            f, jplan.faults[0])).to(torch.bfloat16)
        assert gx.view(torch.int16).numpy().tobytes() == \
            want.view(torch.int16).numpy().tobytes()
    assert not torch.equal(gx.float(), tx.float())
    # nothing pending: the same objects back, no copy
    batch = (tx, torch.from_numpy(y))
    assert plan.corrupt("staging", batch) is batch


def test_corrupt_picks_the_master_vector_of_a_trainer_state():
    """A state's working copies (replicas, side) take no part: as in JAX,
    whose states hold the params once, the master vector is the largest
    float leaf, and its damaged words are JAX's on the global vector."""
    n, C = 4, 64
    w = torch.arange(n * C, dtype=torch.float32).reshape(n, C) / 100
    st = TrainState({"w": w[0, :8]}, w.repeat(1, 2), w, {}, 5)
    spec = dict(kind="corruption", site="queue.wait", step=5, mode="nan")
    plan = chaos.FaultPlan([chaos.FaultSpec(**spec)], seed=3)
    plan.begin_step(5)
    got, diag = plan.corrupt("queue.wait", (st, {"loss": torch.ones(())}))
    assert got.replicas is st.replicas and diag["loss"] == 1
    jplan = jax_chaos.FaultPlan([jax_chaos.FaultSpec(**spec)], seed=3)
    jplan.begin_step(5)
    jw = jplan.corrupt("queue.wait", {"w_own": w.reshape(-1).numpy().copy(),
                                      "step": np.int32(5)})["w_own"]
    assert got.w_own.reshape(-1).numpy().tobytes() == jw.tobytes()


@pytest.mark.parametrize("kind", ["hang", "slowdown"])
def test_collective_tap_sleeps_then_corrupts_like_jax(kind):
    a = np.linspace(-2, 2, 512, dtype=np.float32)
    outs = []
    for mod in MODS.values():
        plan = mod.FaultPlan([
            mod.FaultSpec(kind, "collective", step=1, duration_s=0.05),
            mod.FaultSpec("corruption", "collective", step=1, mode="scale")],
            seed=2)
        plan.begin_step(1)
        outs.append(plan.collective_payload(a.copy()))
        assert len(plan.fired) == 2
    assert outs[0].tobytes() == outs[1].tobytes()
    # the port's tap, installed and active, routes a row through it
    plan = chaos.FaultPlan([chaos.FaultSpec(kind, "collective", step=0,
                                            duration_s=0.01)])
    plan.begin_step(0)
    x = torch.ones(8)
    with chaos.activate(plan):
        assert chaos._tap_fn(x, "rs") is x
    assert len(plan.fired) == 1


def _committed(mod_ckpt, d):
    c = mod_ckpt.Checkpointer(d, shards=4, mirror=True)
    g = np.arange(4096, dtype=np.float32)
    c.save(1, {"w": g * 0.5, "step": np.int32(1)})
    c.save(2, {"w": g, "step": np.int32(2)})
    return c


@pytest.mark.parametrize("mode", ["wirebit", "stale_manifest"])
def test_damage_checkpoint_changes_the_same_bytes_as_jax(tmp_path, mode):
    dirs = {}
    for name, mod, mod_ckpt in (("jax", jax_chaos, jax_ckpt),
                                ("port", chaos, ckpt)):
        c = _committed(mod_ckpt, str(tmp_path / name))
        plan = mod.FaultPlan([mod.FaultSpec("corruption", "ckpt.restore",
                                            step=2, mode=mode)], seed=9)
        plan.begin_step(2)
        plan.damage_checkpoint("ckpt.restore", c._path(2),
                               c._prev_manifest(2))
        assert len(plan.fired) == 1
        dirs[name] = c._path(2)
    names = sorted(os.listdir(dirs["jax"]))
    assert names == sorted(os.listdir(dirs["port"]))
    for f in names:
        with open(os.path.join(dirs["jax"], f), "rb") as a, \
                open(os.path.join(dirs["port"], f), "rb") as b:
            assert a.read() == b.read(), f
    # and the port's audit says what JAX's says about the damage
    jrep = jax_ckpt.Checkpointer(str(tmp_path / "jax"), shards=4,
                                 mirror=True).audit_step(2, repair="probe")
    prep = ckpt.Checkpointer(str(tmp_path / "port"), shards=4,
                             mirror=True).audit_step(2, repair="probe")
    assert (prep.ok, prep.restorable) == (jrep.ok, jrep.restorable) == (
        False, mode == "wirebit")


def test_queue_boundaries_fire_and_corrupt():
    plan = chaos.FaultPlan([
        chaos.FaultSpec("exception", "queue.issue", step=0),
        chaos.FaultSpec("preemption", "queue.wait", step=1),
        chaos.FaultSpec("corruption", "queue.wait", step=2, mode="nan"),
        chaos.FaultSpec("corruption", "queue.issue", step=3, mode="scale"),
    ])
    q = CollectiveQueue(lambda x: x * 1, CollectiveConfig(), chaos=plan)
    plan.begin_step(0)
    with pytest.raises(chaos.InjectedFault):
        q.issue(torch.ones(8))
    plan.begin_step(1)
    t = q.issue(torch.ones(8))
    with pytest.raises(chaos.InjectedPreemption):
        q.wait(t)
    q.abandon()
    plan.begin_step(2)
    out = q.wait(q.issue(torch.ones(8)))
    assert int(torch.isnan(out).sum()) == 1
    plan.begin_step(3)
    out = q.wait(q.issue(torch.ones(8)))
    assert float(out.max()) > 1e7                 # the issued args damaged
    assert len(plan.fired) == 4
    # an abandoned ticket fires nothing: the spec stays for the live run
    plan2 = chaos.FaultPlan([chaos.FaultSpec("exception", "queue.wait",
                                             step=0)])
    q2 = CollectiveQueue(lambda x: x, CollectiveConfig(), chaos=plan2)
    plan2.begin_step(0)
    t = q2.issue(torch.ones(2))
    q2.abandon()
    q2.wait(t)
    assert plan2.fired == []


def test_stager_fires_and_corrupts():
    src = np.arange(40, dtype=np.float32).reshape(10, 4)
    plan = chaos.FaultPlan([
        chaos.FaultSpec("exception", "staging", step=0),
        chaos.FaultSpec("corruption", "staging", step=1, mode="nan",
                        fraction=0.25)], seed=1)
    st = staging.Stager(2, 1024, chaos=plan)
    try:
        plan.begin_step(0)
        with pytest.raises(chaos.InjectedFault):
            st.submit(src, np.arange(4))
        plan.begin_step(1)
        s = st.submit(src, np.arange(4))
        got = st.wait(s)
        assert int(np.isnan(got).sum()) == 4      # a copy, damaged
        st.release(s)
        plan.begin_step(2)
        s = st.submit(src, np.arange(4))
        np.testing.assert_array_equal(st.wait(s), src[:4])
        st.release(s)
    finally:
        st.close()


def test_serve_step_fires_inside_the_tick():
    cfg = llama.LlamaConfig.tiny()
    params = llama.init(torch.Generator().manual_seed(0), cfg, "cpu")
    plan = chaos.FaultPlan([chaos.FaultSpec("exception", "serve.step",
                                            step=1)])
    eng = ServeEngine(params, cfg, ServeConfig(
        max_reqs=2, page_size=4, n_pages=12, max_pages_per_seq=4,
        prefill_chunk=4, backoff_s=0.0), chaos=plan, device="cpu")
    eng.submit(np.arange(1, 6, dtype=np.int32), max_new=3)
    s = eng.run()
    assert [f.site for f in plan.fired] == ["serve.step"]
    assert s["recovery"]["faults"] == {"exception": 1}
    assert s["serve_recoveries"] == 1
