"""The explicit queue on the port (``runtime/queue.py``,
``parallel/queued.py``) against the JAX package's.

* ``QueuedDDPTrainer`` bit-equal to the port's ``DDPTrainer`` (the xla
  sum, the BFP ring, the fused BFP route's plain versions, with
  accumulation) and held against JAX's ``QueuedDDPTrainer`` at the
  tolerance of ``tests/test_queued.py`` (rtol 2e-5, atol 1e-7; with BFP
  plus one grid step a step where the two frameworks' gradient sums
  round a boundary value apart).
* The window bounds the inflight count; the counters are live; the
  per-bucket wire accounting is JAX's.
* ``CollectiveStats`` equals JAX's for the same records; the queue's
  ``wait_all`` / ``abandon`` / ``outstanding``; fault plans raise (A.8).
* ``train_mlp`` and ``train_bert`` with ``--queue=explicit`` on the CPU.
"""

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import jax
import jax.numpy as jnp

from fpga_ai_nic_tpu.models import mlp as jax_mlp
from fpga_ai_nic_tpu.parallel import QueuedDDPTrainer as JaxQueued
from fpga_ai_nic_tpu.parallel import make_mesh
from fpga_ai_nic_tpu.utils import config as jcfg
from fpga_ai_nic_tpu.utils import observability as jax_obs
from fpga_ai_nic_tpu_torch import train_bert, train_mlp
from fpga_ai_nic_tpu_torch.models import mlp
from fpga_ai_nic_tpu_torch.parallel import DDPTrainer, QueuedDDPTrainer
from fpga_ai_nic_tpu_torch.parallel.mesh import VirtualRanks
from fpga_ai_nic_tpu_torch.runtime.queue import CollectiveQueue
from fpga_ai_nic_tpu_torch.utils import config as tcfg
from fpga_ai_nic_tpu_torch.utils import observability as obs

CPU = torch.device("cpu")
SIZES = (32, 64, 64, 16)
N, B, ITERS = 8, 32, 3


def _cfg(mod, coll, accum=1):
    return mod.TrainConfig(
        iters=ITERS, global_batch=B, accum_steps=accum,
        mesh=mod.MeshConfig(dp=N), collective=coll,
        optimizer=mod.OptimizerConfig(kind="momentum", learning_rate=0.05))


def _data(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, SIZES[0])).astype(np.float32),
            rng.integers(0, SIZES[-1], B).astype(np.int32))


def _params():
    return jax.tree_util.tree_map(np.asarray, jax_mlp.init(
        jax.random.PRNGKey(0), jcfg.MLPConfig(layer_sizes=SIZES)))


def _port(cls, coll, accum=1, **kw):
    m = tcfg.MLPConfig(layer_sizes=SIZES)
    return cls(lambda p, b: mlp.loss_fn(p, b, m), VirtualRanks(N, CPU),
               _cfg(tcfg, coll, accum), **kw)


def _pbatch(tr, seed):
    x, y = _data(seed)
    return tr.shard_batch((torch.from_numpy(x), torch.from_numpy(y)))


PORT_COLLS = {
    "xla": dict(impl="xla", bucket_elems=1024),
    "bfp_ring": dict(impl="ring", compression="xla", bucket_elems=1024),
    "bfp_fused": dict(impl="ring", compression="pallas", fused_kernel=True,
                      bucket_elems=1024),
}


def _coll(mod, name):
    kw = dict(PORT_COLLS[name])
    if "compression" in kw:
        kw["compression"] = mod.BFPConfig(codec=kw["compression"])
    return mod.CollectiveConfig(**kw)


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("name", sorted(PORT_COLLS))
def test_queued_bit_equal_to_ddp_trainer(name, accum):
    tq = _port(QueuedDDPTrainer, _coll(tcfg, name), accum)
    td = _port(DDPTrainer, _coll(tcfg, name), accum)
    p = mlp.from_jax_params(_params(), CPU)
    sq, sd = tq.init_state(p), td.init_state(p)
    for i in range(ITERS):
        sq, lq = tq.step(sq, _pbatch(tq, i))
        sd, ld = td.step(sd, _pbatch(td, i))
        assert torch.equal(lq, ld)
    assert torch.equal(sq.w_master, sd.w_master)
    assert torch.equal(sq.replicas, sd.replicas)
    for k in sd.opt_state:
        assert torch.equal(sq.opt_state[k], sd.opt_state[k])
    st = tq.profiler.collectives
    assert st.issued == st.completed == ITERS * len(tq.plan.buckets)
    assert st.abandoned == 0


@pytest.mark.parametrize("name", ["xla", "bfp_ring"])
def test_queued_matches_jax_queued(name):
    """JAX's ``test_queued_matches_fused_ddp`` configurations: losses at
    rtol 1e-6, masters within rtol 2e-5 / atol 1e-7 of JAX's queued
    trainer, and the same per-bucket wire bytes."""
    params = _params()
    jt = JaxQueued(lambda p, b: jax_mlp.loss_fn(
        p, b, jcfg.MLPConfig(layer_sizes=SIZES)),
        make_mesh(jcfg.MeshConfig(dp=N)), _cfg(jcfg, _coll(jcfg, name)))
    js = jt.init_state(jax.tree_util.tree_map(jnp.asarray, params))
    tr = _port(QueuedDDPTrainer, _coll(tcfg, name))
    st = tr.init_state(mlp.from_jax_params(params, CPU))
    flips = 0.0
    for i in range(ITERS):
        x, y = _data(i)
        pb = _pbatch(tr, i)
        if name == "bfp_ring":
            # the gradients' sums round in another order than XLA's, so a
            # value on a BFP grid boundary may land one grid step (2^-7
            # of its block's max) apart, carried on by the momentum
            rows, _ = tr.grads(st, pb)
            gmax = max(float(r.abs().max()) for r in rows)
            flips = flips * 1.9 + 0.05 * gmax * 2.0 ** -7
        js, jl = jt.step(js, jt.shard_batch((jnp.asarray(x),
                                             jnp.asarray(y))))
        st, loss = tr.step(st, pb)
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-6)
    np.testing.assert_allclose(
        st.w_master[0].numpy(),
        np.asarray(js.w_master.addressable_shards[0].data).reshape(-1),
        rtol=2e-5, atol=1e-7 + flips)
    assert [b.padded_len for b in tr.plan.buckets] == \
        [b.padded_len for b in jt._plan.buckets]
    pj, pp = jt.profiler.collectives, tr.profiler.collectives
    assert (pp.issued, pp.completed, pp.wire_bytes, pp.raw_bytes) == \
        (pj.issued, pj.completed, pj.wire_bytes, pj.raw_bytes)


def test_queued_window_bounds_inflight():
    tr = _port(QueuedDDPTrainer, tcfg.CollectiveConfig(
        bucket_elems=256, max_inflight=2))
    st = tr.init_state(mlp.from_jax_params(_params(), CPU))
    seen = []
    orig = tr.queue.issue

    def spy(*a, **kw):
        t = orig(*a, **kw)
        seen.append(tr.queue.outstanding)
        return t

    tr.queue.issue = spy
    st, _ = tr.step(st, _pbatch(tr, 0))
    assert len(seen) == len(tr.plan.buckets) > 2
    assert max(seen) <= 2 and tr.queue.max_outstanding == 2
    assert tr.queue.outstanding == 0


def test_queued_profiler_counters_are_live():
    tr = _port(QueuedDDPTrainer, tcfg.CollectiveConfig(
        impl="ring", compression=tcfg.BFPConfig(), bucket_elems=512))
    st = tr.init_state(mlp.from_jax_params(_params(), CPU))
    for i in range(ITERS):
        st, loss = tr.step(st, _pbatch(tr, i))
    assert np.isfinite(float(loss))
    c = tr.profiler.collectives
    nb = len(tr.plan.buckets)
    assert nb >= 2 and c.issued == nb * ITERS == c.completed
    assert c.stall_s + c.overlap_s > 0 and c.latency_max_s > 0
    assert 0 < c.wire_bytes < c.raw_bytes
    rep = tr.profiler.report()
    assert rep["collectives"]["compression_ratio"] > 3.0
    names = {e["name"] for e in tr.profiler.events.snapshot()}
    assert "collective" in names and "queue.issue" in names
    assert {f"bucket{i}.compression_ratio" for i in range(nb)} <= names


def test_collective_stats_match_jax():
    a, b = obs.CollectiveStats(), jax_obs.CollectiveStats()
    for s in (a, b):
        s.record_issue(100, 30)
        s.record_issue(50)
        s.record_completion(0.5, 0.2, 0.3)
        s.record_abandoned(2)
    assert a.as_dict() == b.as_dict()
    assert "collectives" in obs.Profiler().report()


def test_queue_wait_all_abandon_and_refusals():
    q = CollectiveQueue(lambda x: x * 2, tcfg.CollectiveConfig(
        max_inflight=3))
    ts = [q.issue(torch.ones(4) * i, raw_bytes=16) for i in range(3)]
    assert q.outstanding == 3
    assert torch.equal(q.wait(ts[1]), torch.full((4,), 2.0))
    assert q.outstanding == 2
    q.wait_all()
    assert q.outstanding == 0
    t = q.issue(torch.ones(2))
    assert q.abandon() == 1 and t.abandoned
    assert q.profiler.collectives.abandoned == 1
    assert q.wait(t) is t.result
    assert q.profiler.collectives.completed == 3
    with pytest.raises(NotImplementedError, match="A.8"):
        CollectiveQueue(lambda x: x, tcfg.CollectiveConfig(), chaos=object())


def test_train_mlp_explicit_queue_on_cpu():
    argv = ["--device=cpu", "--model.layer_sizes=64,64,64",
            "--global_batch=32", "--iters=2", "--bfp=1", "--mesh.dp=4",
            "--collective.bucket_elems=2048"]
    out = train_mlp.main(argv + ["--queue=explicit"])
    fused = train_mlp.main(argv)
    assert out["queue"] == "explicit" and fused["queue"] == "fused"
    c = out["profile"]["collectives"]
    assert c["issued"] == c["completed"] > 0 and c["abandoned"] == 0
    assert 1 <= out["max_outstanding"] <= 8
    assert np.isfinite(out["loss"])
    with pytest.raises(ValueError, match="fused\\|explicit"):
        train_mlp.queue_flag(["--queue=async"])


def test_train_bert_explicit_queue_on_cpu():
    out = train_bert.main(["--model=tiny", "--device=cpu", "--bfp=1",
                           "--mesh.dp=2", "--iters=2", "--queue=explicit",
                           "--collective.bucket_elems=20000"])
    assert out["queue"] == "explicit"
    assert out["collectives"]["issued"] == 2 * out["n_buckets"]
    assert out["collectives"]["completed"] == out["collectives"]["issued"]
    assert 1 <= out["max_outstanding"] <= 8
