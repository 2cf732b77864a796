"""Gradient accumulation on the port (``parallel/accum.py``) against the
JAX package's ``parallel/accum.py`` and trainers.

* ``accumulated_value_and_grad`` / ``accumulated_loss`` against JAX's on
  the tiny MLP (f32 sums; JAX sums in another order, so within 1e-6).
* ``DPTrainer`` at ``accum_steps=4`` against JAX's ``DPTrainer`` at 4 and
  against itself at 1 (JAX's ``test_accumulation_matches_single_shot``
  tolerance: rtol 2e-5, atol 2e-6), on the plain and the BFP ring.
* ``DDPTrainer`` and ``FSDPTrainer`` against JAX's at ``accum_steps=2``;
  FSDP gathers and reduce-scatters once a step whatever the accumulation.
* ``ShardedTrainer`` over dp=2 x tp=2 on ``LlamaConfig.tiny()`` against
  JAX's ``ShardedTrainer`` (the oracle of JAX's slow
  ``test_accumulation_sharded_llama``), GPipe pp against two unsharded JAX
  SGD steps, and ResNet's sync-BN (a ``joint_ranks`` loss: microbatch k
  of every rank pooled) against JAX's ``DPTrainer``.
* 1F1B with accumulation raises JAX's ``ValueError``.
* The global label count a microbatch (``bert.with_global_count(...,
  accum_steps=)``): a masked-label Llama step against JAX's gradient of
  the uniform average of the microbatches' dp-weighted losses.
* ``train_llama --data= --accum_steps=2`` runs on the CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from fpga_ai_nic_tpu.models import llama as jax_llama
from fpga_ai_nic_tpu.models import mlp as jax_mlp
from fpga_ai_nic_tpu.models import resnet as jax_resnet
from fpga_ai_nic_tpu.parallel import DDPTrainer as JaxDDPTrainer
from fpga_ai_nic_tpu.parallel import DPTrainer as JaxDPTrainer
from fpga_ai_nic_tpu.parallel import FSDPTrainer as JaxFSDPTrainer
from fpga_ai_nic_tpu.parallel import ShardedTrainer as JaxShardedTrainer
from fpga_ai_nic_tpu.parallel import accum as jax_accum
from fpga_ai_nic_tpu.parallel import make_mesh
from fpga_ai_nic_tpu.utils import config as jcfg
from fpga_ai_nic_tpu_torch import train_llama
from fpga_ai_nic_tpu_torch.models import bert, llama, mlp, resnet
from fpga_ai_nic_tpu_torch.ops import fused_update
from fpga_ai_nic_tpu_torch.parallel import accum
from fpga_ai_nic_tpu_torch.parallel.ddp import DDPTrainer
from fpga_ai_nic_tpu_torch.parallel.fsdp import FSDPTrainer
from fpga_ai_nic_tpu_torch.parallel.mesh import VirtualRanks, make_ranks
from fpga_ai_nic_tpu_torch.parallel.sharded import ShardedTrainer
from fpga_ai_nic_tpu_torch.parallel.train import DPTrainer
from fpga_ai_nic_tpu_torch.utils import config as tcfg

CPU = torch.device("cpu")
SIZES = (32, 64, 64, 16)
B = 32
ACC_TOL = dict(rtol=2e-5, atol=2e-6)     # test_accumulation_matches_single_shot
TRAIN_TOL = dict(rtol=5e-4, atol=5e-5)   # test_accumulation_sharded_llama


def _mlp_data(seed=0, n=B):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, SIZES[0])).astype(np.float32),
            rng.integers(0, SIZES[-1], n).astype(np.int32))


def _jax_mlp_params():
    return jax.tree_util.tree_map(np.asarray, jax_mlp.init(
        jax.random.PRNGKey(0), jcfg.MLPConfig(layer_sizes=SIZES)))


def _jax_mlp_loss():
    m = jcfg.MLPConfig(layer_sizes=SIZES)
    return lambda p, b: jax_mlp.loss_fn(p, b, m)


def _port_mlp_loss():
    m = tcfg.MLPConfig(layer_sizes=SIZES)
    return lambda p, b: mlp.loss_fn(p, b, m)


def _train_cfg(mod, accum_steps, mesh, coll=None, kind="momentum"):
    return mod.TrainConfig(
        global_batch=B, accum_steps=accum_steps, mesh=mesh,
        collective=coll or mod.CollectiveConfig(impl="xla"),
        optimizer=mod.OptimizerConfig(kind=kind, learning_rate=0.05))


# -- accumulated_value_and_grad / accumulated_loss ---------------------------

@pytest.mark.parametrize("a", [1, 4])
def test_accumulated_value_and_grad_matches_jax(a):
    params = _jax_mlp_params()
    x, y = _mlp_data()
    jl, jg = jax_accum.accumulated_value_and_grad(_jax_mlp_loss(), a)(
        jax.tree_util.tree_map(jnp.asarray, params),
        (jnp.asarray(x), jnp.asarray(y)))
    pl, pg = accum.accumulated_value_and_grad(_port_mlp_loss(), a)(
        mlp.from_jax_params(params, CPU),
        (torch.from_numpy(x), torch.from_numpy(y)))
    np.testing.assert_allclose(float(pl), float(jl), rtol=1e-6)
    for g, w in zip(fused_update.tree_leaves(pg),
                    jax.tree_util.tree_leaves(jg)):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-7)


def test_accumulated_loss_matches_jax_and_splits_leading_axis():
    params = _jax_mlp_params()
    x, y = _mlp_data(1)
    jl = jax_accum.accumulated_loss(_jax_mlp_loss(), 4)(
        jax.tree_util.tree_map(jnp.asarray, params),
        (jnp.asarray(x), jnp.asarray(y)))
    pl = accum.accumulated_loss(_port_mlp_loss(), 4)(
        mlp.from_jax_params(params, CPU),
        (torch.from_numpy(x), torch.from_numpy(y)))
    np.testing.assert_allclose(float(pl), float(jl), rtol=1e-6)
    with pytest.raises(ValueError, match="does not split"):
        accum.accumulated_loss(_port_mlp_loss(), 5)(
            mlp.from_jax_params(params, CPU),
            (torch.from_numpy(x), torch.from_numpy(y)))


def test_microbatches_take_each_ranks_rows():
    """Microbatch k holds rows k m .. (k+1) m - 1 of every rank's shard
    (JAX's reshape of each device's batch); a count leaf of one entry a
    microbatch splits with them, a bare rank axis raises."""
    x = torch.arange(16).reshape(2, 8)              # [n, B_local]
    c = torch.tensor([[5, 6], [5, 6]])              # [n, accum_steps]
    mbs = accum.microbatches((x, c), 2, lead=1)
    assert mbs[0][0].tolist() == [[0, 1, 2, 3], [8, 9, 10, 11]]
    assert mbs[1][1].tolist() == [[6], [6]]
    with pytest.raises(ValueError, match="rank axis"):
        accum.microbatches((x, torch.tensor([5, 5])), 2, lead=1)


# -- DPTrainer ------------------------------------------------------------------

DP_COLLS = {"xla": dict(impl="xla"), "ring": dict(impl="ring"),
            "ring_bfp": dict(impl="ring", compression="bfp")}


def _coll(mod, name):
    kw = dict(DP_COLLS[name])
    if kw.get("compression") == "bfp":
        kw["compression"] = mod.BFPConfig()
    return mod.CollectiveConfig(**kw)


def _port_dp(a, name, n=2):
    return DPTrainer(_port_mlp_loss(), VirtualRanks(n, CPU), _train_cfg(
        tcfg, a, tcfg.MeshConfig(dp=n), _coll(tcfg, name)))


def _run_port(tr, params, batches):
    st = tr.init_state(mlp.from_jax_params(params, CPU))
    losses = []
    for x, y in batches:
        st, loss = tr.step(st, tr.shard_batch((torch.from_numpy(x),
                                               torch.from_numpy(y))))
        losses.append(float(loss))
    return st, losses


@pytest.mark.parametrize("name", sorted(DP_COLLS))
def test_dp_trainer_accum4_matches_jax_and_single_shot(name):
    """Three momentum steps at accum_steps=4: the losses and masters of
    JAX's DPTrainer at 4 and of the port's own at 1, within the tolerance
    of JAX's ``test_accumulation_matches_single_shot``."""
    params = _jax_mlp_params()
    batches = [_mlp_data(s) for s in range(3)]
    jc = _train_cfg(jcfg, 4, jcfg.MeshConfig(dp=2), _coll(jcfg, name))
    jt = JaxDPTrainer(_jax_mlp_loss(), make_mesh(jc.mesh), jc)
    js = jt.init_state(jax.tree_util.tree_map(jnp.asarray, params))
    jl = []
    for x, y in batches:
        js, loss = jt.step(js, jt.shard_batch((jnp.asarray(x),
                                               jnp.asarray(y))))
        jl.append(float(loss))
    s4, l4 = _run_port(_port_dp(4, name), params, batches)
    s1, l1 = _run_port(_port_dp(1, name), params, batches)
    np.testing.assert_allclose(l4, jl, rtol=1e-5)
    np.testing.assert_allclose(l4, l1, rtol=1e-5)
    np.testing.assert_allclose(s4.w_own.numpy().reshape(-1),
                               np.asarray(js.w_own), **ACC_TOL)
    np.testing.assert_allclose(s4.w_own.numpy(), s1.w_own.numpy(),
                               **ACC_TOL)


def test_dp_trainer_accum_runs_collective_once_a_step(monkeypatch):
    """The reduce-scatter and the gather run once a step at any
    accum_steps; the backward once a microbatch."""
    calls = {"rs": 0, "ag": 0, "bwd": 0}
    rs, ag = fused_update.reduce_scatter_update, fused_update.all_gather_flat
    from fpga_ai_nic_tpu_torch.parallel import train as ptrain
    pr = ptrain.per_rank_grads

    def count(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(fused_update, "reduce_scatter_update",
                        count("rs", rs))
    monkeypatch.setattr(fused_update, "all_gather_flat", count("ag", ag))
    monkeypatch.setattr(ptrain, "per_rank_grads", count("bwd", pr))
    tr = DPTrainer(_port_mlp_loss(), VirtualRanks(2, CPU), _train_cfg(
        tcfg, 4, tcfg.MeshConfig(dp=2), tcfg.CollectiveConfig(
            impl="ring", compression=tcfg.BFPConfig(codec="pallas"),
            fused_kernel=True, fused_optimizer=True), kind="sgd"))
    _run_port(tr, _jax_mlp_params(), [_mlp_data(0), _mlp_data(1)])
    assert calls == {"rs": 2, "ag": 2, "bwd": 8}


# -- DDPTrainer and FSDPTrainer ----------------------------------------------------

@pytest.mark.parametrize("name", ["xla", "ring_bfp"])
def test_ddp_trainer_accum_matches_jax(name):
    params = _jax_mlp_params()
    batches = [_mlp_data(s) for s in range(2)]
    coll_kw = dict(bucket_elems=1024)
    jc = dataclasses.replace(
        _train_cfg(jcfg, 2, jcfg.MeshConfig(dp=4), _coll(jcfg, name)))
    jc = dataclasses.replace(jc, collective=dataclasses.replace(
        jc.collective, **coll_kw))
    jt = JaxDDPTrainer(_jax_mlp_loss(), make_mesh(jc.mesh), jc)
    js = jt.init_state(jax.tree_util.tree_map(jnp.asarray, params))
    pc = _train_cfg(tcfg, 2, tcfg.MeshConfig(dp=4), _coll(tcfg, name))
    pc = dataclasses.replace(pc, collective=dataclasses.replace(
        pc.collective, **coll_kw))
    tr = DDPTrainer(_port_mlp_loss(), VirtualRanks(4, CPU), pc)
    st = tr.init_state(mlp.from_jax_params(params, CPU))
    flips = 0.0
    for x, y in batches:
        pb = tr.shard_batch((torch.from_numpy(x), torch.from_numpy(y)))
        if name == "ring_bfp":
            # the gradients' sums round in another order than JAX's, so a
            # value on a BFP grid boundary may land one grid step (2^-7
            # of its block's max) apart; momentum carries it into the
            # next step's update too
            rows, _ = tr.grads(st, pb)
            gmax = max(float(r.abs().max()) for r in rows)
            flips = flips * 1.9 + 0.05 * gmax * 2.0 ** -7
        js, jl = jt.step(js, jt.shard_batch((jnp.asarray(x),
                                             jnp.asarray(y))))
        st, loss = tr.step(st, pb)
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    np.testing.assert_allclose(st.w_master[0].numpy(),
                               np.asarray(js.w_master).reshape(-1),
                               rtol=ACC_TOL["rtol"],
                               atol=ACC_TOL["atol"] + flips)
    assert bool((st.w_master == st.w_master[0]).all())


def _jax_fsdp_mesh(n):
    return Mesh(np.array(jax.devices()[:n]).reshape(1, n, 1, 1, 1, 1),
                ("dp", "fsdp", "tp", "sp", "pp", "ep"))


@pytest.mark.parametrize("impl", ["xla", "ring"])
def test_fsdp_trainer_accum_matches_jax_one_gather(impl, monkeypatch):
    """accum_steps=2 under ZeRO-3: losses and masters against JAX's
    FSDPTrainer (the loss accumulated under one gather), and one gather
    and one reduce-scatter a step."""
    params = _jax_mlp_params()
    batches = [_mlp_data(s) for s in range(2)]
    jc = _train_cfg(jcfg, 2, jcfg.MeshConfig(fsdp=4),
                    jcfg.CollectiveConfig(impl=impl))
    jt = JaxFSDPTrainer(_jax_mlp_loss(), _jax_fsdp_mesh(4), jc)
    js = jt.init_state(jax.tree_util.tree_map(jnp.asarray, params))
    calls = {"ag": 0, "rs": 0}
    ag, rs = fused_update.all_gather_flat, fused_update.reduce_scatter

    def c_ag(*a, **k):
        calls["ag"] += 1
        return ag(*a, **k)

    def c_rs(*a, **k):
        calls["rs"] += 1
        return rs(*a, **k)

    monkeypatch.setattr(fused_update, "all_gather_flat", c_ag)
    monkeypatch.setattr(fused_update, "reduce_scatter", c_rs)
    tr = FSDPTrainer(_port_mlp_loss(), VirtualRanks(4, CPU), _train_cfg(
        tcfg, 2, tcfg.MeshConfig(fsdp=4), tcfg.CollectiveConfig(impl=impl)))
    st = tr.init_state(mlp.from_jax_params(params, CPU))
    for x, y in batches:
        js, jl = jt.step(js, jt.shard_batch((jnp.asarray(x),
                                             jnp.asarray(y))))
        st, loss = tr.step(st, tr.shard_batch((torch.from_numpy(x),
                                               torch.from_numpy(y))))
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    np.testing.assert_allclose(st.w_own.numpy(),
                               np.asarray(js.w_own).reshape(4, -1),
                               **ACC_TOL)
    assert calls == {"ag": 2, "rs": 2}


def test_fsdp_error_feedback_accum_takes_residual_once():
    """The top-k route accumulates its rank gradients before the one
    error-feedback encode: with each rank's two microbatches its
    accum_steps=1 shard, the residual and the masters equal the
    accum_steps=1 step's."""
    params = mlp.from_jax_params(_jax_mlp_params(), CPU)
    x, y = _mlp_data(2, n=B // 2)
    coll = tcfg.CollectiveConfig(impl="ring", codec="topk",
                                 codec_opts=(("k", 8),))
    outs = []
    h = len(x) // 2

    def twice(v):
        # each rank's two microbatches are its accum_steps=1 shard
        return np.concatenate([v[:h], v[:h], v[h:], v[h:]])

    for a, (xx, yy) in ((1, (x, y)), (2, (twice(x), twice(y)))):
        cfg = dataclasses.replace(_train_cfg(tcfg, a, tcfg.MeshConfig(
            fsdp=2), coll), global_batch=len(xx))
        tr = FSDPTrainer(_port_mlp_loss(), VirtualRanks(2, CPU), cfg)
        st = tr.init_state(params)
        st, _ = tr.step(st, tr.shard_batch((torch.from_numpy(xx),
                                            torch.from_numpy(yy))))
        outs.append(st)
    np.testing.assert_allclose(outs[1].codec_state.numpy(),
                               outs[0].codec_state.numpy(), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(outs[1].w_own.numpy(), outs[0].w_own.numpy(),
                               rtol=1e-6, atol=1e-7)


# -- ShardedTrainer -----------------------------------------------------------

JC = jax_llama.LlamaConfig.tiny()
LB, LS = 8, 16


def _llama_batch(seed=0):
    toks = np.random.default_rng(seed).integers(
        0, JC.vocab, (LB, LS + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def _llama_params(seed=0):
    return jax.tree_util.tree_map(np.asarray, jax_llama.init(
        jax.random.PRNGKey(seed), JC))


def _pc():
    return llama.LlamaConfig(**JC.__dict__)


def test_sharded_dp_tp_accum_matches_jax_sharded_trainer():
    """dp=2 x tp=2, accum_steps=2, two SGD steps: JAX's ShardedTrainer
    (the oracle of its slow ``test_accumulation_sharded_llama``) and the
    port's at accum_steps=1, within that test's tolerances."""
    params = _llama_params()
    batch = _llama_batch()

    def jax_run(a):
        mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2, 1),
                    ("dp", "tp", "sp"))
        cfg = jcfg.TrainConfig(
            global_batch=LB, accum_steps=a,
            mesh=jcfg.MeshConfig(dp=2, tp=2),
            collective=jcfg.CollectiveConfig(impl="xla"),
            optimizer=jcfg.OptimizerConfig(kind="sgd", learning_rate=0.1))
        tr = JaxShardedTrainer(
            lambda p, b: jax_llama.loss_fn(p, b, JC, tp_axis="tp"), mesh,
            cfg, jax_llama.param_specs(JC))
        st = tr.init_state(jax.tree_util.tree_map(jnp.asarray, params))
        sb = tr.shard_batch(tuple(map(jnp.asarray, batch)))
        for _ in range(2):
            st, loss = tr.step(st, sb)
        return st, float(loss)

    def port_run(a):
        pc = _pc()
        cfg = tcfg.TrainConfig(
            global_batch=LB, accum_steps=a,
            mesh=tcfg.MeshConfig(dp=2, tp=2),
            collective=tcfg.CollectiveConfig(impl="xla"),
            optimizer=tcfg.OptimizerConfig(kind="sgd", learning_rate=0.1))
        tr = ShardedTrainer(
            lambda p, b: llama.loss_fn(p, b, pc, tp_axis="tp"),
            make_ranks(cfg.mesh, "cpu"), cfg,
            param_specs=llama.param_specs(pc, "tp", tp_size=2))
        st = tr.init_state(llama.params_from_jax(params, "cpu"))
        sb = tr.shard_batch(tuple(map(torch.from_numpy, batch)))
        for _ in range(2):
            st, loss = tr.step(st, sb)
        return tr, st, float(loss)

    js, jl = jax_run(2)
    tr2, s2, l2 = port_run(2)
    _, s1, l1 = port_run(1)
    np.testing.assert_allclose(l2, jl, rtol=1e-5)
    np.testing.assert_allclose(l2, l1, rtol=1e-5)
    for g, w in zip(fused_update.tree_leaves(tr2.global_params(s2)),
                    jax.tree_util.tree_leaves(js.params)):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), **TRAIN_TOL)
    np.testing.assert_allclose(s2.w_own.numpy(), s1.w_own.numpy(),
                               **TRAIN_TOL)


def _unsharded_sgd(params, batch, steps=2, lr=0.1):
    """``steps`` unsharded JAX SGD steps on the whole batch."""
    tree = jax.tree_util.tree_map(jnp.asarray, params)
    b = tuple(map(jnp.asarray, batch))
    grad = jax.jit(jax.grad(lambda p: jax_llama.loss_fn(p, b, JC)))
    for _ in range(steps):
        g = grad(tree)
        tree = jax.tree_util.tree_map(lambda w, gg: w - lr * gg, tree, g)
    return tree


@pytest.mark.parametrize("mesh", [dict(dp=2, pp=2), dict(dp=2, sp=2)])
def test_sharded_pp_gpipe_and_sp_accum_match_unsharded_steps(mesh):
    """GPipe over dp=2 x pp=2 (2 pipeline microbatches inside each
    accumulation microbatch) and dp=2 x sp=2 at accum_steps=2: two SGD
    steps against two unsharded JAX SGD steps on the whole batch (JAX's
    own pp and sp trainers with accumulation have no green test)."""
    params = _llama_params(1)
    batch = _llama_batch(1)
    want = _unsharded_sgd(params, batch)
    pc = _pc()
    cfg = tcfg.TrainConfig(
        global_batch=LB, accum_steps=2, mesh=tcfg.MeshConfig(**mesh),
        collective=tcfg.CollectiveConfig(impl="xla"),
        optimizer=tcfg.OptimizerConfig(kind="sgd", learning_rate=0.1))
    if mesh.get("pp"):
        tr = ShardedTrainer(
            lambda p, b: llama.loss_fn_pp(p, b, pc, num_microbatches=2),
            make_ranks(cfg.mesh, "cpu"), cfg,
            param_specs=llama.stacked_param_specs(pc))
        init = llama.stack_params(llama.params_from_jax(params, "cpu"))
    else:
        pc = dataclasses.replace(pc, attn_block=8)
        tr = ShardedTrainer(
            lambda p, b: llama.loss_fn(p, b, pc, sp_axis="sp"),
            make_ranks(cfg.mesh, "cpu"), cfg)
        init = llama.params_from_jax(params, "cpu")
    st = tr.init_state(init)
    sb = tr.shard_batch(tuple(map(torch.from_numpy, batch)))
    for _ in range(2):
        st, loss = tr.step(st, sb)
    got = tr.global_params(st)
    if mesh.get("pp"):
        layers = got["layers"]
        got = dict(got, layers=[{k: (v[i] if not isinstance(v, dict) else
                                     {kk: vv[i] for kk, vv in v.items()})
                                 for k, v in layers.items()}
                                for i in range(JC.n_layers)])
    for g, w in zip(fused_update.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), **TRAIN_TOL)


def test_1f1b_with_accumulation_raises_jax_value_error():
    cfg = tcfg.TrainConfig(global_batch=8, mesh=tcfg.MeshConfig(dp=2, pp=2),
                           accum_steps=2,
                           collective=tcfg.CollectiveConfig(impl="xla"))
    with pytest.raises(ValueError, match="does not\ncompose|compose with "
                       "accum_steps"):
        ShardedTrainer(None, make_ranks(cfg.mesh, "cpu"), cfg,
                       loss_and_grads_fn=lambda p, b, out=None: None)


# -- ResNet sync-BN (joint_ranks) --------------------------------------------------

def test_resnet_sync_bn_accum_matches_jax_dp_trainer():
    """A loss over all ranks at once: microbatch k of every rank shares
    its batch-norm moments, as JAX's scan pools them.  Two momentum steps
    at accum_steps=2 against JAX's DPTrainer with bn_axis="dp"."""
    rcfg, jrc = resnet.ResNetConfig.tiny(), jax_resnet.ResNetConfig.tiny()
    jp = jax_resnet.init(jax.random.PRNGKey(0), jrc)
    pn = jax.tree_util.tree_map(np.asarray, jp)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((16, 16, 16, 3)).astype(np.float32)
    y = rng.integers(0, rcfg.num_classes, 16).astype(np.int32)

    def cfg(mod):
        return mod.TrainConfig(
            global_batch=16, accum_steps=2, mesh=mod.MeshConfig(dp=4),
            collective=mod.CollectiveConfig(impl="ring"),
            optimizer=mod.OptimizerConfig(kind="momentum",
                                          learning_rate=0.1))

    jc = cfg(jcfg)
    jt = JaxDPTrainer(lambda p, b: jax_resnet.loss_fn(p, b, jrc,
                                                      bn_axis="dp"),
                      make_mesh(jc.mesh), jc)
    js = jt.init_state(jp)
    tr = DPTrainer(resnet.dp_loss_fn(rcfg), VirtualRanks(4, CPU), cfg(tcfg))
    st = tr.init_state(resnet.from_jax_params(pn, "cpu"))
    jb = jt.shard_batch((jnp.asarray(x), jnp.asarray(y)))
    pb = tr.shard_batch((torch.from_numpy(x), torch.from_numpy(y)))
    for _ in range(2):
        js, jl = jt.step(js, jb)
        st, loss = tr.step(st, pb)
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    np.testing.assert_allclose(st.w_own.numpy().reshape(-1),
                               np.asarray(js.w_own), rtol=0, atol=2e-6)


# -- the global count a microbatch ------------------------------------------------

def test_with_global_count_per_microbatch():
    labels = torch.full((8, 4), 1)
    labels[0, :3] = -100          # rank 0, microbatch 0
    labels[5, :] = -100           # rank 1, microbatch 0 (rows 4-5)
    toks, lab, count = bert.with_global_count((labels, labels), 2, 2)
    # rank i's entries are the two microbatches' global counts
    assert count.tolist() == [9, 16, 9, 16]
    assert bert.with_global_count((labels, labels), 2)[2].tolist() == \
        [25, 25]


def test_masked_llama_accum_matches_jax_dp_weighting():
    """Masked labels, dp=2, accum_steps=2: the port's step (each
    microbatch weighted by its global count, ``dp_size=2``) against JAX's
    gradient of the uniform average over microbatches of the
    dp-weighted loss (a microbatch's NLL sum over its global count)."""
    params = _llama_params(2)
    toks, labels = _llama_batch(2)
    labels = labels.copy()
    labels[np.random.default_rng(5).random(labels.shape) < 0.3] = -100
    n, a, lr = 2, 2, 0.1

    def ref_loss(p):
        per = LB // n // a
        total = 0.0
        for k in range(a):
            rows = np.concatenate([np.arange(i * LB // n + k * per,
                                             i * LB // n + (k + 1) * per)
                                   for i in range(n)])
            lb = jnp.asarray(labels[rows])
            logits = jax_llama.apply(p, jnp.asarray(toks[rows]), JC)
            logz = jax.nn.log_softmax(logits.astype(jnp.float32), -1)
            valid = lb >= 0
            nll = -jnp.take_along_axis(logz, jnp.where(valid, lb, 0)[..., None],
                                       -1)[..., 0]
            total = total + jnp.where(valid, nll, 0).sum() / valid.sum()
        return total / a

    tree = jax.tree_util.tree_map(jnp.asarray, params)
    g = jax.grad(ref_loss)(tree)
    want = jax.tree_util.tree_map(lambda w, gg: w - lr * gg, tree, g)
    pc = _pc()
    cfg = tcfg.TrainConfig(
        global_batch=LB, accum_steps=a, mesh=tcfg.MeshConfig(dp=n),
        collective=tcfg.CollectiveConfig(impl="xla"),
        optimizer=tcfg.OptimizerConfig(kind="sgd", learning_rate=lr))
    tr = ShardedTrainer(lambda p, b: llama.loss_fn(p, b, pc, dp_size=n),
                        make_ranks(cfg.mesh, "cpu"), cfg)
    st = tr.init_state(llama.params_from_jax(params, "cpu"))
    batch = bert.with_global_count((torch.from_numpy(toks),
                                    torch.from_numpy(labels)), n, a)
    st, loss = tr.step(st, tr.shard_batch(batch))
    np.testing.assert_allclose(float(loss), float(ref_loss(tree)),
                               rtol=1e-5)
    for gp, w in zip(fused_update.tree_leaves(st.params),
                     jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(gp.float().numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-6)


def test_train_llama_data_accum_on_cpu(tmp_path):
    """``--data=`` (a directory of ``*.txt``) with ``--accum_steps=2``:
    finite losses, boundary-masked labels counted, the JSON's keys."""
    rng = np.random.default_rng(0)
    for i in range(2):
        words = ["".join(chr(97 + c) for c in rng.integers(0, 26, 5))
                 for _ in range(60)]
        (tmp_path / f"d{i}.txt").write_text(
            " ".join(words[:30]) + "\n\n" + " ".join(words[30:]) + "\n")
    out = train_llama.main([
        "--model=tiny", "--device=cpu", "--model.vocab=384",
        "--model.attn_block=16", "--seq=32", "--global_batch=8",
        "--mesh.dp=2", "--iters=2", "--accum_steps=2",
        f"--data={tmp_path}"])
    assert np.isfinite(out["losses"]).all() and len(out["losses"]) == 3
    assert out["accum_steps"] == 2
    assert 0 < out["data"]["masked_share"] < 0.1
    with pytest.raises(ValueError, match="vocab"):
        train_llama.main(["--model=tiny", "--device=cpu", "--seq=32",
                          "--global_batch=8", "--mesh.dp=2", "--iters=1",
                          f"--data={tmp_path}"])
    # with sp the count replicates over the sequence shards
    out = train_llama.main(["--model=tiny", "--device=cpu", "--seq=256",
                            "--model.vocab=384", "--global_batch=4",
                            "--mesh.dp=2", "--mesh.sp=2", "--iters=1",
                            f"--data={tmp_path}"])
    assert np.isfinite(out["losses"]).all() and len(out["losses"]) == 2
