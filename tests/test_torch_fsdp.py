"""The port's ZeRO-3 trainer (``parallel.fsdp.FSDPTrainer``) against the JAX
package's ``FSDPTrainer``, the port's ZeRO-1 ``DPTrainer`` and the golden
composition.

* ``impl="xla"`` and ``impl="ring"`` (flat, and hier with intra_size 4):
  the losses and masters of four momentum steps within JAX's own tolerance
  (``tests/test_fsdp.py``: rtol 1e-5 / atol 1e-6), against JAX's trainer
  on 8 CPU devices and against the port's ``DPTrainer``.
* The BFP wire: one step's masters bit-equal to the goldens composed (the
  golden all-gather of the masters, the golden reduce-scatter of JAX's
  cotangent at the gathered weights, ``golden_fused_apply``).  The port's
  step is fed JAX's cotangent through a linear loss, whose gradient is its
  coefficients in both frameworks.
* Error feedback (top-k) on exact gradients: the residual, and the
  masters of the fused update, bit-equal to JAX's ``FSDPState`` after
  every step.
* The state holds no replicated parameters; ``gathered_params`` gives
  back the initial tree; ``obs_static_metrics`` equals JAX's.
* The ``mlp_fsdp`` arm of the codec convergence eval against JAX's.
"""

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from fpga_ai_nic_tpu import optim as jax_optim
from fpga_ai_nic_tpu.compress import get_codec as jax_get_codec
from fpga_ai_nic_tpu.compress import golden as jax_golden
from fpga_ai_nic_tpu.evals import codec_convergence as jax_cc
from fpga_ai_nic_tpu.models import mlp as jax_mlp
from fpga_ai_nic_tpu.parallel import FSDPTrainer as JaxFSDPTrainer
from fpga_ai_nic_tpu.utils import config as jcfg
from fpga_ai_nic_tpu_torch.evals import codec_convergence as cc
from fpga_ai_nic_tpu_torch.models import mlp
from fpga_ai_nic_tpu_torch.ops import fused_update
from fpga_ai_nic_tpu_torch.parallel import FSDPTrainer
from fpga_ai_nic_tpu_torch.parallel.ddp import DDPTrainer
from fpga_ai_nic_tpu_torch.parallel.mesh import VirtualRanks, make_ranks
from fpga_ai_nic_tpu_torch.parallel.train import DPTrainer
from fpga_ai_nic_tpu_torch.utils import config

N, BATCH, STEPS = 8, 64, 4
SIZES = (64, 128, 128, 32)
CPU = torch.device("cpu")


def _jax_mesh():
    return Mesh(np.array(jax.devices()[:N]).reshape(1, N, 1, 1, 1, 1),
                ("dp", "fsdp", "tp", "sp", "pp", "ep"))


def _cfg(mod, coll_kw, mesh="fsdp", opt=None, **kw):
    return mod.TrainConfig(
        iters=1, global_batch=BATCH, mesh=mod.MeshConfig(**{mesh: N}),
        collective=mod.CollectiveConfig(**coll_kw),
        optimizer=opt or mod.OptimizerConfig(kind="momentum",
                                             learning_rate=1e-2), **kw)


def _data(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((BATCH, SIZES[0])).astype(np.float32),
            rng.integers(0, SIZES[-1], BATCH).astype(np.int32))


def _jax_params():
    p = jax_mlp.init(jax.random.PRNGKey(0), jcfg.MLPConfig(layer_sizes=SIZES))
    return jax.tree_util.tree_map(np.asarray, p)


def _port_loss():
    m = config.MLPConfig(layer_sizes=SIZES)
    return lambda p, b: mlp.loss_fn(p, b, m)


def _jax_loss():
    m = jcfg.MLPConfig(layer_sizes=SIZES)
    return lambda p, b: jax_mlp.loss_fn(p, b, m)


def _port_fsdp(coll_kw, **kw):
    return FSDPTrainer(_port_loss(), VirtualRanks(N, CPU),
                       _cfg(config, coll_kw, **kw))


def _port_batch(tr, x, y):
    return tr.shard_batch((torch.from_numpy(x), torch.from_numpy(y)))


COLLECTIVES = {
    "xla": dict(impl="xla"),
    "ring": dict(impl="ring"),
    "ring_hier4": dict(impl="ring", topology="hier", intra_size=4),
}


@pytest.mark.parametrize("name", sorted(COLLECTIVES))
def test_fsdp_matches_jax_fsdp_trainer(name):
    """Four momentum steps from JAX's initial weights: losses within rtol
    1e-5 and masters within rtol 1e-5 / atol 1e-6 of JAX's FSDPTrainer
    with the same collective."""
    coll = COLLECTIVES[name]
    params = _jax_params()
    x, y = _data()
    jt = JaxFSDPTrainer(_jax_loss(), _jax_mesh(), _cfg(jcfg, coll))
    js = jt.init_state(jax.tree_util.tree_map(jnp.asarray, params))
    tr = _port_fsdp(coll)
    st = tr.init_state(mlp.from_jax_params(params, CPU))
    lj, lp = [], []
    for _ in range(STEPS):
        js, a = jt.step(js, jt.shard_batch((jnp.asarray(x),
                                            jnp.asarray(y))))
        st, b = tr.step(st, _port_batch(tr, x, y))
        lj.append(float(a))
        lp.append(float(b))
    np.testing.assert_allclose(lp, lj, rtol=1e-5)
    assert lp[-1] < lp[0]
    np.testing.assert_allclose(st.w_own.numpy(),
                               np.asarray(js.w_own).reshape(N, -1),
                               rtol=1e-5, atol=1e-6)
    assert st.step == STEPS
    assert tr.obs_static_metrics() == jt.obs_static_metrics()


@pytest.mark.parametrize("name", sorted(COLLECTIVES))
def test_fsdp_matches_dp_trainer(name):
    """ZeRO-3 against the port's ZeRO-1 trainer on the same model, batch
    and optimizer: only the collective schedule differs."""
    coll = COLLECTIVES[name]
    p = mlp.from_jax_params(_jax_params(), CPU)
    x, y = _data(1)
    tf = _port_fsdp(coll)
    sf = tf.init_state(p)
    td = DPTrainer(_port_loss(), VirtualRanks(N, CPU),
                   _cfg(config, coll, mesh="dp"))
    sd = td.init_state(p)
    lf, ld = [], []
    for _ in range(STEPS):
        sf, a = tf.step(sf, _port_batch(tf, x, y))
        sd, b = td.step(sd, _port_batch(td, x, y))
        lf.append(float(a))
        ld.append(float(b))
    np.testing.assert_allclose(lf, ld, rtol=1e-5)
    np.testing.assert_allclose(sf.w_own.numpy(), sd.w_own.numpy(),
                               rtol=1e-5, atol=1e-6)


def test_fsdp_state_is_sharded_only():
    """The persistent state is the [n, C] master and optimizer shards and
    nothing else (no replicated working weights); the gather before any
    step gives back the initial tree exactly (f32 model, no codec)."""
    params = mlp.from_jax_params(_jax_params(), CPU)
    tr = _port_fsdp(dict(impl="ring"))
    st = tr.init_state(params)
    total = sum(t.numel() for t in fused_update.tree_leaves(params))
    assert set(st._fields) == {"w_own", "opt_state", "step", "codec_state"}
    for leaf in (st.w_own, *st.opt_state.values()):
        assert leaf.shape[0] == N
        assert leaf.shape[1] <= total // N + N * 16, leaf.shape
    assert st.codec_state is None
    got = tr.gathered_params(st)
    for a, b in zip(fused_update.tree_leaves(got),
                    fused_update.tree_leaves(params)):
        assert torch.equal(a, b)
    assert tr.batch_spec == ("fsdp",)


def _linear_loss_port(p, b):
    """sum(leaf * c): the gradient is c exactly, in both frameworks."""
    return sum((leaf * c[0]).sum()
               for leaf, c in zip(fused_update.tree_leaves(p), b))


def _linear_loss_jax(p, b):
    return sum((leaf * c[0]).sum()
               for leaf, c in zip(jax.tree_util.tree_leaves(p), b))


def _jax_cotangent(gathered, x, y, meta):
    """JAX's per-rank gradient of the MLP loss at each rank's gathered
    flat vector (tree order), as per-leaf coefficient stacks [n, *shape]."""
    vg = jax.jit(jax.grad(_jax_loss()))
    tree = jax.tree_util.tree_structure(_jax_params())
    per_rank = []
    for i in range(N):
        leaves, off = [], 0
        for shape, size in zip(meta.shapes, meta.sizes):
            leaves.append(jnp.asarray(gathered[i, off:off + size]
                                      .reshape(shape)))
            off += size
        sl = slice(i * BATCH // N, (i + 1) * BATCH // N)
        g = vg(jax.tree_util.tree_unflatten(tree, leaves),
               (jnp.asarray(x[sl]), jnp.asarray(y[sl])))
        per_rank.append([np.asarray(v) for v in jax.tree_util.tree_leaves(g)])
    return [np.stack([r[k] for r in per_rank])
            for k in range(len(meta.shapes))]


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_fsdp_bfp_step_bitexact_vs_golden_composition(backend):
    """One SGD step on the BFP wire (fused update; the sublane layout on
    the fused kernels' route, flat16 on the separate-op ring): the gather
    is the
    golden all-gather of the masters, and the masters after the step are
    ``golden_fused_apply`` of the golden reduce-scatter of JAX's cotangent
    at those gathered weights, bit for bit."""
    bcfg = config.BFPConfig(codec=backend)
    # the sublane layout rides the fused route (whole tiles a rank): the
    # card's configuration, its plain versions here
    coll = dict(impl="ring", compression=bcfg, fused_optimizer=True,
                fused_kernel=backend == "pallas")
    sgd = config.OptimizerConfig(kind="sgd", learning_rate=0.1)
    tr = FSDPTrainer(_linear_loss_port, VirtualRanks(N, CPU),
                     _cfg(config, coll, opt=sgd))
    st = tr.init_state(mlp.from_jax_params(_jax_params(), CPU))
    meta = tr._meta
    rt = jax_golden.roundtrip_fn(jax_get_codec(
        "bfp", {"codec": backend}))
    w0 = st.w_own.numpy().copy()
    gathered = jax_golden.ring_all_gather(w0, rt)
    np.testing.assert_array_equal(
        fused_update.all_gather_flat(st.w_own, tr.cfg.collective).numpy(),
        gathered)
    x, y = _data(2)
    coef = _jax_cotangent(gathered, x, y, meta)
    st, _ = tr.step(st, tr.shard_batch(tuple(torch.from_numpy(c)
                                             for c in coef)))
    ct = np.zeros((N, meta.padded_len), np.float32)
    ct[:, :sum(meta.sizes)] = np.concatenate(
        [c.reshape(N, -1) for c in coef], axis=1)
    g_sum = jax_golden.ring_reduce_scatter(ct, rt)
    hyper = np.asarray(jax_optim.fused_hyperparams(
        jax_optim.OptimizerConfig(kind="sgd", learning_rate=0.1)))
    want = np.stack([jax_optim.golden_fused_apply(
        "sgd", w0[i], g_sum[i], {}, hyper, N)[0] for i in range(N)])
    np.testing.assert_array_equal(st.w_own.numpy(), want)


def test_fsdp_bfp_quantized_forward_tracks_jax():
    """The BFP wire (flat16, unfused momentum): the first loss is the loss
    at the BFP-roundtripped parameters (JAX's quantized-forward contract)
    and four steps track JAX's FSDPTrainer within rtol 1e-5."""
    coll = dict(impl="ring", compression=config.BFPConfig())
    jcoll = dict(impl="ring", compression=jcfg.BFPConfig())
    params = _jax_params()
    x, y = _data()
    jt = JaxFSDPTrainer(_jax_loss(), _jax_mesh(), _cfg(jcfg, jcoll))
    js = jt.init_state(jax.tree_util.tree_map(jnp.asarray, params))
    tr = _port_fsdp(coll)
    st = tr.init_state(mlp.from_jax_params(params, CPU))
    q = tr.gathered_params(st)
    want0 = float(_port_loss()(q, (torch.from_numpy(x), torch.from_numpy(y))))
    lj, lp = [], []
    for _ in range(STEPS):
        js, a = jt.step(js, jt.shard_batch((jnp.asarray(x),
                                            jnp.asarray(y))))
        st, b = tr.step(st, _port_batch(tr, x, y))
        lj.append(float(a))
        lp.append(float(b))
    np.testing.assert_allclose(lp[0], want0, rtol=1e-6)
    np.testing.assert_allclose(lp, lj, rtol=1e-5)
    assert lp[-1] < lp[0]


LIN_SHAPES = {"a": [(8, 16), (16,)], "b": [(40,)]}


@pytest.mark.parametrize("fused", [False, True])
def test_fsdp_error_feedback_bitequal_to_jax(fused):
    """top-k with error feedback on exact gradients: after each of three
    SGD steps the residual equals JAX's ``FSDPState``'s, and the masters
    too on the fused update (the unfused one within an ulp)."""
    topk = (("bucket_elems", 256), ("k", 32))
    coll = dict(impl="ring", codec="topk", codec_opts=topk,
                fused_optimizer=fused)
    rng = np.random.default_rng(5)
    params = {k: [(rng.standard_normal(s) * 0.1).astype(np.float32)
                  for s in v] for k, v in LIN_SHAPES.items()}
    shapes = [s for k in sorted(LIN_SHAPES) for s in LIN_SHAPES[k]]
    jsgd = jcfg.OptimizerConfig(kind="sgd", learning_rate=0.1)
    psgd = config.OptimizerConfig(kind="sgd", learning_rate=0.1)
    jt = JaxFSDPTrainer(_linear_loss_jax, _jax_mesh(),
                        _cfg(jcfg, coll, opt=jsgd))
    js = jt.init_state(jax.tree_util.tree_map(jnp.asarray, params))
    tr = FSDPTrainer(_linear_loss_port, VirtualRanks(N, CPU),
                     _cfg(config, coll, opt=psgd))
    st = tr.init_state({k: [torch.from_numpy(a) for a in v]
                        for k, v in params.items()})
    for _ in range(3):
        coef = [(rng.standard_normal((N,) + s) * 2).astype(np.float32)
                for s in shapes]
        js, lj = jt.step(js, jt.shard_batch(tuple(jnp.asarray(c)
                                                  for c in coef)))
        st, lp = tr.step(st, tr.shard_batch(tuple(torch.from_numpy(c)
                                                  for c in coef)))
        if fused:
            np.testing.assert_array_equal(
                st.w_own.numpy(), np.asarray(js.w_own).reshape(N, -1))
        else:
            # XLA contracts the unfused w - lr * g into one FMA on the
            # CPU and the port rounds lr * g first: apart by at most half
            # an ulp of lr * g (|lr g| < 1 here: under 6e-8)
            np.testing.assert_allclose(
                st.w_own.numpy(), np.asarray(js.w_own).reshape(N, -1),
                rtol=0, atol=6e-8)
        np.testing.assert_array_equal(
            st.codec_state.numpy(), np.asarray(js.codec_state).reshape(N, -1))
        np.testing.assert_allclose(float(lp), float(lj), rtol=1e-6)
    assert bool(st.codec_state.any())


def test_gather_backward_is_the_reduce_scatter():
    """The step's gradient on the owned shards is ``reduce_scatter`` of
    the cotangent at the gathered rows (the gather's transpose), on the
    flat ring and the hier ring: a linear loss whose cotangent is its
    coefficients gives the masters of the update from that reduce-scatter,
    bit for bit."""
    rng = np.random.default_rng(3)
    shapes = [s for k in sorted(LIN_SHAPES) for s in LIN_SHAPES[k]]
    params = {k: [torch.from_numpy(
        (rng.standard_normal(s) * 0.1).astype(np.float32)) for s in v]
        for k, v in LIN_SHAPES.items()}
    sgd = config.OptimizerConfig(kind="sgd", learning_rate=0.1)
    for coll in (dict(impl="ring", codec="bfp"),
                 dict(impl="ring", topology="hier", intra_size=2,
                      codec="int8")):
        tr = FSDPTrainer(_linear_loss_port, VirtualRanks(N, CPU),
                         _cfg(config, coll, opt=sgd))
        st0 = tr.init_state(params)
        meta = tr._meta
        coef = [(rng.standard_normal((N,) + s) * 2).astype(np.float32)
                for s in shapes]
        st, _ = tr.step(st0, tr.shard_batch(tuple(torch.from_numpy(c)
                                                  for c in coef)))
        ct = torch.zeros((N, meta.padded_len))
        ct[:, :sum(meta.sizes)] = torch.from_numpy(np.concatenate(
            [c.reshape(N, -1) for c in coef], axis=1))
        w_want, _ = tr._update(st0, fused_update.reduce_scatter(
            ct, tr.cfg.collective))
        assert torch.equal(st.w_own, w_want)


def test_unported_and_invalid_configurations_raise():
    """What keeps raising names its ROADMAP item; JAX's ValueErrors stay;
    the other trainers refuse an fsdp axis."""
    tr = _port_fsdp(dict(impl="ring"))
    st = tr.init_state(mlp.from_jax_params(_jax_params(), CPU))
    for fn, args in ((tr.reshard_leaves, (st,)),
                     (tr.state_from_reshard, ({}, 0, None))):
        with pytest.raises(NotImplementedError, match="A.8"):
            fn(*args)
    # restore_state is ported (tests/test_torch_checkpoint.py)
    back = tr.restore_state({"w_own": st.w_own.reshape(-1).numpy(),
                             "opt_state": {}, "step": np.int32(0)})
    assert torch.equal(back.w_own, st.w_own)
    with pytest.raises(NotImplementedError, match="A.9"):
        _port_fsdp(dict(impl="ring"), obs_metrics=True)
    # accumulation is ported (tests/test_torch_accum.py)
    assert _port_fsdp(dict(impl="ring"), accum_steps=2).cfg.accum_steps == 2
    # codec="auto" resolves on FSDPTrainer (tests/test_torch_tune.py)
    auto = _port_fsdp(dict(impl="ring", codec="auto"))
    auto.init_state(mlp.from_jax_params(_jax_params(), CPU))
    assert auto.cfg.collective.codec != "auto"
    assert "tune" in auto.obs_static_metrics()
    with pytest.raises(ValueError, match="clip_norm"):
        _port_fsdp(dict(impl="ring", fused_optimizer=True),
                   opt=config.OptimizerConfig(clip_norm=1.0))
    with pytest.raises(ValueError, match="integrity_check"):
        _port_fsdp(dict(impl="ring", integrity_check=True))
    with pytest.raises(ValueError, match="does not describe"):
        FSDPTrainer(_port_loss(), VirtualRanks(4, CPU),
                    _cfg(config, dict(impl="ring")))
    ranks = make_ranks(config.MeshConfig(fsdp=N), "cpu")
    assert (ranks.n, ranks.sp, ranks.ep, ranks.pp) == (N, 1, 1, 1)
    with pytest.raises(NotImplementedError, match="fsdp axis alone"):
        make_ranks(config.MeshConfig(dp=2, fsdp=4), "cpu")
    for cls in (DPTrainer, DDPTrainer):
        with pytest.raises(NotImplementedError, match="FSDPTrainer"):
            cls(_port_loss(), ranks, _cfg(config, dict(impl="ring")))


def test_mlp_fsdp_curve_matches_jax():
    """``run_curve("mlp_fsdp")``, uncompressed and with BFP, from JAX's
    initial weights: the recorded losses of 4 AdamW steps within 1e-4 of
    JAX's (f32 GEMMs summed in other orders, carried through AdamW)."""
    params, _, _ = jax_cc._make_batches("mlp_fsdp", 1, 32, 0)
    port_params = mlp.from_jax_params(
        jax.tree_util.tree_map(np.asarray, params), "cpu")
    for kw in ({}, {"codec": "bfp"}):
        want = jax_cc.run_curve("mlp_fsdp", 4, record_every=1, **kw)
        got = cc.run_curve("mlp_fsdp", 4, record_every=1, params=port_params,
                           device="cpu", **kw)
        assert got["steps"] == want["steps"] == [1, 2, 3, 4]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)


def test_mlp_fsdp_codec_comparison_matches_jax():
    """``run_codec_comparison("mlp_fsdp", 6)`` (baseline, top-k with error
    feedback, int8) against JAX's: each recorded loss and each arm's ratio
    within 2%, the tolerance of the ZeRO-1 comparison
    (tests/test_torch_codec_convergence.py: top-k may select, and int8 draw,
    differently after last-bit gradient differences under AdamW)."""
    params, _, _ = jax_cc._make_batches("mlp_fsdp", 1, 32, 0)
    want = jax_cc.run_codec_comparison("mlp_fsdp", 6)
    got = cc.run_codec_comparison(
        "mlp_fsdp", 6, params=mlp.from_jax_params(
            jax.tree_util.tree_map(np.asarray, params), "cpu"),
        device="cpu")
    for arm in ("baseline", "topk", "int8"):
        assert got[arm]["steps"] == want[arm]["steps"]
        np.testing.assert_allclose(got[arm]["losses"], want[arm]["losses"],
                                   rtol=0.02)
    for arm in ("topk", "int8"):
        np.testing.assert_allclose(got[arm]["final_loss_ratio"],
                                   want[arm]["final_loss_ratio"], rtol=0.02)
        assert got[arm]["codec"] == want[arm]["codec"]
