"""The port's data-parallel MLP training against the JAX package.

The slice's configuration: ring collectives with BFP on every hop in the
sublane layout (``BFPConfig(codec="pallas")``), ``fused_kernel=True`` and
``fused_optimizer=True``, SGD at lr 0.1.  The JAX ``DPTrainer`` cannot run
that configuration on the CPU (the Pallas codec in interpret mode does not
pass the varying-axes check of the gradient ``shard_map``), so the oracle
is the composition the JAX package defines for it: ``jax.grad`` of
``mlp.loss_fn`` on each rank's shard, then ``ring_golden.ring_reduce_scatter
(layout="sublane")``, ``optim.golden_fused_apply``, and the all-gather
(each owned chunk quantized once by ``bfp_golden`` in the sublane layout
and forwarded verbatim).
"""

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import jax
import jax.numpy as jnp

from fpga_ai_nic_tpu import optim as jax_optim
from fpga_ai_nic_tpu.models import mlp as jax_mlp
from fpga_ai_nic_tpu.ops import bfp_golden as jax_bfp_golden
from fpga_ai_nic_tpu.ops import ring_golden as jax_ring_golden
from fpga_ai_nic_tpu.utils.config import BFPConfig as JaxBFPConfig
from fpga_ai_nic_tpu.utils.config import MLPConfig as JaxMLPConfig
from fpga_ai_nic_tpu_torch import train_mlp
from fpga_ai_nic_tpu_torch.models import mlp
from fpga_ai_nic_tpu_torch.parallel.mesh import VirtualRanks, make_ranks
from fpga_ai_nic_tpu_torch.parallel.train import DPTrainer
from fpga_ai_nic_tpu_torch.utils.config import (
    AdaptConfig, BFPConfig, CollectiveConfig, MeshConfig, MLPConfig,
    OptimizerConfig, TrainConfig)

N, BATCH, STEPS, LR = 4, 64, 3, 0.1
SIZES = (256,) * 4


def _cfg() -> TrainConfig:
    return TrainConfig(
        global_batch=BATCH, mesh=MeshConfig(dp=N),
        collective=CollectiveConfig(
            impl="ring", compression=BFPConfig(codec="pallas"),
            fused_kernel=True, fused_optimizer=True),
        optimizer=OptimizerConfig(kind="sgd", learning_rate=LR))


def _data(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((BATCH, SIZES[0])).astype(np.float32)
    y = rng.integers(0, SIZES[-1], BATCH).astype(np.int32)
    return x, y


def _jax_params():
    p = jax_mlp.init(jax.random.PRNGKey(0), JaxMLPConfig(layer_sizes=SIZES))
    return jax.tree_util.tree_map(np.asarray, p)


def _trainer():
    mcfg = MLPConfig(layer_sizes=SIZES)
    return DPTrainer(lambda p, b: mlp.loss_fn(p, b, mcfg),
                     VirtualRanks(N, torch.device("cpu")), _cfg())


def _jax_flat_grads(params, x, y):
    """Per-rank JAX gradients, flattened in tree order and padded as the
    port pads: ([N, L_pad], mean loss, treedef, shapes, L)."""
    mcfg = JaxMLPConfig(layer_sizes=SIZES)
    vg = jax.jit(jax.value_and_grad(lambda p, b: jax_mlp.loss_fn(p, b,
                                                                 mcfg)))
    rows, losses = [], []
    for i in range(N):
        sl = slice(i * BATCH // N, (i + 1) * BATCH // N)
        loss, g = vg(params, (jnp.asarray(x[sl]), jnp.asarray(y[sl])))
        rows.append(np.concatenate([np.asarray(v).reshape(-1)
                                    for v in jax.tree_util.tree_leaves(g)]))
        losses.append(np.float32(loss))
    L = rows[0].shape[0]
    pad = (-L) % (N * 16 * 128)
    flat = np.stack([np.pad(r, (0, pad)) for r in rows])
    return flat, np.mean(losses, dtype=np.float32), L


def _golden_collective(flat_g, w_own):
    """Golden sublane reduce-scatter -> SGD twin -> quantize-once gather."""
    cfg = JaxBFPConfig()
    g_sum = jax_ring_golden.ring_reduce_scatter(flat_g, cfg, "sublane")
    hyper = np.asarray(jax_optim.fused_hyperparams(
        jax_optim.OptimizerConfig(kind="sgd", learning_rate=LR)))
    w_new = np.stack([jax_optim.golden_fused_apply("sgd", w_own[i],
                                                   g_sum[i], {}, hyper, N)[0]
                      for i in range(N)])
    q = np.concatenate([jax_bfp_golden.bfp_decode(
        *jax_bfp_golden.bfp_encode(w, layout="sublane"), layout="sublane")
        for w in w_new])
    return w_new, q


def _unflatten(flat, like):
    leaves, treedef = jax.tree_util.tree_flatten(like)
    out, off = [], 0
    for leaf in leaves:
        out.append(flat[off:off + leaf.size].reshape(leaf.shape))
        off += leaf.size
    return jax.tree_util.tree_unflatten(treedef, out)


def test_three_steps_match_jax_composition():
    """Losses agree at rtol 1e-5 and the f32 masters within the stated
    atol.  Torch and XLA sum the GEMMs in different orders, so gradients
    differ in the last bits, and where a value sits on a BFP rounding
    boundary one grid step can flip: at most 2^-6 of the block max of the
    reduced gradient sum, i.e. lr * 2^-6 * max|g_sum| / n of master per
    step after the 1/n mean (n * max|g| bounds max|g_sum|)."""
    x, y = _data()
    params = _jax_params()
    tr = _trainer()
    state = tr.init_state(mlp.from_jax_params(params, device="cpu"))
    batch = tr.shard_batch((torch.from_numpy(x), torch.from_numpy(y)))
    L_pad = N * state.w_own.shape[1]
    w_ref = np.pad(np.concatenate(
        [np.asarray(v).reshape(-1) for v in jax.tree_util.tree_leaves(
            params)]), (0, L_pad - sum(np.size(v) for v in
                                       jax.tree_util.tree_leaves(params))))
    w_ref = w_ref.reshape(N, -1)
    p_ref = params
    atol = 0.0
    for _ in range(STEPS):
        flat_g, loss_ref, L = _jax_flat_grads(p_ref, x, y)
        state, loss = tr.step(state, batch)
        np.testing.assert_allclose(float(loss), float(loss_ref), rtol=1e-5)
        w_ref, q = _golden_collective(flat_g, w_ref)
        atol += LR * 2.0 ** -6 * float(np.abs(flat_g).max())
        np.testing.assert_allclose(state.w_own.numpy(), w_ref, rtol=0,
                                   atol=atol)
        p_ref = _unflatten(q[:L], p_ref)
    assert state.step == STEPS
    reps = state.replicas.numpy()
    assert (reps == reps[0]).all()


def test_collective_bitexact_given_jax_grads():
    """The same JAX gradients through the port's phases 1 and 2 give the
    golden masters and replicas, bit for bit."""
    x, y = _data(1)
    params = _jax_params()
    tr = _trainer()
    state = tr.init_state(mlp.from_jax_params(params, device="cpu"))
    flat_g, _, L = _jax_flat_grads(params, x, y)
    w_want, q_want = _golden_collective(flat_g, state.w_own.numpy())
    new = tr.apply_grads(state, torch.from_numpy(flat_g))
    np.testing.assert_array_equal(new.w_own.numpy(), w_want)
    for i in range(N):
        np.testing.assert_array_equal(new.replicas[i].numpy(), q_want)
    got = jax.tree_util.tree_leaves(new.params)
    want = jax.tree_util.tree_leaves(_unflatten(q_want[:L], params))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b)
    back = tr.params_from_master(new.w_own)
    for a, b in zip(jax.tree_util.tree_leaves(back), got):
        assert torch.equal(a, b)


def test_port_grads_close_to_jax():
    x, y = _data(2)
    params = _jax_params()
    tr = _trainer()
    state = tr.init_state(mlp.from_jax_params(params, device="cpu"))
    g, loss = tr.grads(state, tr.shard_batch((torch.from_numpy(x),
                                              torch.from_numpy(y))))
    g_ref, loss_ref, _ = _jax_flat_grads(params, x, y)
    np.testing.assert_allclose(g.numpy(), g_ref, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(float(loss), float(loss_ref), rtol=1e-6)


def test_mlp_module_and_flops_match_jax():
    params = _jax_params()
    x, _ = _data(3)
    m = mlp.MLP(MLPConfig(layer_sizes=SIZES),
                mlp.from_jax_params(params, device="cpu"))
    want = jax_mlp.apply(params, jnp.asarray(x),
                         JaxMLPConfig(layer_sizes=SIZES))
    np.testing.assert_allclose(m(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)
    assert mlp.flops_per_sample(MLPConfig()) == \
        jax_mlp.flops_per_sample(JaxMLPConfig())


def test_driver_flags_and_cpu_run():
    argv = ["--model.layer_sizes=256,256,256", "--global_batch=64",
            "--iters=2", "--device=cpu", "--bfp=1", "--mesh.dp=4",
            "--collective.compression.codec=pallas",
            "--collective.fused_kernel=true",
            "--collective.fused_optimizer=true"]
    mcfg, cfg, device = train_mlp.parse(argv)
    assert cfg.collective.compression == BFPConfig(codec="pallas")
    assert cfg.collective.fused_kernel and mcfg.layer_sizes == (256,) * 3
    out = train_mlp.main(argv)
    assert set(out) >= {"loss", "samples_per_sec", "gflops", "wall_s"}
    assert np.isfinite(out["loss"]) and out["device"] == "cpu"


def test_entry_points_raise_without_cuda(monkeypatch):
    """Entry points default to the card and refuse to carry on without
    it; device="cpu" is the explicit opt-in."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        make_ranks(MeshConfig(dp=2))
    with pytest.raises(RuntimeError, match="cuda"):
        mlp.init(torch.Generator().manual_seed(0), MLPConfig(
            layer_sizes=(8, 8)))
    with pytest.raises(RuntimeError, match="cuda"):
        train_mlp.main(["--model.layer_sizes=8,8", "--global_batch=2",
                        "--iters=1"])
    assert make_ranks(MeshConfig(dp=2), "cpu").device.type == "cpu"


def test_unported_options_raise():
    # the auto codecs resolve per payload (tests/test_torch_codec_auto.py)
    assert BFPConfig(codec="auto").codec == "auto"
    assert CollectiveConfig(impl="ring", codec="int8", codec_opts=(
        ("backend", "auto"),)).codec_opts == (("backend", "auto"),)
    # pp with tp is ported (tests/test_torch_pp_tp.py)
    assert make_ranks(MeshConfig(dp=2, tp=2, pp=2), "cpu").tp == 2
    # codec="auto" resolves, and adapt.enabled arms its live calibration
    # (tests/test_torch_tune.py, tests/test_torch_adapt.py)
    auto = DPTrainer(lambda p, b: None, VirtualRanks(2, torch.device("cpu")),
                     TrainConfig(mesh=MeshConfig(dp=2),
                                 collective=CollectiveConfig(
                                     impl="ring", codec="auto"),
                                 adapt=AdaptConfig(enabled=True)))
    auto.init_state({"w": torch.zeros(4096)})
    plan = auto.obs_static_metrics()["tune"]
    assert plan["calibration"]["inter_live"] and plan["dryrun"]
    ranks = VirtualRanks(2, torch.device("cpu"))
    # obs_metrics is ported (tests/test_torch_obs.py)
    assert DPTrainer(lambda p, b: None, ranks, TrainConfig(
        mesh=MeshConfig(dp=2), obs_metrics=True)).cfg.obs_metrics
    # accumulation is ported (tests/test_torch_accum.py)
    assert DPTrainer(lambda p, b: None, ranks, TrainConfig(
        mesh=MeshConfig(dp=2), accum_steps=2)).cfg.accum_steps == 2


@pytest.mark.parametrize("impl", ["xla", "ring"])
def test_unfused_routes_train(impl):
    """The default collective (impl="xla") and the unfused ring also
    train: loss falls over a few steps on a fixed batch."""
    mcfg = MLPConfig(layer_sizes=(32, 32, 8))
    cfg = TrainConfig(global_batch=16, mesh=MeshConfig(dp=2),
                      collective=CollectiveConfig(impl=impl),
                      optimizer=OptimizerConfig(kind="momentum",
                                                learning_rate=0.05))
    tr = DPTrainer(lambda p, b: mlp.loss_fn(p, b, mcfg),
                   VirtualRanks(2, torch.device("cpu")), cfg)
    state = tr.init_state(mlp.init(torch.Generator().manual_seed(0), mcfg,
                                   "cpu"))
    rng = np.random.default_rng(0)
    batch = tr.shard_batch((
        torch.from_numpy(rng.standard_normal((16, 32)).astype(np.float32)),
        torch.from_numpy(rng.integers(0, 8, 16))))
    losses = []
    for _ in range(5):
        state, loss = tr.step(state, batch)
        losses.append(float(loss))
    assert losses[-1] < losses[0]
