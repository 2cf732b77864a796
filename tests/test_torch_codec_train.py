"""The port's data-parallel trainer with the int8 and top-k codecs against
the JAX package.

Three holds, from loosest to tightest:

* the port's ``DPTrainer`` on a tiny MLP against JAX's ``DPTrainer`` on the
  CPU mesh, from the same initial weights, for three steps (losses and
  masters within a stated tolerance);
* both trainers on a loss whose gradients are exact (a linear loss, so
  both frameworks see the same gradient bits): masters, gathered params
  and the error-feedback residual ``codec_state`` bit-equal to JAX's
  ``TrainState`` after every step;
* ``error_feedback`` + ``apply_grads`` on the same flat gradients against
  the composition of the JAX package's goldens (error feedback, ring
  reduce-scatter, ``optim.golden_fused_apply``, quantize-once gather), bit
  for bit — the only hold for ``backend="pallas"``, which JAX's
  ``DPTrainer`` cannot run on the CPU (the Pallas codec in interpret mode
  fails the varying-axes check of its gradient ``shard_map``).
"""

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import jax
import jax.numpy as jnp

from fpga_ai_nic_tpu import compress as jax_compress
from fpga_ai_nic_tpu import optim as jax_optim
from fpga_ai_nic_tpu.compress import golden as jax_golden
from fpga_ai_nic_tpu.models import mlp as jax_mlp
from fpga_ai_nic_tpu.parallel import make_mesh
from fpga_ai_nic_tpu.parallel.train import DPTrainer as JaxDPTrainer
from fpga_ai_nic_tpu.utils import config as jax_config
from fpga_ai_nic_tpu_torch.models import mlp
from fpga_ai_nic_tpu_torch.ops import fused_update
from fpga_ai_nic_tpu_torch.parallel.mesh import VirtualRanks
from fpga_ai_nic_tpu_torch.parallel.train import DPTrainer
from fpga_ai_nic_tpu_torch.utils import config

SIZES = (64, 128, 128, 16)
TILED_SIZES = (18, 160, 32)     # 8192 parameters: whole tiles at dp=2, 4
BATCH, STEPS, LR = 32, 3, 0.1
TOPK = (("bucket_elems", 256), ("k", 32))
INT8_STEP = (1.0 + 2.0 ** -8) / 127.0     # int8 grid step / block max


def _cfg(mod, n, codec, opts, batch=BATCH):
    return mod.TrainConfig(
        global_batch=batch, mesh=mod.MeshConfig(dp=n),
        collective=mod.CollectiveConfig(impl="ring", codec=codec,
                                        codec_opts=opts,
                                        fused_optimizer=True),
        optimizer=mod.OptimizerConfig(kind="sgd", learning_rate=LR))


def _data(sizes, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((BATCH, sizes[0])).astype(np.float32)
    y = rng.integers(0, sizes[-1], BATCH).astype(np.int32)
    return x, y


def _jax_params(sizes):
    p = jax_mlp.init(jax.random.PRNGKey(0),
                     jax_config.MLPConfig(layer_sizes=sizes))
    return jax.tree_util.tree_map(np.asarray, p)


def _port_trainer(n, codec, opts, sizes=SIZES):
    mcfg = config.MLPConfig(layer_sizes=sizes)
    return DPTrainer(lambda p, b: mlp.loss_fn(p, b, mcfg),
                     VirtualRanks(n, torch.device("cpu")),
                     _cfg(config, n, codec, opts))


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("codec,opts", [("int8", ()), ("topk", TOPK)])
def test_dp_trainer_tracks_jax(n, codec, opts):
    """Three steps from the same weights and batch.  Torch and XLA sum the
    GEMMs in other orders, so gradients differ in their last bits.  int8's
    stochastic rounding hashes each value's bits, so such a value draws
    another u and one grid step of its block may flip, on any hop and in
    the gathered replicas: the masters are held within one int8 grid step
    of the largest master per step (STEPS x INT8_STEP x max|w|) and the
    loss within 1%.  Top-k selects by magnitude, which last-bit
    differences do not reorder here: masters within 1e-6, loss at rtol
    1e-5."""
    jm = jax_config.MLPConfig(layer_sizes=SIZES)
    params = _jax_params(SIZES)
    x, y = _data(SIZES)
    jt = JaxDPTrainer(lambda p, b: jax_mlp.loss_fn(p, b, jm),
                      make_mesh(jax_config.MeshConfig(dp=n)),
                      _cfg(jax_config, n, codec, opts))
    js = jt.init_state(jax.tree_util.tree_map(jnp.asarray, params))
    jb = jt.shard_batch((jnp.asarray(x), jnp.asarray(y)))
    tr = _port_trainer(n, codec, opts)
    st = tr.init_state(mlp.from_jax_params(params, device="cpu"))
    b = tr.shard_batch((torch.from_numpy(x), torch.from_numpy(y)))
    if codec == "int8":
        rtol = 1e-2
        atol = STEPS * INT8_STEP * float(st.w_own.abs().max())
    else:
        rtol, atol = 1e-5, 1e-6
    for _ in range(STEPS):
        js, jloss = jt.step(js, jb)
        st, loss = tr.step(st, b)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=rtol)
        np.testing.assert_allclose(
            st.w_own.numpy(), np.asarray(js.w_own).reshape(n, -1),
            rtol=0, atol=atol)
    if codec == "topk":
        np.testing.assert_allclose(
            st.codec_state.numpy(),
            np.asarray(js.codec_state).reshape(n, -1), rtol=0, atol=atol)
    reps = st.replicas.numpy()
    assert (reps == reps[0]).all()


LIN_SHAPES = {"b": [(256,), (64,)], "w": [(64, 256), (256, 64)]}


def _linear_loss_jax(p, b):
    return sum(jnp.sum(leaf * c[0])
               for leaf, c in zip(jax.tree_util.tree_leaves(p), b))


def _linear_loss_port(p, b):
    return sum((leaf * c[0]).sum()
               for leaf, c in zip(fused_update.tree_leaves(p), b))


@pytest.mark.parametrize("n,codec,opts", [
    (2, "topk", TOPK), (4, "int8", (("error_feedback", True),)),
    (2, "int8", ())])
def test_states_bitequal_to_jax_on_exact_gradients(n, codec, opts):
    """loss = sum(params * c) with per-rank coefficients c: the gradient is
    c in both frameworks, bit for bit.  After each of three steps the
    masters, the gathered params and ``codec_state`` equal JAX's
    ``TrainState`` exactly (the residual: each rank's gradient plus old
    residual minus what its local roundtrip kept)."""
    rng = np.random.default_rng(n)
    params = {k: [(rng.standard_normal(s) * 0.1).astype(np.float32)
                  for s in v] for k, v in LIN_SHAPES.items()}
    shapes = [s for k in sorted(LIN_SHAPES) for s in LIN_SHAPES[k]]
    jt = JaxDPTrainer(_linear_loss_jax,
                      make_mesh(jax_config.MeshConfig(dp=n)),
                      _cfg(jax_config, n, codec, opts, batch=n))
    js = jt.init_state(jax.tree_util.tree_map(jnp.asarray, params))
    tr = DPTrainer(_linear_loss_port, VirtualRanks(n, torch.device("cpu")),
                   _cfg(config, n, codec, opts, batch=n))
    st = tr.init_state({k: [torch.from_numpy(a) for a in v]
                        for k, v in params.items()})
    assert (st.codec_state is None) == (js.codec_state is None)
    for _ in range(STEPS):
        coef = [(rng.standard_normal((n,) + s) * 2).astype(np.float32)
                for s in shapes]
        js, _ = jt.step(js, jt.shard_batch(tuple(jnp.asarray(c)
                                                 for c in coef)))
        st, _ = tr.step(st, tr.shard_batch(tuple(torch.from_numpy(c)
                                                 for c in coef)))
        np.testing.assert_array_equal(st.w_own.numpy(),
                                      np.asarray(js.w_own).reshape(n, -1))
        for a, b in zip(fused_update.tree_leaves(st.params),
                        jax.tree_util.tree_leaves(js.params)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        if js.codec_state is not None:
            np.testing.assert_array_equal(
                st.codec_state.numpy(),
                np.asarray(js.codec_state).reshape(n, -1))
            assert bool(st.codec_state.any())


def _jax_flat_grads(params, x, y, sizes, n, L_pad):
    """Per-rank JAX gradients in tree order, zero-padded to L_pad."""
    mcfg = jax_config.MLPConfig(layer_sizes=sizes)
    vg = jax.jit(jax.grad(lambda p, b: jax_mlp.loss_fn(p, b, mcfg)))
    rows = []
    for i in range(n):
        sl = slice(i * BATCH // n, (i + 1) * BATCH // n)
        g = vg(params, (jnp.asarray(x[sl]), jnp.asarray(y[sl])))
        row = np.concatenate([np.asarray(v).reshape(-1)
                              for v in jax.tree_util.tree_leaves(g)])
        rows.append(np.pad(row, (0, L_pad - row.shape[0])))
    return np.stack(rows).astype(np.float32)


@pytest.mark.parametrize("n,codec,opts,jax_opts", [
    (2, "int8", (), {}),
    (2, "int8", (("backend", "pallas"),), {"backend": "pallas"}),
    (4, "int8", (("backend", "pallas"),), {"backend": "pallas"}),
    (4, "int8", (("backend", "pallas"), ("error_feedback", True),
                 ("rounding", "nearest")),
     {"backend": "pallas", "error_feedback": True, "rounding": "nearest"}),
    (2, "topk", TOPK, dict(TOPK))])
def test_apply_grads_bitexact_vs_golden_composition(n, codec, opts,
                                                    jax_opts):
    """The same JAX gradients through the port's ``error_feedback`` and
    ``apply_grads`` == the JAX package's goldens composed: error feedback
    with the golden roundtrip, ``golden.ring_reduce_scatter``,
    ``optim.golden_fused_apply`` (SGD) and the quantize-once gather.  Two
    steps, so the second starts from a nonzero residual."""
    params = _jax_params(TILED_SIZES)
    tr = _port_trainer(n, codec, opts, TILED_SIZES)
    state = tr.init_state(mlp.from_jax_params(params, device="cpu"))
    L_pad = n * state.w_own.shape[1]
    rt = jax_golden.roundtrip_fn(
        jax_compress.get_codec(codec, jax_opts))
    ef = tr._ef
    w_ref = state.w_own.numpy().copy()
    resid = np.zeros((n, L_pad), np.float32)
    hyper = np.asarray(jax_optim.fused_hyperparams(
        jax_optim.OptimizerConfig(kind="sgd", learning_rate=LR)))
    for step in range(2):
        x, y = _data(TILED_SIZES, seed=step)
        flat_g = _jax_flat_grads(params, x, y, TILED_SIZES, n, L_pad)
        g_wire, codec_state = tr.error_feedback(state,
                                                torch.from_numpy(flat_g))
        state = tr.apply_grads(state, g_wire, codec_state)
        if ef:
            comp = flat_g + resid
            wire = np.stack([rt(r) for r in comp])
            resid = comp - wire
        else:
            wire = flat_g
        g_sum = jax_golden.ring_reduce_scatter(wire, rt)
        w_ref = np.stack([jax_optim.golden_fused_apply(
            "sgd", w_ref[i], g_sum[i], {}, hyper, n)[0] for i in range(n)])
        reps = jax_golden.ring_all_gather(w_ref, rt)
        np.testing.assert_array_equal(state.w_own.numpy(), w_ref)
        np.testing.assert_array_equal(state.replicas.numpy(), reps)
        if ef:
            np.testing.assert_array_equal(state.codec_state.numpy(), resid)
        else:
            assert state.codec_state is None
        params = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(params),
            [a.numpy() for a in fused_update.tree_leaves(state.params)])
