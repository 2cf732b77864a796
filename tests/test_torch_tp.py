"""Tensor parallelism on the port against the JAX package, on the CPU.

The port's tp ranks are virtual ranks: a dp rank's loss takes its tp
ranks' trees at once (``llama.loss_fn(..., tp_axis="tp")``) and the
trainer keeps one flat row a (tp, dp) rank, JAX's ``P((tp, ep, dp))``.
JAX runs the same model on a CPU mesh with a ``"tp"`` axis.  The same
seeded inputs (JAX's ``init`` weights carried across with
``params_from_jax``) go through both, on the tiny f32 Llama (4 heads, 2
kv heads; tp = 4 replicates the kv heads) and a tiny MoE Llama (4
experts, top-2, capacity factor 16: nothing drops):

- (a) the layout: ``param_specs`` / ``stacked_param_specs`` dimension for
  dimension against JAX's, ``params_from_jax(specs=)`` shard for shard
  against JAX's ``NamedSharding`` and joined back bitwise, and JAX's
  errors for a tp that does not divide the heads;
- (b) the loss: ``_vocab_parallel_nll`` against JAX's under
  ``shard_map``, and ``loss_fn(tp_axis=)`` (ignored labels included)
  against JAX's under ``shard_map`` and its gradients, joined over the
  tp ranks, against the unsharded ``jax.grad``;
- (c) the trainer: two SGD steps at dp=2 x tp=2 against JAX's own
  ``ShardedTrainer`` (the green ``[2-2-1]`` case of
  ``tests/test_llama.py``), and at (dp, tp, sp) = (2, 2, 1), (1, 4, 1)
  with 4 kv heads, (2, 2, 2) and tp = 4 > n_kv = 2 against two unsharded
  JAX steps (rtol 5e-4, atol 5e-5, JAX's tolerance there); the MoE model
  at (dp, tp, ep) = (1, 4, 1) and (2, 2, 2);
- (d) the clip: ``norm_weight_tables`` equal to JAX's, clipped steps
  against JAX's unsharded clipped steps;
- (e) ``train_llama --mesh.tp`` on the CPU, and pp with tp taken by the
  ranks, the trainer, the pp losses and the driver (its parity:
  ``tests/test_torch_pp_tp.py``).
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from fpga_ai_nic_tpu import optim as jax_optim
from fpga_ai_nic_tpu.models import llama as jax_llama
from fpga_ai_nic_tpu.parallel import ShardedTrainer as JaxShardedTrainer
from fpga_ai_nic_tpu.utils import config as jcfg
from fpga_ai_nic_tpu_torch import train_llama
from fpga_ai_nic_tpu_torch.models import llama
from fpga_ai_nic_tpu_torch.ops import fused_update
from fpga_ai_nic_tpu_torch.parallel.mesh import (Spec, VirtualRanks,
                                                 make_ranks, spec_dims)
from fpga_ai_nic_tpu_torch.parallel.sharded import ShardedTrainer, join_ep
from fpga_ai_nic_tpu_torch.utils.config import (
    CollectiveConfig, MeshConfig, OptimizerConfig, TrainConfig)

JC = jax_llama.LlamaConfig.tiny()
JC_KV4 = jax_llama.LlamaConfig.tiny(n_kv_heads=4)
JC_MOE = dataclasses.replace(
    jax_llama.LlamaConfig.tiny(ffn_dim=64), moe_experts=4, moe_top_k=2,
    moe_capacity_factor=16.0)
B, S = 8, 16
TRAIN_TOL = dict(rtol=5e-4, atol=5e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def _pc(jc):
    return llama.LlamaConfig(**jc.__dict__)


def _batch(seed=0, vocab=256):
    toks = np.random.default_rng(seed).integers(
        0, vocab, (B, S + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def _params(jc, seed=0):
    return jax.tree_util.tree_map(
        np.asarray, jax_llama.init(jax.random.PRNGKey(seed), jc))


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _jdims(spec):
    """A JAX PartitionSpec as one axis (or None) a dimension, trailing
    Nones dropped (``mesh.spec_dims``'s form)."""
    dims = tuple(spec)
    while dims and dims[-1] is None:
        dims = dims[:-1]
    return dims


def _jleaves(tree):
    return jax.tree_util.tree_leaves(tree, is_leaf=lambda x: isinstance(
        x, P))


def _mesh(*axes):
    names = tuple(a for a, _ in axes)
    shape = tuple(k for _, k in axes)
    return Mesh(np.asarray(jax.devices()[:int(np.prod(shape))]).reshape(
        shape), names)


# -- (a) the layout -----------------------------------------------------------------

@pytest.mark.parametrize("jc,tp,ep_axis", [(JC, 2, None), (JC, 4, None),
                                           (JC_MOE, 2, "ep"),
                                           (JC_MOE, 4, None)])
def test_param_specs_match_jax(jc, tp, ep_axis):
    want = jax_llama.param_specs(jc, tp_axis="tp", ep_axis=ep_axis,
                                 tp_size=tp)
    got = llama.param_specs(_pc(jc), tp_axis="tp", ep_axis=ep_axis,
                            tp_size=tp)
    assert [_jdims(s) for s in _jleaves(want)] == [
        spec_dims(s) for s in fused_update.tree_leaves(got)]
    # a Spec is one leaf of the walk, as a PartitionSpec is of JAX's
    assert len(fused_update.tree_leaves(got)) == len(_jleaves(want))
    if tp == 4 and jc.moe is None:          # kv-head replication
        assert got["layers"][0]["wk"] is None
    swant = jax_llama.stacked_param_specs(jc, pp_axis="pp", tp_axis="tp",
                                          ep_axis=ep_axis, tp_size=tp)
    sgot = llama.stacked_param_specs(_pc(jc), ep_axis=ep_axis,
                                     tp_axis="tp", tp_size=tp)
    assert [_jdims(s) for s in _jleaves(swant)] == [
        spec_dims(s) for s in fused_update.tree_leaves(sgot)]


def test_spec_form():
    assert spec_dims(Spec(None, "tp")) == (None, "tp")
    assert spec_dims(Spec("tp", None)) == ("tp",)
    assert spec_dims("pp,ep") == ("pp", "ep") == spec_dims(Spec("pp", "ep"))
    assert spec_dims(None) == () == spec_dims(Spec())
    assert Spec("tp", None) == Spec("tp") and Spec(None, "tp") != Spec("tp")
    assert len(fused_update.tree_leaves({"a": Spec(None, "tp"),
                                         "b": [Spec("ep", None, "tp")]})) == 2


@pytest.mark.parametrize("jc,tp", [(JC, 2), (JC, 4), (JC_MOE, 2)])
def test_params_from_jax_shards_match_named_sharding(jc, tp):
    """Each shard of ``params_from_jax(specs=)`` is what JAX's
    ``NamedSharding`` of the unsharded tree puts on the tp device; joined
    again they give the unsharded tree back bitwise."""
    params = _params(jc, 1)
    mesh = _mesh(("tp", tp))
    jspecs = jax_llama.param_specs(jc, tp_axis="tp", ep_axis=None,
                                   tp_size=tp)
    specs = llama.param_specs(_pc(jc), "tp", None, tp)
    shards = llama.params_from_jax(params, "cpu", specs=specs,
                                   grid={"tp": tp})
    assert len(shards) == tp
    placed = [jax.device_put(a, NamedSharding(mesh, s)) for a, s in zip(
        jax.tree_util.tree_leaves(params), _jleaves(jspecs))]
    for t, shard in enumerate(shards):
        for leaf, arr in zip(fused_update.tree_leaves(shard), placed):
            dev_data = [s.data for s in arr.addressable_shards
                        if s.device == mesh.devices[t]][0]
            assert leaf.is_contiguous()
            np.testing.assert_array_equal(leaf.numpy(), np.asarray(dev_data))
    whole = llama.params_from_jax(params, "cpu")
    joined = join_ep(shards, specs, {"tp": tp})
    for a, b in zip(fused_update.tree_leaves(joined),
                    fused_update.tree_leaves(whole)):
        assert torch.equal(a, b)


def test_tp_head_counts_raise_as_jax():
    """JAX's errors: tp must divide the heads, and divide the kv heads or
    be a multiple of them (``test_kv_replication_rejects_non_multiple``'s
    case: tp=6, 6 heads, 4 kv heads)."""
    with pytest.raises(ValueError, match="must divide n_heads"):
        llama._shard_counts(llama.LlamaConfig.tiny(), 3)
    cfg = llama.LlamaConfig.tiny(n_heads=6, n_kv_heads=4)
    with pytest.raises(ValueError, match="multiple"):
        llama._shard_counts(cfg, 6)
    whole = llama.init(torch.Generator().manual_seed(0), cfg, "cpu")
    toks = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple"):
        llama.apply([whole] * 6, toks, cfg, tp_axis="tp")
    jparams = jax_llama.init(jax.random.PRNGKey(0), jax_llama.LlamaConfig.tiny(
        n_heads=6, n_kv_heads=4))
    with pytest.raises(ValueError, match="multiple"):
        jax.jit(jax.shard_map(
            lambda p, t: jax_llama.apply(p, t, jax_llama.LlamaConfig.tiny(
                n_heads=6, n_kv_heads=4), tp_axis="tp"),
            mesh=_mesh(("tp", 6)), in_specs=(P(), P()), out_specs=P(),
            check_vma=False))(jparams, jnp.zeros((2, 8), jnp.int32))
    with pytest.raises(ValueError, match="must divide n_heads"):
        train_llama.parse(["--model=tiny", "--device=cpu", "--mesh.tp=3"])
    # a tp loss takes the tp ranks' trees; wk/wv too narrow for
    # replication name tp_size
    tiny = llama.LlamaConfig.tiny()
    params = llama.init(torch.Generator().manual_seed(0), tiny, "cpu")
    batch = (toks, toks)
    with pytest.raises(ValueError, match="tp ranks' trees"):
        llama.loss_fn(params, batch, tiny, tp_axis="tp")
    narrow = llama.shard_params(params, llama.param_specs(tiny, "tp"),
                                {"tp": 4})
    with pytest.raises(ValueError, match="tp_size"):
        llama.loss_fn(narrow, batch, tiny, tp_axis="tp")


# -- (b) the loss -------------------------------------------------------------------

@pytest.mark.parametrize("tp", [2, 4])
def test_vocab_parallel_nll_matches_jax(tp):
    rng = np.random.default_rng(tp)
    V = 64
    logits = (rng.standard_normal((2, 5, V)) * 4).astype(np.float32)
    labels = rng.integers(0, V, (2, 5)).astype(np.int32)
    f = jax.jit(jax.shard_map(
        lambda lg, lb: jax_llama._vocab_parallel_nll(lg, lb, "tp"),
        mesh=_mesh(("tp", tp)), in_specs=(P(None, None, "tp"), P()),
        out_specs=P(), check_vma=False))
    want = np.asarray(f(jnp.asarray(logits), jnp.asarray(labels)))
    parts = list(torch.from_numpy(logits).chunk(tp, dim=-1))
    got = llama._vocab_parallel_nll(parts, torch.from_numpy(labels), "tp")
    np.testing.assert_allclose(_np(got), want, rtol=1e-6, atol=1e-6)
    full = jax.nn.log_softmax(jnp.asarray(logits), axis=-1)
    np.testing.assert_allclose(
        _np(got), -np.take_along_axis(np.asarray(full), labels[..., None],
                                      -1)[..., 0], rtol=1e-5, atol=1e-5)


def _split(jc, params, tp):
    return llama.params_from_jax(params, "cpu", specs=llama.param_specs(
        _pc(jc), "tp", None, tp), grid={"tp": tp})


def _join_grads(jc, grads, tp):
    """Per-rank gradient leaves joined as JAX's unsharded gradient: a
    split leaf's parts concatenated, a replicated one's summed (the
    trainer's sum over the tp rows)."""
    specs = fused_update.tree_leaves(llama.param_specs(_pc(jc), "tp", None,
                                                       tp))
    n = len(specs)
    out = []
    for i, spec in enumerate(specs):
        parts = [grads[t * n + i] for t in range(tp)]
        dims = spec_dims(spec)
        if dims:
            out.append(torch.cat(parts, dim=dims.index("tp")))
        else:
            out.append(sum(p for p in parts if p is not None))
    return out


@pytest.mark.parametrize("jc,tp", [(JC, 2), (JC, 4), (JC_KV4, 4),
                                   (JC_MOE, 2)])
def test_tp_loss_and_grads_match_jax(jc, tp):
    params = _params(jc, 2)
    toks, labels = _batch(2)
    labels = labels.copy()
    labels[0, :5] = -100                       # ignored labels
    labels[3, -2:] = -100
    jb = (jnp.asarray(toks), jnp.asarray(labels))
    f = jax.jit(jax.shard_map(
        lambda p, b: jax_llama.loss_fn(p, b, jc, tp_axis="tp")[None],
        mesh=_mesh(("tp", tp)),
        in_specs=(jax_llama.param_specs(jc, tp_axis="tp", tp_size=tp),
                  (P(), P())), out_specs=P("tp"), check_vma=False))
    want = np.asarray(f(jax.tree_util.tree_map(jnp.asarray, params), jb))
    assert np.all(want == want[0])
    loss_w, g_w = jax.value_and_grad(
        lambda p: jax_llama.loss_fn(p, jb, jc))(params)
    np.testing.assert_allclose(want[0], float(loss_w), rtol=1e-5)
    trees = _split(jc, params, tp)
    leaves = [[t.requires_grad_() for t in fused_update.tree_leaves(tree)]
              for tree in trees]
    loss = llama.loss_fn(trees, tuple(map(torch.from_numpy, (toks, labels))),
                         _pc(jc), tp_axis="tp")
    np.testing.assert_allclose(float(loss), want[0], rtol=1e-5)
    gs = torch.autograd.grad(loss, [t for ls in leaves for t in ls],
                             allow_unused=True)
    for got, w in zip(_join_grads(jc, gs, tp),
                      jax.tree_util.tree_leaves(g_w)):
        np.testing.assert_allclose(_np(got), np.asarray(w), **GRAD_TOL)
    # the logits gathered over tp are the unsharded ones
    logits = llama.apply(trees, torch.from_numpy(toks), _pc(jc),
                         tp_axis="tp")
    np.testing.assert_allclose(
        _np(logits), np.asarray(jax_llama.apply(params, jb[0], jc)),
        rtol=1e-5, atol=1e-5)


# -- (c) the trainer ----------------------------------------------------------------

def _ref_steps(jc, tree, batch, clip=None, n=2):
    """Two unsharded SGD steps (lr 0.1), JAX's ``clip_by_global_norm`` on
    the whole flat gradient when ``clip`` is set; also each step's
    pre-clip norm."""
    jb = tuple(map(jnp.asarray, batch))
    norms = []
    for _ in range(n):
        g = jax.grad(lambda p: jax_llama.loss_fn(p, jb, jc))(tree)
        flat, unravel = ravel_pytree(g)
        norms.append(float(jnp.linalg.norm(flat)))
        if clip is not None:
            g = unravel(jax_optim.clip_by_global_norm(
                jcfg.OptimizerConfig(clip_norm=clip), flat))
        tree = jax.tree_util.tree_map(
            lambda w, gg: (w.astype(jnp.float32)
                           - 0.1 * gg.astype(jnp.float32)).astype(w.dtype),
            tree, g)
    return tree, norms


def _trainer(jc, dp, tp, sp=1, ep=1, clip=None, coll=None):
    pc = _pc(jc)
    cfg = TrainConfig(global_batch=B, mesh=MeshConfig(dp=dp, tp=tp, sp=sp,
                                                      ep=ep),
                      collective=coll or CollectiveConfig(impl="xla"),
                      optimizer=OptimizerConfig(kind="sgd", learning_rate=0.1,
                                                clip_norm=clip))
    tp_axis = "tp" if tp > 1 else None
    if pc.moe is not None:
        loss = llama.dp_loss_fn(pc, dp, ep, n_sp=sp, tp_axis=tp_axis)
    else:
        sp_axis = "sp" if sp > 1 else None

        def loss(p, b):
            return llama.loss_fn(p, b, pc, tp_axis=tp_axis, sp_axis=sp_axis)
    return ShardedTrainer(loss, make_ranks(cfg.mesh, "cpu"), cfg,
                          param_specs=llama.param_specs(pc, tp_axis,
                                                        tp_size=tp))


def _train(tr, params, batch, steps=2):
    state = tr.init_state(llama.params_from_jax(params, "cpu"))
    sb = tr.shard_batch(tuple(map(torch.from_numpy, batch)))
    losses = []
    for _ in range(steps):
        state, loss = tr.step(state, sb)
        losses.append(float(loss))
    return state, losses


def _check_against(tr, state, want):
    got = fused_update.tree_leaves(tr.global_params(state))
    for g, w in zip(got, jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(_np(g), np.asarray(w, np.float32),
                                   **TRAIN_TOL)
    # every row of a shard group holds the same weights, and every tp
    # (and ep) row the same replicated leaves
    reps = state.replicas.reshape(tr.n_shards, tr.n, -1)
    assert (reps == reps[:, :1]).all()
    for a, b in tr._rep_spans:
        assert (reps[:, :, a:b] == reps[:1, :, a:b]).all()


def test_sharded_trainer_matches_jax_sharded_trainer():
    """dp=2 x tp=2, impl="xla": two steps against JAX's ShardedTrainer on
    a (dp, tp, sp) CPU mesh (its ``[2-2-1]`` case): losses at rtol 1e-5,
    the flat masters (JAX's ``P(("tp", "dp"))`` vector: the port's rows
    in order) within 1e-6 absolute."""
    params = _params(JC, 3)
    jtc = jcfg.TrainConfig(global_batch=B, mesh=jcfg.MeshConfig(dp=2, tp=2),
                           collective=jcfg.CollectiveConfig(impl="xla"),
                           optimizer=jcfg.OptimizerConfig(kind="sgd",
                                                          learning_rate=0.1))
    jtr = JaxShardedTrainer(
        lambda p, b: jax_llama.loss_fn(p, b, JC, tp_axis="tp"),
        _mesh(("dp", 2), ("tp", 2), ("sp", 1)), jtc,
        jax_llama.param_specs(JC))
    jst = jtr.init_state(jax.tree_util.tree_map(jnp.asarray, params))
    tr = _trainer(JC, 2, 2)
    st = tr.init_state(llama.params_from_jax(params, "cpu"))
    assert st.w_own.shape[0] == 4 and tr.n_shards == 2
    for step in range(2):
        batch = _batch(10 + step)
        jst, jl = jtr.step(jst, jtr.shard_batch(tuple(map(jnp.asarray,
                                                          batch))))
        st, loss = tr.step(st, tr.shard_batch(tuple(map(torch.from_numpy,
                                                        batch))))
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
        np.testing.assert_allclose(st.w_own.numpy().reshape(-1),
                                   np.asarray(jst.w_own), rtol=0, atol=1e-6)
    for g, w in zip(fused_update.tree_leaves(tr.global_params(st)),
                    jax.tree_util.tree_leaves(jst.params)):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=0, atol=1e-6)


@pytest.mark.parametrize("jc,dp,tp,sp", [(JC, 2, 2, 1), (JC_KV4, 1, 4, 1),
                                         (JC, 2, 2, 2), (JC, 2, 4, 1)])
def test_sharded_trainer_matches_unsharded(jc, dp, tp, sp):
    """JAX's ``test_sharded_training_matches_unsharded`` grid (its sp
    cases are red on this JAX: ROADMAP C.4) and tp = 4 > n_kv = 2 (JAX's
    ``test_kv_replicated_tp_matches_unsharded``): two steps against two
    unsharded JAX SGD steps."""
    params, batch = _params(jc, 0), _batch(0)
    want, _ = _ref_steps(jc, params, batch)
    tr = _trainer(jc, dp, tp, sp)
    state, losses = _train(tr, params, batch)
    assert np.isfinite(losses).all() and losses[1] < losses[0]
    assert state.w_own.shape[0] == tp * dp
    _check_against(tr, state, want)


@pytest.mark.parametrize("dp,tp,ep", [(1, 4, 1), (2, 2, 2), (2, 2, 1)])
def test_moe_tp_training_matches_unsharded(dp, tp, ep):
    """MoE experts split their hidden over tp (``Spec("ep", None, "tp")``),
    the router replicates: two steps against two unsharded JAX steps
    (JAX's ``test_moe_tp_training_matches_unsharded`` grid, and tp with
    dp alone)."""
    params, batch = _params(JC_MOE, 4), _batch(4)
    want, _ = _ref_steps(JC_MOE, params, batch)
    tr = _trainer(JC_MOE, dp, tp, ep=ep)
    state, losses = _train(tr, params, batch)
    assert np.isfinite(losses).all() and losses[1] < losses[0]
    assert state.w_own.shape[0] == tp * ep * dp
    _check_against(tr, state, want)


def test_loss_is_taken_once_a_dp_rank(monkeypatch):
    """One backward a dp rank, never one a tp rank: the loss runs dp
    times a step whatever the tp, and the gradient is not tp times too
    large (the trainer's gradient equals the unsharded one)."""
    calls = []
    loss_fn = llama.loss_fn

    def spy(*a, **kw):
        calls.append(kw.get("tp_axis"))
        return loss_fn(*a, **kw)

    monkeypatch.setattr(llama, "loss_fn", spy)
    params, batch = _params(JC, 5), _batch(5)
    tr = _trainer(JC, 2, 2)
    state = tr.init_state(llama.params_from_jax(params, "cpu"))
    flat_g, _ = tr.grads(state, tr.shard_batch(tuple(map(torch.from_numpy,
                                                         batch))))
    assert calls == ["tp", "tp"]
    g_w = jax.grad(lambda p: jax_llama.loss_fn(
        p, tuple(map(jnp.asarray, batch)), JC))(params)
    g = (flat_g[0::2] + flat_g[1::2]) / 2       # the dp mean of each tp row
    tree = join_ep([tr._grad_tree(row) for row in g], tr.param_specs,
                   {"tp": 2})
    for got, w in zip(fused_update.tree_leaves(tree),
                      jax.tree_util.tree_leaves(g_w)):
        np.testing.assert_allclose(_np(got), np.asarray(w), **GRAD_TOL)


# -- (d) the clip -------------------------------------------------------------------

@pytest.mark.parametrize("jc,tp,ep", [(JC, 2, 1), (JC, 4, 1),
                                      (JC_MOE, 2, 2)])
def test_norm_weight_tables_match_jax(jc, tp, ep):
    params = _params(jc, 0)
    jtr = JaxShardedTrainer(
        lambda p, b: jax_llama.loss_fn(p, b, jc, tp_axis="tp"),
        _mesh(("dp", 2), ("tp", tp), ("sp", 1), ("ep", ep)),
        jcfg.TrainConfig(global_batch=B, mesh=jcfg.MeshConfig(dp=2, tp=tp,
                                                             ep=ep),
                         collective=jcfg.CollectiveConfig(impl="xla"),
                         optimizer=jcfg.OptimizerConfig(clip_norm=1.0)),
        jax_llama.param_specs(jc, tp_axis="tp",
                              ep_axis="ep" if ep > 1 else None, tp_size=tp),
        ep_axis="ep" if ep > 1 else None)
    jtr._ensure_meta(params)
    want_b, want_v = jtr._norm_weight_tables()
    tr = _trainer(jc, 2, tp, ep=ep, clip=1.0)
    tr.init_state(llama.params_from_jax(params, "cpu"))
    got_b, got_v = tr.norm_weight_tables()
    assert got_b.dtype == want_b.dtype and got_v.dtype == want_v.dtype
    np.testing.assert_array_equal(got_b, want_b)
    np.testing.assert_array_equal(got_v, want_v)
    assert 1.0 / tp in got_v.tolist()


@pytest.mark.parametrize("binds", [True, False])
def test_clipped_tp_steps_match_unsharded(binds):
    params, batch = _params(JC, 6), _batch(6)
    _, norms = _ref_steps(JC, params, batch)
    clip = 0.5 * norms[0] if binds else 4.0 * max(norms)
    want, clipped_norms = _ref_steps(JC, params, batch, clip=clip)
    assert (clipped_norms[0] > clip) == binds
    tr = _trainer(JC, 2, 2, clip=clip)
    state, _ = _train(tr, params, batch)
    _check_against(tr, state, want)


# -- (e) the driver and the refusals ------------------------------------------------

@pytest.mark.parametrize("extra", [
    [], ["--model.moe_experts=4", "--mesh.ep=2"],
    ["--model.n_kv_heads=1", "--mesh.sp=2"]])
def test_train_llama_tp_on_cpu(extra):
    """``--mesh.tp=2`` on the CPU, on the ring with the BFP sublane codec
    as the card runs it: the first step's loss equals tp = 1's (the tp
    sums in another order: rtol 1e-5); the last one, after two updates,
    within 2e-3 (PERF.md's Llama parity limit), since the BFP blocks of
    a tp row hold other elements than tp = 1's."""
    base = ["--model=tiny", "--device=cpu", "--model.attn_block=16",
            "--seq=256", "--global_batch=4", "--mesh.dp=2", "--iters=2",
            "--collective.impl=ring",
            "--collective.compression.codec=pallas",
            "--collective.fused_kernel=true"] + extra
    one = train_llama.main(base)
    two = train_llama.main(base + ["--mesh.tp=2"])
    assert two["mesh"]["tp"] == 2 and one["mesh"]["tp"] == 1
    np.testing.assert_allclose(two["loss_first"], one["loss_first"],
                               rtol=1e-5)
    assert abs(two["loss_last"] - one["loss_last"]) <= 2e-3


def test_pp_with_tp_stays_refused():
    """pp with tp is ported (``tests/test_torch_pp_tp.py``): the ranks, the
    trainer, the pp losses with ``tp_axis`` and the driver take it; a pp
    loss given a rank's tp list without ``tp_axis`` refuses it."""
    ranks = make_ranks(MeshConfig(dp=2, tp=2, pp=2), "cpu")
    assert (ranks.n, ranks.tp, ranks.pp) == (2, 2, 2)
    cfg = TrainConfig(global_batch=4, mesh=MeshConfig(tp=2, pp=2))
    tiny = llama.LlamaConfig.tiny()
    tr = ShardedTrainer(lambda p, b: None, VirtualRanks(
        1, torch.device("cpu"), pp=2, tp=2), cfg,
        param_specs=llama.stacked_param_specs(tiny, tp_axis="tp"))
    assert tr.n_shards == 4
    toks = torch.zeros((2, 8), dtype=torch.int32)
    rows = llama.shard_params(llama.stack_params(llama.init(
        torch.Generator().manual_seed(0), tiny, "cpu")),
        llama.stacked_param_specs(tiny, tp_axis="tp"), {"tp": 2, "pp": 2})
    stages = [[rows[0], rows[2]], [rows[1], rows[3]]]
    loss = llama.loss_fn_pp(stages, (toks, toks), tiny, num_microbatches=1,
                            tp_axis="tp")
    assert torch.isfinite(loss)
    with pytest.raises(ValueError, match="tp_axis"):
        llama.loss_fn_pp(stages, (toks, toks), tiny, num_microbatches=1)
    out = train_llama.main(["--model=tiny", "--device=cpu", "--mesh.tp=2",
                            "--mesh.pp=2", "--global_batch=2", "--seq=16",
                            "--iters=1"])
    assert (out["mesh"]["tp"], out["mesh"]["pp"]) == (2, 2)


def test_tp_trainer_needs_specs_and_matching_ranks():
    cfg = TrainConfig(global_batch=4, mesh=MeshConfig(dp=2, tp=2))
    with pytest.raises(ValueError, match="param_specs"):
        ShardedTrainer(lambda p, b: None, make_ranks(cfg.mesh, "cpu"), cfg)
    with pytest.raises(ValueError, match="does not describe"):
        ShardedTrainer(lambda p, b: None, VirtualRanks(2, torch.device(
            "cpu")), cfg, param_specs=llama.param_specs(
            llama.LlamaConfig.tiny(), "tp"))
    ranks = make_ranks(cfg.mesh, "cpu")
    assert (ranks.n, ranks.tp) == (2, 2)
    # the tp ranks see their dp rank's batch: tp never splits it
    x = torch.arange(8 * 4).reshape(8, 4)
    assert torch.equal(ranks.shard(x), VirtualRanks(2, torch.device(
        "cpu")).shard(x))
