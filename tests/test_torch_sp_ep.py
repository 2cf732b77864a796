"""Sequence parallelism together with expert parallelism, and the global
norm clip with ep, on the port against the JAX package, on the CPU.

The port stacks a dp rank's ep ranks and each of those its sp shards
(batch ``[n_dp, n_ep, n_sp, B, S_local]``); JAX runs them as devices of
an 8-device CPU mesh ``("dp", "sp", "ep")``.  The same seeded numpy
inputs (JAX's ``init`` weights carried across with ``params_from_jax``)
go through both, on a tiny MoE Llama (2 layers, 4 experts, top-2,
capacity factor 16, at which nothing drops):

- (a) ``VirtualRanks.shard`` against JAX's ``P(("dp", "ep"), "sp")``
  placement at (dp, sp, ep) = (2, 2, 2), (1, 2, 4), (1, 4, 2);
- (b) ``llama.dp_loss_fn(..., n_sp=2)`` at (2, 2, 2) against JAX's
  ``loss_fn(sp_axis, dp_axis, ep_axis)`` under ``shard_map`` and against
  the unsharded loss (rtol 1e-5; every rank's value is the global one);
  the ep loss with sp (``loss_fn(ep_axis=, sp_axis=)``) too;
- (c) ``ShardedTrainer`` over dp x sp x ep: two SGD steps against two
  unsharded JAX steps on the whole sequence (rtol 5e-4, atol 5e-5, the
  red JAX ep trainer test's limit; JAX's own sp and ep trainers fail
  their varying-axes check on this JAX: ROADMAP C.4), with and without
  remat;
- (d) clip with ep: ``norm_weight_tables`` equal to JAX's
  ``ShardedTrainer._norm_weight_tables()`` (dp = 2, ep = 2) bound for
  bound and value for value, the pre-clip norm equal to the unsharded
  gradient's L2 norm (rtol 1e-5, through the tables and through JAX's
  per-element weights), two clipped steps against JAX's unsharded steps
  with ``optim.clip_by_global_norm`` on the whole gradient, binding and
  not;
- (e) ``train_llama`` with sp, ep, remat and a clip on the CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree
from jax.sharding import Mesh, PartitionSpec as P

from fpga_ai_nic_tpu import optim as jax_optim
from fpga_ai_nic_tpu.models import llama as jax_llama
from fpga_ai_nic_tpu.parallel import ShardedTrainer as JaxShardedTrainer
from fpga_ai_nic_tpu.parallel import mesh as jax_mesh
from fpga_ai_nic_tpu.utils import config as jcfg
from fpga_ai_nic_tpu_torch import optim, train_llama
from fpga_ai_nic_tpu_torch.models import llama
from fpga_ai_nic_tpu_torch.ops import fused_update
from fpga_ai_nic_tpu_torch.parallel.mesh import VirtualRanks, make_ranks
from fpga_ai_nic_tpu_torch.parallel.sharded import ShardedTrainer, split_ep
from fpga_ai_nic_tpu_torch.utils.config import (
    CollectiveConfig, MeshConfig, OptimizerConfig, TrainConfig)

JC = dataclasses.replace(
    jax_llama.LlamaConfig.tiny(n_layers=2, ffn_dim=64), moe_experts=4,
    moe_top_k=2, moe_capacity_factor=16.0)
PC = llama.LlamaConfig(**JC.__dict__)
B, S = 8, 16
TRAIN_TOL = dict(rtol=5e-4, atol=5e-5)


def _batch(seed=0):
    toks = np.random.default_rng(seed).integers(
        0, JC.vocab, (B, S + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def _params(seed):
    return jax.tree_util.tree_map(
        np.asarray, jax_llama.init(jax.random.PRNGKey(seed), JC))


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _flat(tree):
    return np.concatenate([np.asarray(v, np.float32).reshape(-1)
                           for v in jax.tree_util.tree_leaves(tree)])


# -- (a) the batch layout -------------------------------------------------------------

@pytest.mark.parametrize("dp,sp,ep", [(2, 2, 2), (1, 2, 4), (1, 4, 2)])
def test_batch_layout_matches_jax_p_dp_ep_sp(dp, sp, ep):
    """Device (d, e, s) of ``VirtualRanks.shard`` holds JAX device (d,
    s, e)'s rows and columns of ``shard_host_batch(..., P(("dp", "ep"),
    "sp"))``."""
    x = np.arange(8 * 16, dtype=np.int32).reshape(8, 16)
    mesh = Mesh(np.asarray(jax.devices()[:dp * sp * ep]).reshape(dp, sp, ep),
                ("dp", "sp", "ep"))
    placed = jax_mesh.shard_host_batch(x, mesh, P(("dp", "ep"), "sp"))
    got = VirtualRanks(dp, torch.device("cpu"), sp, ep).shard(
        torch.from_numpy(x))
    assert got.shape == (dp, ep, sp, 8 // (dp * ep), 16 // sp)
    for shard in placed.addressable_shards:
        d, s, e = (int(i) for i in np.argwhere(
            mesh.devices == shard.device)[0])
        np.testing.assert_array_equal(got[d, e, s].numpy(),
                                      np.asarray(shard.data))


# -- (b) the loss ------------------------------------------------------------------

def _jax_sharded_loss(params, batch, dp, sp, ep):
    """JAX's ``loss_fn(sp_axis, dp_axis, ep_axis)`` on every device of a
    (dp, sp, ep) mesh under ``shard_map`` (``check_vma=False``), the
    batch at ``P(("dp", "ep"), "sp")``, the experts at
    ``param_specs(ep_axis="ep")``."""
    mesh = Mesh(np.asarray(jax.devices()[:dp * sp * ep]).reshape(dp, sp, ep),
                ("dp", "sp", "ep"))
    spec = P(("dp", "ep"), "sp")
    f = jax.jit(jax.shard_map(
        lambda p, b: jax_llama.loss_fn(p, b, JC, sp_axis="sp", dp_axis="dp",
                                       ep_axis="ep")[None],
        mesh=mesh, in_specs=(jax_llama.param_specs(JC, tp_axis=None,
                                                   ep_axis="ep"),
                             (spec, spec)),
        out_specs=P(("dp", "sp", "ep")), check_vma=False))
    return np.asarray(f(params, tuple(map(jnp.asarray, batch))))


def test_sp_ep_loss_matches_jax_shard_map():
    params, batch = _params(1), _batch(1)
    want = _jax_sharded_loss(params, batch, 2, 2, 2)
    assert np.all(want == want[0])
    full = float(jax_llama.loss_fn(params, tuple(map(jnp.asarray, batch)),
                                   JC))
    np.testing.assert_allclose(want[0], full, rtol=1e-5)
    trees = split_ep(llama.params_from_jax(params, "cpu"),
                     llama.param_specs(PC), 2)
    ranks = VirtualRanks(2, torch.device("cpu"), 2, 2)
    tb = ranks.shard_batch(tuple(map(torch.from_numpy, batch)))
    losses = llama.dp_loss_fn(PC, 2, 2, n_sp=2)(
        [trees[e] for e in range(2) for _ in range(2)], tb)
    assert losses.shape == (4,)
    np.testing.assert_allclose(_np(losses), want[0], rtol=1e-5)
    # one dp rank's ep ranks and their sp shards through loss_fn
    rank0 = llama.loss_fn(trees, tuple(b[0] for b in tb), PC, ep_axis="ep",
                          sp_axis="sp")
    sub = tuple(b[:4] for b in batch)          # dp rank 0's rows
    want0 = _jax_sharded_loss(params, sub, 1, 2, 2)
    np.testing.assert_allclose(float(rank0), want0[0], rtol=1e-5)


# -- (c) the trainer over dp x sp x ep ---------------------------------------------

def _ref_steps(tree, batch, clip=None, n=2):
    """Two unsharded SGD steps (lr 0.1), JAX's ``clip_by_global_norm`` on
    the whole flat gradient when ``clip`` is set; also each step's
    pre-clip norm."""
    jb = tuple(map(jnp.asarray, batch))
    norms = []
    for _ in range(n):
        g = jax.grad(lambda p: jax_llama.loss_fn(p, jb, JC))(tree)
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


def _trainer(dp, sp, ep, clip=None, remat=False):
    cfg = TrainConfig(global_batch=B, mesh=MeshConfig(dp=dp, sp=sp, ep=ep),
                      collective=CollectiveConfig(impl="xla"),
                      optimizer=OptimizerConfig(kind="sgd", learning_rate=0.1,
                                                clip_norm=clip))
    return ShardedTrainer(llama.dp_loss_fn(PC, dp, ep, n_sp=sp, remat=remat),
                          make_ranks(cfg.mesh, "cpu"), cfg,
                          param_specs=llama.param_specs(PC))


def _train(tr, params, batch, steps=2):
    state = tr.init_state(llama.params_from_jax(params, "cpu"))
    sb = tr.shard_batch(tuple(map(torch.from_numpy, batch)))
    losses = []
    for _ in range(steps):
        state, loss = tr.step(state, sb)
        losses.append(float(loss))
    return state, sb, losses


def _check_against(tr, state, want, dp, ep):
    got = fused_update.tree_leaves(tr.global_params(state))
    for g, w in zip(got, jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(_np(g), np.asarray(w, np.float32),
                                   **TRAIN_TOL)
    reps = state.replicas.reshape(ep, dp, -1)
    assert (reps == reps[:, :1]).all()
    for a, b in tr._rep_spans:
        assert (reps[:, :, a:b] == reps[:1, :, a:b]).all()


@pytest.mark.parametrize("dp,sp,ep,remat", [(2, 2, 2, False),
                                            (2, 2, 2, True),
                                            (1, 2, 4, False),
                                            (1, 4, 2, False)])
def test_sharded_trainer_dp_sp_ep_matches_unsharded(dp, sp, ep, remat):
    params, batch = _params(0), _batch(0)
    want, _ = _ref_steps(params, batch)
    tr = _trainer(dp, sp, ep, remat=remat)
    state, sb, losses = _train(tr, params, batch)
    assert sb[0].shape == (dp, ep, sp, B // (dp * ep), S // sp)
    assert np.isfinite(losses).all() and losses[1] < losses[0]
    _check_against(tr, state, want, dp, ep)


def test_sp_ep_routing_drops_nothing_at_this_capacity(monkeypatch):
    """The parity above holds because nothing drops: capacity is per
    device (``B S_local`` tokens), so a binding one drops other tokens
    than the unsharded run's."""
    from fpga_ai_nic_tpu_torch.ops import moe
    seen = []
    ranks = moe.moe_ranks

    def spy(*a):
        y, parts = ranks(*a)
        seen.append(parts)
        return y, parts

    monkeypatch.setattr(moe, "moe_ranks", spy)
    tr = _trainer(2, 2, 2)
    _train(tr, _params(0), _batch(0), steps=1)
    stats = moe._stats_from_routing(moe.pool(seen), 2)
    assert float(stats["drop_frac"]) == 0.0
    assert all(p.n_ranks == 4 and p.n_tok == 4 * 2 * 8 for p in seen)
    assert seen[0].capacity == PC.moe.capacity(2 * 8)


# -- (d) clip with ep ---------------------------------------------------------------

def test_norm_weight_tables_match_jax():
    params = _params(0)
    jmesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 1, 1, 2),
                 ("dp", "tp", "sp", "ep"))
    jtr = JaxShardedTrainer(
        lambda p, b: jax_llama.loss_fn(p, b, JC, dp_axis="dp", ep_axis="ep"),
        jmesh, jcfg.TrainConfig(
            global_batch=B, mesh=jcfg.MeshConfig(dp=2, ep=2),
            collective=jcfg.CollectiveConfig(impl="xla"),
            optimizer=jcfg.OptimizerConfig(clip_norm=1.0)),
        jax_llama.param_specs(JC, tp_axis=None, ep_axis="ep"), ep_axis="ep")
    jtr._ensure_meta(params)
    want_b, want_v = jtr._norm_weight_tables()
    tr = _trainer(2, 1, 2, clip=1.0)
    tr.init_state(llama.params_from_jax(params, "cpu"))
    got_b, got_v = tr.norm_weight_tables()
    assert got_b.dtype == want_b.dtype and got_v.dtype == want_v.dtype
    np.testing.assert_array_equal(got_b, want_b)
    np.testing.assert_array_equal(got_v, want_v)
    assert set(np.unique(got_v).tolist()) >= {0.5, 1.0}
    assert tr._norm_weights is not None


def test_pre_clip_norm_equals_unsharded():
    params, batch = _params(2), _batch(2)
    g = jax.grad(lambda p: jax_llama.loss_fn(
        p, tuple(map(jnp.asarray, batch)), JC))(params)
    want = float(np.linalg.norm(_flat(g)))
    for sp in (1, 2):
        tr = _trainer(2, sp, 2, clip=1.0)
        state = tr.init_state(llama.params_from_jax(params, "cpu"))
        flat_g, _ = tr.grads(state, tr.shard_batch(
            tuple(map(torch.from_numpy, batch))))
        g_own = tr._reduce(flat_g)
        bounds, values = tr.norm_weight_tables()
        got = float(optim.global_norm(g_own, (bounds, values)))
        np.testing.assert_allclose(got, want, rtol=1e-5)
        # JAX's per-element weights over the same [ep n_dp, C] rows
        per_el = torch.from_numpy(np.repeat(values, np.diff(bounds)))
        weights = per_el.reshape(2, -1).repeat(2, 1)
        np.testing.assert_allclose(float(optim.global_norm(g_own, weights)),
                                   want, rtol=1e-5)
        assert float(optim.global_norm(g_own)) > want * 1.01   # unweighted


@pytest.mark.parametrize("binds", [True, False])
def test_clipped_steps_match_unsharded(binds):
    params, batch = _params(3), _batch(3)
    _, norms = _ref_steps(params, batch)
    clip = 0.5 * norms[0] if binds else 4.0 * max(norms)
    want, clipped_norms = _ref_steps(params, batch, clip=clip)
    assert (clipped_norms[0] > clip) == binds
    assert binds or max(clipped_norms) < clip
    tr = _trainer(2, 2, 2, clip=clip)
    state, _, _ = _train(tr, params, batch)
    _check_against(tr, state, want, 2, 2)
    if binds:          # a clip that binds moves the weights elsewhere
        free, _ = _ref_steps(params, batch)
        leaf = jax.tree_util.tree_leaves(free)[0]
        got = fused_update.tree_leaves(tr.global_params(state))[0]
        assert not np.allclose(_np(got), np.asarray(leaf), **TRAIN_TOL)


def test_clip_norm_needs_the_unfused_update():
    cfg = TrainConfig(global_batch=B, mesh=MeshConfig(dp=2, sp=2, ep=2),
                      collective=CollectiveConfig(impl="ring",
                                                  fused_optimizer=True),
                      optimizer=OptimizerConfig(clip_norm=1.0))
    with pytest.raises(ValueError, match="fused_optimizer"):
        ShardedTrainer(llama.dp_loss_fn(PC, 2, 2, n_sp=2),
                       make_ranks(cfg.mesh, "cpu"), cfg,
                       param_specs=llama.param_specs(PC))


# -- (e) the driver ------------------------------------------------------------------

def test_train_llama_sp_ep_remat_clip_on_cpu():
    argv = ["--model=tiny", "--device=cpu", "--model.moe_experts=4",
            "--model.attn_block=128", "--seq=256", "--global_batch=4",
            "--mesh.dp=2", "--mesh.sp=2", "--mesh.ep=2", "--remat=true",
            "--optimizer.clip_norm=1.0", "--iters=2",
            "--collective.impl=ring",
            "--collective.compression.codec=pallas",
            "--collective.fused_kernel=true"]
    out = train_llama.main(argv)
    assert out["mesh"] == {"dp": 2, "tp": 1, "sp": 2, "pp": 1, "ep": 2}
    assert out["remat"] is True
    assert np.isfinite(out["loss_first"]) and np.isfinite(out["loss_last"])
    mcfg, cfg, seq, _ = train_llama.parse(argv)
    assert (cfg.mesh.sp, cfg.mesh.ep, cfg.optimizer.clip_norm) == (2, 2, 1.0)
    assert mcfg.moe is not None and seq == 256
