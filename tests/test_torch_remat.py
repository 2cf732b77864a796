"""Per-block recomputation (``remat=True``) on the port against the JAX
package, on the CPU.

JAX wraps each decoder block in ``jax.checkpoint``; the port wraps it in
``torch.utils.checkpoint`` (a layer of the joint-ranks graph as one unit,
since the ep exchange couples its ranks).  The same seeded numpy inputs
(JAX's ``init`` weights carried across with ``params_from_jax``) go
through both:

- (a) the dense per-rank loss: gradients with remat bit-equal to those
  without, and within ``test_torch_llama_train.py``'s limit (1e-3
  relative plus 1e-4 of the largest) of JAX's ``loss_fn(remat=True)``;
- (b) the dp = 2 x sp = 2 trainer's gradients and the dp = 2 x ep = 2
  MoE trainer's (``llama.dp_loss_fn``): bit-equal with and without
  remat, their dp mean against JAX's unsharded ``loss_fn(remat=True)``;
- (c) the routing of every MoE layer: the recomputation picks the same
  experts, keep and slots as the forward, and those equal the routing
  without remat; the expert statistics are equal;
- (d) ``train_llama --remat=true`` on the CPU.

Bit-equality needs ``torch.use_deterministic_algorithms``: above 32768
elements the CPU's accumulating ``index_put`` (the token embedding's
backward) adds in parallel, so two runs of the same graph, remat or not,
differ there by an ulp (``deterministic`` fixture).
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import jax
import jax.numpy as jnp

from fpga_ai_nic_tpu.models import llama as jax_llama
from fpga_ai_nic_tpu_torch import train_llama
from fpga_ai_nic_tpu_torch.models import llama
from fpga_ai_nic_tpu_torch.ops import fused_update, moe
from fpga_ai_nic_tpu_torch.parallel.mesh import make_ranks
from fpga_ai_nic_tpu_torch.parallel.sharded import ShardedTrainer, join_ep
from fpga_ai_nic_tpu_torch.utils.config import (
    CollectiveConfig, MeshConfig, OptimizerConfig, TrainConfig)

SEQ = 128
DENSE = dataclasses.replace(jax_llama.LlamaConfig.tiny(), attn_block=128)
MOE = dataclasses.replace(
    jax_llama.LlamaConfig.tiny(n_layers=2, ffn_dim=64), moe_experts=4,
    moe_top_k=2, moe_capacity_factor=16.0)


@pytest.fixture
def deterministic():
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


def _port(jc, **kw):
    return llama.LlamaConfig(**dataclasses.replace(jc, **kw).__dict__)


def _batch(vocab, B, S, seed):
    toks = np.random.default_rng(seed).integers(
        0, vocab, (B, S + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def _flat(tree):
    return np.concatenate([np.asarray(v, np.float32).reshape(-1)
                           for v in jax.tree_util.tree_leaves(tree)])


def _jax_remat_grad(jc, params, batch):
    """JAX's unsharded ``loss_fn(remat=True)`` and its flat gradient."""
    loss, g = jax.value_and_grad(lambda p: jax_llama.loss_fn(
        p, tuple(map(jnp.asarray, batch)), jc, remat=True))(params)
    return float(loss), _flat(g)


def _close_to_jax(got, want):
    """``test_torch_llama_train.py``'s limit against JAX's gradients."""
    np.testing.assert_allclose(got, want, rtol=1e-3,
                               atol=1e-4 * np.abs(want).max())


# -- (a) the dense per-rank loss ----------------------------------------------------

@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_dense_remat_bitequal_and_matches_jax(impl, deterministic):
    jc = dataclasses.replace(DENSE, attn_impl=impl)
    pc = _port(jc)
    params = jax.tree_util.tree_map(
        np.asarray, jax_llama.init(jax.random.PRNGKey(0), jc))
    batch = _batch(jc.vocab, 2, SEQ, seed=1)
    tree = llama.params_from_jax(params, "cpu")
    leaves = [t.requires_grad_() for t in fused_update.tree_leaves(tree)]
    tb = tuple(map(torch.from_numpy, batch))
    got = {}
    for remat in (False, True):
        loss = llama.loss_fn(tree, tb, pc, remat=remat)
        got[remat] = (loss.detach(), torch.autograd.grad(loss, leaves))
    assert torch.equal(got[False][0], got[True][0])
    for a, b in zip(got[False][1], got[True][1]):
        assert torch.equal(a, b)
    l_w, g_w = _jax_remat_grad(jc, params, batch)
    np.testing.assert_allclose(float(got[True][0]), l_w, rtol=1e-5)
    _close_to_jax(torch.cat([g.reshape(-1) for g in got[True][1]]).numpy(),
                  g_w)


# -- (b) the trainers' gradients: dp x sp, and MoE over dp x ep -----------------------

def _trainer(mesh, loss, pc=None):
    cfg = TrainConfig(global_batch=4, mesh=mesh,
                      collective=CollectiveConfig(impl="xla"),
                      optimizer=OptimizerConfig(kind="sgd",
                                                learning_rate=0.1))
    specs = None if pc is None else llama.param_specs(pc)
    return ShardedTrainer(loss, make_ranks(mesh, "cpu"), cfg,
                          param_specs=specs)


def _grads_both_ways(make, params, batch):
    """The trainer's flat gradients with remat off and on, from the same
    weights and batch."""
    out = []
    for remat in (False, True):
        tr = make(remat)
        state = tr.init_state(llama.params_from_jax(params, "cpu"))
        flat_g, loss = tr.grads(state, tr.shard_batch(
            tuple(map(torch.from_numpy, batch))))
        out.append((flat_g, loss, tr))
    return out


def test_sp_trainer_remat_bitequal_and_matches_jax(deterministic):
    """dp = 2 x sp = 2 (``loss_fn(sp_axis="sp")`` a dp rank over its two
    stacked shards, ring attention between them)."""
    jc = dataclasses.replace(DENSE, attn_block=None)
    pc = _port(jc)
    params = jax.tree_util.tree_map(
        np.asarray, jax_llama.init(jax.random.PRNGKey(2), jc))
    batch = _batch(jc.vocab, 4, 2 * SEQ, seed=3)
    (g0, l0, _), (g1, l1, tr) = _grads_both_ways(
        lambda remat: _trainer(MeshConfig(dp=2, sp=2), lambda p, b:
                               llama.loss_fn(p, b, pc, sp_axis="sp",
                                             remat=remat)), params, batch)
    assert torch.equal(l0, l1) and torch.equal(g0, g1)
    l_w, g_w = _jax_remat_grad(jc, params, batch)
    np.testing.assert_allclose(float(l1), l_w, rtol=1e-5)
    _close_to_jax(g1.mean(0)[:g_w.size].numpy(), g_w)


def test_moe_ep_trainer_remat_bitequal_and_matches_jax(deterministic):
    """dp = 2 x ep = 2 (``dp_loss_fn``: one graph over the four ranks,
    each layer one checkpoint); the trainer's gradients (ep sum taken)
    averaged over dp and the expert shards joined give the unsharded
    gradient."""
    pc = _port(MOE)
    params = jax.tree_util.tree_map(
        np.asarray, jax_llama.init(jax.random.PRNGKey(4), MOE))
    batch = _batch(MOE.vocab, 4, 16, seed=5)
    (g0, l0, _), (g1, l1, tr) = _grads_both_ways(
        lambda remat: _trainer(MeshConfig(dp=2, ep=2), llama.dp_loss_fn(
            pc, 2, 2, remat=remat), pc), params, batch)
    assert torch.equal(l0, l1) and torch.equal(g0, g1)
    l_w, g_w = _jax_remat_grad(MOE, params, batch)
    np.testing.assert_allclose(float(l1), l_w, rtol=1e-5)
    mean = g1.reshape(2, 2, -1).mean(1)        # [ep, L_pad] dp mean
    got = fused_update.tree_leaves(join_ep(
        [fused_update.unflatten_tree(row, tr._meta) for row in mean],
        llama.param_specs(pc)))
    _close_to_jax(torch.cat([g.reshape(-1) for g in got]).numpy(), g_w)


# -- (c) the routing is recomputed as it was computed -------------------------------

def test_remat_recomputes_the_same_routing(monkeypatch, deterministic):
    """With remat each MoE layer routes twice (the forward, then the
    recomputation in the backward): both pick the same experts, keep and
    slots, and those equal the run without remat; the statistics pooled
    over the forward's calls are equal (dp = 2 ranks, a capacity that
    binds, so drops count)."""
    pc = _port(MOE, moe_capacity_factor=1.0)
    params = jax.tree_util.tree_map(
        np.asarray, jax_llama.init(jax.random.PRNGKey(6), MOE))
    batch = tuple(torch.from_numpy(b).reshape(2, 2, 16)
                  for b in _batch(MOE.vocab, 4, 16, seed=7))
    route, ranks = moe._route, moe.moe_ranks
    seen = {}

    def spy_route(*a):
        r = route(*a)
        seen["routes"].append(r)
        return r

    def spy_ranks(*a):
        y, parts = ranks(*a)
        seen["parts"].append(parts)
        return y, parts

    monkeypatch.setattr(moe, "_route", spy_route)
    monkeypatch.setattr(moe, "moe_ranks", spy_ranks)
    runs = {}
    for remat in (False, True):
        seen.update(routes=[], parts=[])
        tree = llama.params_from_jax(params, "cpu")
        leaves = [t.requires_grad_() for t in fused_update.tree_leaves(tree)]
        losses = llama.dp_loss_fn(pc, 2, 1, remat=remat)([tree, tree],
                                                          batch)
        n_fwd = len(seen["routes"])
        torch.autograd.grad(losses.sum(), leaves)
        assert n_fwd == 4 and len(seen["routes"]) == (2 if remat else 1) * 4
        fwd = seen["routes"][:n_fwd]
        if remat:        # the backward recomputes the last layer first
            rec = seen["routes"][n_fwd:]
            rec = rec[2:] + rec[:2]          # two dp groups a layer
            for a, b in zip(fwd, rec):
                for f in ("e_flat", "keep", "slot", "onehot", "probs"):
                    assert torch.equal(getattr(a, f), getattr(b, f))
        runs[remat] = (fwd, moe._stats_from_routing(
            moe.pool(seen["parts"][:n_fwd]), pc.moe_top_k))
    for a, b in zip(runs[False][0], runs[True][0]):
        for f in ("e_flat", "keep", "slot"):
            assert torch.equal(getattr(a, f), getattr(b, f))
    assert not all(bool(r.keep.all()) for r in runs[False][0])
    for k, v in runs[False][1].items():
        assert torch.equal(v, runs[True][1][k])


# -- (d) the driver ------------------------------------------------------------------

def test_train_llama_remat_on_cpu(deterministic):
    argv = ["--model=tiny", "--device=cpu", "--model.attn_block=128",
            "--seq=256", "--global_batch=4", "--mesh.dp=2", "--mesh.sp=2",
            "--iters=2"]
    off = train_llama.main(argv)
    on = train_llama.main(argv + ["--remat=true"])
    assert on["remat"] is True and off["remat"] is False
    assert (on["loss_first"], on["loss_last"]) == (off["loss_first"],
                                                   off["loss_last"])
    assert train_llama.remat_flag(["--remat=1"])
    assert not train_llama.remat_flag(["--remat=false"])
    assert not train_llama.remat_flag(["--seq=256"])
