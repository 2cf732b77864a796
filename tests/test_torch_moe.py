"""Mixture-of-experts and expert parallelism on the port against the JAX
package, on the CPU.

The same seeded numpy inputs (JAX's ``init`` weights carried across with
``params_from_jax``) go through both:

- (a) ``ops.moe``: routing (expert indices, ``keep``, ``slot`` equal),
  ``moe_ffn``'s y, aux and stats and its gradients against JAX's
  ``moe_ffn`` and ``jax.grad``, f32 and bf16; a binding capacity (JAX's
  ``test_capacity_drop_priority`` construction and a random batch that
  drops) and ``expert_stats``;
- (b) the stacked-ep ``moe_ffn`` at ep = 2 and 4 against JAX's
  ``moe_ffn(ep_axis="ep", batch_axes=("ep",))`` under ``shard_map`` (the
  ``test_moe_ep_matches_single_device`` construction), values and
  gradients;
- (c) the MoE Llama: ``apply(with_aux=True)``, ``loss_fn`` and its
  gradients against JAX's unsharded ones, the ep loss against the
  unsharded one, ``params_from_jax``, ``num_params``, ``active_params``;
- (d) ``ShardedTrainer`` at (dp, ep) = (2, 2), (1, 4), (2, 4) against
  two unsharded JAX SGD steps (the contract and tolerance of JAX's
  ``test_moe_llama_training_matches_unsharded``, which is red on this
  JAX: ROADMAP C.4); at dp = 2 x ep = 2 with the BFP codec on the plain
  ring, masters and replicas bit-equal to the numpy golden composition
  on JAX's (ep, dp) layout; the batch layout against JAX's ``P((dp,
  ep))``;
- (e) ``llama_decode.forward`` / ``forward_paged`` with MoE layers against
  JAX's, idle rows and a binding capacity included;
- (f) the mixed-dtype working replicas of ``DPTrainer`` (a bf16 tree with
  an f32 leaf);
- (g) ``train_llama`` and ``serve_llama`` on the CPU with MoE and ep.

Tolerances are stated at each check; both sides sum in f32 in other
orders.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from fpga_ai_nic_tpu.models import llama as jax_llama
from fpga_ai_nic_tpu.models import llama_decode as jax_dec
from fpga_ai_nic_tpu.ops import bfp_golden as jax_bfp_golden
from fpga_ai_nic_tpu.ops import moe as jax_moe
from fpga_ai_nic_tpu.ops import ring_golden as jax_ring_golden
from fpga_ai_nic_tpu.parallel import mesh as jax_mesh
from fpga_ai_nic_tpu.utils import config as jcfg
from fpga_ai_nic_tpu_torch import serve_llama, train_llama
from fpga_ai_nic_tpu_torch.models import llama, llama_decode as dec
from fpga_ai_nic_tpu_torch.ops import fused_update
from fpga_ai_nic_tpu_torch.ops import moe
from fpga_ai_nic_tpu_torch.parallel.mesh import VirtualRanks, make_ranks
from fpga_ai_nic_tpu_torch.parallel.sharded import (ShardedTrainer,
                                                    join_ep, split_ep)
from fpga_ai_nic_tpu_torch.parallel.train import DPTrainer
from fpga_ai_nic_tpu_torch.utils.config import (
    BFPConfig, CollectiveConfig, MeshConfig, OptimizerConfig, TrainConfig)

D, FF, E = 16, 32, 4
F32_TOL = dict(rtol=2e-4, atol=2e-5)      # test_moe_ep_matches_single_device
GRAD_TOL = dict(rtol=5e-4, atol=5e-5)     # the JAX MoE trainer test's limit
BF16_TOL = dict(rtol=0.05, atol=0.05)     # a few bf16 ulps of O(1) values
TRAIN_TOL = dict(rtol=5e-4, atol=5e-5)    # test_moe_llama_training_...


def _cfgs(cf=float(E), top_k=2):
    return (jax_moe.MoEConfig(num_experts=E, top_k=top_k,
                              capacity_factor=cf),
            moe.MoEConfig(num_experts=E, top_k=top_k, capacity_factor=cf))


def _jax_ffn(seed, jc, dtype=jnp.float32):
    return jax.tree_util.tree_map(np.asarray, jax_moe.init_ffn(
        jax.random.PRNGKey(seed), D, FF, jc, dtype=dtype))


def _t(tree, requires_grad=False):
    """numpy (bf16 kept by bits) -> torch leaves."""
    out = llama.params_from_jax({"layers": [{"moe": tree}]}, "cpu")
    out = out["layers"][0]["moe"]
    return {k: v.requires_grad_(requires_grad) for k, v in out.items()}


def _np(t):
    return t.detach().to(torch.float32).numpy()


# -- (a) ops.moe against JAX's --------------------------------------------------

@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("cf", [float(E), 1.0, 0.5])
def test_routing_matches_jax(top_k, cf):
    """Expert indices, keep and slot equal to JAX's ``_route`` (cf 1.0 and
    0.5 bind the capacity); gates and probs within f32 rounding."""
    jc, pc = _cfgs(cf, top_k)
    params = _jax_ffn(1, jc)
    x = np.random.default_rng(2).standard_normal((3, 8, D)).astype(
        np.float32)
    C = jc.capacity(24)
    want = jax_moe._route(params, jnp.asarray(x.reshape(24, D)), jc, C)
    got = moe._route(torch.tensor(params["wr"]),
                     torch.from_numpy(x.reshape(1, 24, D)), pc, C)
    gates, e_flat, onehot, keep, slot, probs = map(np.asarray, want)
    np.testing.assert_array_equal(got.e_flat[0].numpy(), e_flat)
    np.testing.assert_array_equal(got.keep[0].numpy(), keep)
    np.testing.assert_array_equal(got.slot[0].numpy(), slot)
    np.testing.assert_array_equal(got.onehot[0].numpy(), onehot)
    np.testing.assert_allclose(got.gates[0].numpy(), gates, rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(got.probs[0].numpy(), probs, rtol=1e-6,
                               atol=1e-7)
    if cf < 1.0:
        assert not keep.all()


def test_topk_ties_pick_the_lower_index():
    """Equal router probabilities: ``lax.top_k``'s choice (the lower
    expert index first), which ``torch.sort(stable=True)`` keeps."""
    jc, pc = _cfgs()
    wr = np.zeros((D, E), np.float32)
    wr[:, 2] = 1.0
    x = np.ones((1, 5, D), np.float32)
    x[0, 1] = -1.0                       # expert 2 last, 0 and 1 tied
    want = jax_moe._route({"wr": jnp.asarray(wr)}, jnp.asarray(x[0]), jc, 8)
    got = moe._route(torch.from_numpy(wr), torch.from_numpy(x), pc, 8)
    np.testing.assert_array_equal(got.e_flat[0].numpy(),
                                  np.asarray(want[1]))
    assert got.e_flat[0, 2:4].tolist() == [0, 1]


@pytest.mark.parametrize("cf", [float(E), 0.5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn_matches_jax(dtype, cf):
    """y, aux and the stats; gradients of ``sum(y * ct) + aux`` with
    respect to every leaf and x.  f32: F32_TOL on y and GRAD_TOL on the
    gradients; bf16 (JAX and torch round the expert products at other
    places): BF16_TOL on y and on the gradients relative to their
    largest magnitude; the aux within 1e-5 (from f32 router math)."""
    jc, pc = _cfgs(cf)
    jdt = jnp.dtype(dtype)
    params = _jax_ffn(3, jc, jdt)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 8, D)).astype(np.float32)
    ct = rng.standard_normal((2, 8, D)).astype(np.float32)

    def jloss(p, xx):
        y, aux = jax_moe.moe_ffn(p, xx, jc)
        return jnp.sum(y.astype(jnp.float32) * ct) + aux, (y, aux)

    (_, (y_w, aux_w)), (gp_w, gx_w) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(
            jax.tree_util.tree_map(jnp.asarray, params),
            jnp.asarray(x, jdt))
    stats_w = jax_moe.moe_ffn(jax.tree_util.tree_map(jnp.asarray, params),
                              jnp.asarray(x, jdt), jc, with_stats=True)[2]
    p_t = _t(params, True)
    x_t = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()
    y, aux, stats = moe.moe_ffn(p_t, x_t, pc, with_stats=True)
    loss = (y.float() * torch.from_numpy(ct)).sum() + aux
    grads = torch.autograd.grad(loss, [p_t[k] for k in sorted(p_t)] + [x_t])
    np.testing.assert_allclose(float(aux.detach()), float(aux_w), rtol=1e-5)
    for k in ("load_frac", "capacity_frac", "drop_frac"):
        np.testing.assert_allclose(_np(stats[k]), np.asarray(stats_w[k]),
                                   rtol=1e-6, atol=1e-7)
    assert int(stats["capacity"]) == int(stats_w["capacity"])
    want_g = [gp_w[k] for k in sorted(gp_w)] + [gx_w]
    if dtype == "float32":
        np.testing.assert_allclose(_np(y), np.asarray(y_w), **F32_TOL)
        for g, w in zip(grads, want_g):
            np.testing.assert_allclose(_np(g), np.asarray(w), **GRAD_TOL)
    else:
        np.testing.assert_allclose(_np(y), np.asarray(y_w, np.float32),
                                   **BF16_TOL)
        for g, w in zip(grads, want_g):
            w = np.asarray(w, np.float32)
            np.testing.assert_allclose(_np(g) / np.abs(w).max(),
                                       w / np.abs(w).max(), atol=0.02)


def test_capacity_drop_priority():
    """JAX's construction: capacity 1, the same token twice; the first
    gets the expert output (equal to the token alone), the second falls
    back to zero — both as JAX computes them."""
    jc, pc = _cfgs(1e-9, 1)
    params = _jax_ffn(5, jc)
    x0 = np.random.default_rng(6).standard_normal((1, 1, D)).astype(
        np.float32)
    x = np.concatenate([x0, x0], axis=1)
    p_t = _t(params)
    y, _ = moe.moe_ffn(p_t, torch.from_numpy(x), pc)
    y1, _ = moe.moe_ffn(p_t, torch.from_numpy(x0), pc)
    y_w, _ = jax_moe.moe_ffn(params, jnp.asarray(x), jc)
    np.testing.assert_allclose(_np(y), np.asarray(y_w), **F32_TOL)
    np.testing.assert_allclose(_np(y[0, 0]), _np(y1[0, 0]), rtol=1e-5)
    assert float(y[0, 1].abs().max()) == 0.0


@pytest.mark.parametrize("cf", [float(E), 0.75])
def test_expert_stats_match_jax(cf):
    jc, pc = _cfgs(cf)
    params = _jax_ffn(7, jc)
    x = np.random.default_rng(8).standard_normal((2, 8, D)).astype(
        np.float32)
    want = jax_moe.expert_stats(params, jnp.asarray(x), jc)
    got = moe.expert_stats(_t(params), torch.from_numpy(x), pc)
    for k in ("load_frac", "capacity_frac", "drop_frac"):
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7)
    assert float(got["load_frac"].sum()) == pytest.approx(1.0, abs=1e-6)
    assert (float(got["drop_frac"]) > 0) == (cf < 1)


# -- (b) the stacked-ep moe_ffn against JAX's under shard_map --------------------

@pytest.mark.parametrize("cf", [float(E), 1.0])
@pytest.mark.parametrize("ep", [2, 4])
def test_moe_ep_matches_jax_shard_map(ep, cf):
    """x [8, 4, D] split over ep ranks (JAX's ``P("ep")``), experts over
    ep: y and aux against JAX's ``moe_ffn(ep_axis="ep",
    batch_axes=("ep",))`` (F32_TOL; cf 1.0 drops tokens on each rank's
    local capacity, as both do), and the gradients of ``sum(y * ct) +
    aux`` with respect to the whole params and x (GRAD_TOL; the router's
    summed over the ranks' copies)."""
    jc, pc = _cfgs(cf)
    params = _jax_ffn(9, jc)
    rng = np.random.default_rng(10)
    x = rng.standard_normal((8, 4, D)).astype(np.float32)
    ct = rng.standard_normal((8, 4, D)).astype(np.float32)
    mesh = Mesh(np.array(jax.devices()[:ep]), ("ep",))
    specs = jax_moe.param_specs(jc, "ep")
    sm = jax.shard_map(
        lambda p, xx: jax_moe.moe_ffn(p, xx, jc, ep_axis="ep",
                                      batch_axes=("ep",)),
        mesh=mesh, in_specs=(specs, P("ep")), out_specs=(P("ep"), P()))

    def jloss(p, xx):
        y, aux = sm(p, xx)
        return jnp.sum(y * ct) + aux, (y, aux)

    (_, (y_w, aux_w)), (gp_w, gx_w) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(
            jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    whole = _t(params)
    trees = [{k: (v.chunk(ep)[e] if k != "wr" else v.clone())
              .requires_grad_() for k, v in whole.items()}
             for e in range(ep)]
    x_t = torch.from_numpy(x).reshape(ep, 8 // ep, 4, D).requires_grad_()
    y, aux = moe.moe_ffn(trees, x_t, pc, ep_axis="ep")
    loss = (y.reshape(8, 4, D) * torch.from_numpy(ct)).sum() + aux
    leaves = [t[k] for t in trees for k in sorted(t)]
    g = torch.autograd.grad(loss, leaves + [x_t])
    np.testing.assert_allclose(_np(y).reshape(8, 4, D), np.asarray(y_w),
                               **F32_TOL)
    np.testing.assert_allclose(float(aux.detach()), float(aux_w), rtol=1e-5)
    keys = sorted(whole)
    per_rank = [dict(zip(keys, g[e * 4:(e + 1) * 4])) for e in range(ep)]
    for k in keys:
        parts = [r[k] for r in per_rank]
        got = sum(parts) if k == "wr" else torch.cat(parts)
        np.testing.assert_allclose(_np(got), np.asarray(gp_w[k]),
                                   **GRAD_TOL)
    np.testing.assert_allclose(_np(g[-1]).reshape(8, 4, D),
                               np.asarray(gx_w), **GRAD_TOL)


def test_moe_ep_shapes_checked():
    _, pc = _cfgs()
    p = _t(_jax_ffn(0, _cfgs()[0]))
    with pytest.raises(ValueError, match="one tree a rank"):
        moe.moe_ffn(p, torch.zeros((2, 1, 4, D)), pc, ep_axis="ep")
    with pytest.raises(ValueError, match="expert shards"):
        moe.moe_ranks(p["wr"], [p, p], torch.zeros((3, 1, 4, D)), pc)
    with pytest.raises(ValueError, match="top_k"):
        moe.MoEConfig(num_experts=2, top_k=3)


# -- (c) the MoE Llama -----------------------------------------------------------

def _mcfgs(cf=16.0, dtype="float32", n_layers=2):
    j = dataclasses.replace(
        jax_llama.LlamaConfig.tiny(n_layers=n_layers, ffn_dim=64,
                                   dtype=dtype),
        moe_experts=4, moe_top_k=2, moe_capacity_factor=cf)
    return j, llama.LlamaConfig(**j.__dict__)


def _batch(vocab, B=8, S=16, seed=0):
    toks = np.random.default_rng(seed).integers(
        0, vocab, (B, S + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def _leaves_of(params):
    leaves = [t.requires_grad_() for t in fused_update.tree_leaves(params)]
    keys = tuple(p for p, _ in fused_update._leaves(params))
    return leaves, fused_update.tree_from_leaves(keys, leaves)


def test_moe_params_from_jax_and_counts():
    jc, pc = _mcfgs(dtype="bfloat16")
    tree = jax.tree_util.tree_map(np.asarray, jax_llama.init(
        jax.random.PRNGKey(0), jc))
    p = llama.params_from_jax(tree, "cpu")
    m = p["layers"][1]["moe"]
    assert m["wr"].dtype == torch.float32 and m["w1"].dtype == torch.bfloat16
    assert torch.equal(m["w2"].view(torch.int16), torch.from_numpy(
        tree["layers"][1]["moe"]["w2"].view(np.int16)))
    for c, j in ((pc, jc), (llama.LlamaConfig(**dataclasses.replace(
            jax_llama.LlamaConfig.llama3_8b(), vocab=32000,
            rope_theta=1e6, moe_experts=8).__dict__), None)):
        j = j or jax_llama.LlamaConfig(**c.__dict__)
        assert llama.num_params(c) == jax_llama.num_params(j)
        assert llama.active_params(c) == jax_llama.active_params(j)
    assert llama.param_bytes(p) == sum(
        a.nbytes for a in jax.tree_util.tree_leaves(tree))
    g = torch.Generator().manual_seed(0)
    init = llama.init(g, pc, "cpu")
    assert [sorted(lyr) for lyr in init["layers"]] == [
        sorted(lyr) for lyr in tree["layers"]]
    assert init["layers"][0]["moe"]["wr"].dtype == torch.float32


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("cf", [16.0, 1.0])
def test_moe_llama_loss_and_grads_match_jax(cf, impl):
    """``apply(with_aux=True)`` and ``loss_fn`` with its gradients against
    JAX's unsharded ones, f32, sequence 128 and attn_block 128 on both
    attention routes (JAX's Pallas kernels in interpret mode; cf 1.0
    drops tokens): logits F32_TOL, loss and aux rtol 1e-5, gradients
    GRAD_TOL."""
    jc, pc = _mcfgs(cf)
    jc = dataclasses.replace(jc, attn_block=128, attn_impl=impl)
    pc = dataclasses.replace(pc, attn_block=128, attn_impl=impl)
    tree = jax_llama.init(jax.random.PRNGKey(1), jc)
    toks, labels = _batch(jc.vocab, B=1, S=128)
    jb = (jnp.asarray(toks), jnp.asarray(labels))
    logits_w, aux_w = jax_llama.apply(tree, jb[0], jc, with_aux=True)
    loss_w, g_w = jax.value_and_grad(
        lambda p: jax_llama.loss_fn(p, jb, jc))(tree)
    leaves, params = _leaves_of(llama.params_from_jax(
        jax.tree_util.tree_map(np.asarray, tree), "cpu"))
    tb = tuple(map(torch.from_numpy, (toks, labels)))
    logits, aux = llama.apply(params, tb[0], pc, with_aux=True)
    np.testing.assert_allclose(_np(logits), np.asarray(logits_w), **F32_TOL)
    np.testing.assert_allclose(float(aux.detach()), float(aux_w), rtol=1e-5)
    loss = llama.loss_fn(params, tb, pc)
    np.testing.assert_allclose(float(loss), float(loss_w), rtol=1e-5)
    for g, w in zip(torch.autograd.grad(loss, leaves),
                    jax.tree_util.tree_leaves(g_w)):
        np.testing.assert_allclose(_np(g), np.asarray(w), **GRAD_TOL)


@pytest.mark.parametrize("ep", [2, 4])
def test_moe_llama_ep_loss_matches_unsharded(ep):
    """The ep loss (params the ep ranks' trees, tokens [n_ep, B, S])
    against JAX's unsharded loss (rtol 1e-5; a generous capacity drops
    nothing on either side) and its gradients, experts concatenated and
    the replicated leaves summed over the ranks' copies, against
    ``jax.grad`` (GRAD_TOL)."""
    jc, pc = _mcfgs()
    tree = jax_llama.init(jax.random.PRNGKey(2), jc)
    toks, labels = _batch(jc.vocab)
    jb = (jnp.asarray(toks), jnp.asarray(labels))
    loss_w, g_w = jax.value_and_grad(
        lambda p: jax_llama.loss_fn(p, jb, jc))(tree)
    whole = llama.params_from_jax(jax.tree_util.tree_map(np.asarray, tree),
                                  "cpu")
    trees = [fused_update.tree_map(lambda t: t.clone(), t)
             for t in split_ep(whole, llama.param_specs(pc), ep)]
    per_rank = [_leaves_of(t) for t in trees]
    tb = tuple(torch.from_numpy(b).reshape(ep, 8 // ep, -1)
               for b in (toks, labels))
    loss = llama.loss_fn([p for _, p in per_rank], tb, pc, ep_axis="ep")
    np.testing.assert_allclose(float(loss), float(loss_w), rtol=1e-5)
    g = torch.autograd.grad(loss, [t for ls, _ in per_rank for t in ls])
    n = len(per_rank[0][0])
    specs = fused_update.tree_leaves(llama.param_specs(pc))
    for i, (w, spec) in enumerate(zip(jax.tree_util.tree_leaves(g_w),
                                      specs)):
        parts = [g[e * n + i] for e in range(ep)]
        got = torch.cat(parts) if spec else sum(parts)
        np.testing.assert_allclose(_np(got), np.asarray(w), **GRAD_TOL)
    joined = join_ep(trees, llama.param_specs(pc))
    for a, b in zip(fused_update.tree_leaves(joined),
                    fused_update.tree_leaves(whole)):
        assert torch.equal(a, b)
    # sp with ep is ported (tests/test_torch_sp_ep.py): each ep rank's
    # tokens in two sequence shards give the same loss
    tb_sp = VirtualRanks(1, torch.device("cpu"), 2, ep).shard_batch(
        tuple(map(torch.from_numpy, (toks, labels))))
    loss_sp = llama.loss_fn([p for _, p in per_rank],
                            tuple(b[0] for b in tb_sp), pc, ep_axis="ep",
                            sp_axis="sp")
    np.testing.assert_allclose(float(loss_sp), float(loss_w), rtol=1e-5)


# -- (d) the trainer ----------------------------------------------------------------

def _ref_steps(jc, tree, batch, n=2):
    def ref_step(params):
        g = jax.grad(lambda p: jax_llama.loss_fn(p, batch, jc))(params)
        return jax.tree_util.tree_map(
            lambda w, gg: (w.astype(jnp.float32)
                           - 0.1 * gg.astype(jnp.float32)).astype(w.dtype),
            params, g)
    for _ in range(n):
        tree = ref_step(tree)
    return tree


def _trainer(pc, dp, ep, coll=None):
    cfg = TrainConfig(global_batch=8, mesh=MeshConfig(dp=dp, ep=ep),
                      collective=coll or CollectiveConfig(impl="xla"),
                      optimizer=OptimizerConfig(kind="sgd",
                                                learning_rate=0.1))
    return ShardedTrainer(llama.dp_loss_fn(pc, dp, ep),
                          make_ranks(cfg.mesh, "cpu"), cfg,
                          param_specs=llama.param_specs(pc))


@pytest.mark.parametrize("dp,ep", [(2, 2), (1, 4), (2, 4)])
def test_sharded_trainer_dp_ep_matches_unsharded(dp, ep):
    """JAX's ``test_moe_llama_training_matches_unsharded`` contract at its
    sizes and tolerance (rtol 5e-4, atol 5e-5 on every weight): two dp x
    ep ZeRO-1 SGD steps equal two unsharded steps; the replicated leaves
    bit-equal across the ep groups, the replicas across dp."""
    jc, pc = _mcfgs()
    toks, labels = _batch(jc.vocab)
    tree = jax_llama.init(jax.random.PRNGKey(0), jc)
    want = _ref_steps(jc, tree, (jnp.asarray(toks), jnp.asarray(labels)))
    tr = _trainer(pc, dp, ep)
    state = tr.init_state(llama.params_from_jax(
        jax.tree_util.tree_map(np.asarray, tree), "cpu"))
    batch = tr.shard_batch(tuple(map(torch.from_numpy, (toks, labels))))
    assert batch[0].shape == (dp, ep, 8 // (dp * ep), 16)
    losses = []
    for _ in range(2):
        state, loss = tr.step(state, batch)
        losses.append(float(loss))
    assert np.isfinite(losses).all() and losses[1] < losses[0]
    got = fused_update.tree_leaves(tr.global_params(state))
    for g, w in zip(got, jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(_np(g), np.asarray(w, np.float32),
                                   **TRAIN_TOL)
    reps = state.replicas.reshape(ep, dp, -1)
    assert (reps == reps[:, :1]).all()
    for a, b in tr._rep_spans:
        assert (reps[:, :, a:b] == reps[:1, :, a:b]).all()
    assert state.w_own.shape[0] == dp * ep


def test_sharded_trainer_dp_ep_bfp_ring_matches_golden():
    """dp = 2 x ep = 2, the BFP sublane codec on the fused ring kernels'
    route (their plain versions on the CPU): given the trainer's
    gradients (replicated leaves summed over ep, checked equal across the
    ep rows), the masters equal bit for bit the numpy golden composition
    on JAX's (ep, dp) layout — per ep group ``ring_golden``'s
    reduce-scatter, the division by n_dp, SGD, and ``bfp_golden``'s
    quantize-once gather for the replicas."""
    jc, pc = _mcfgs()
    dp, ep = 2, 2
    coll = CollectiveConfig(impl="ring", compression=BFPConfig(
        codec="pallas"), fused_kernel=True)
    tr = _trainer(pc, dp, ep, coll)
    tree = jax.tree_util.tree_map(np.asarray, jax_llama.init(
        jax.random.PRNGKey(3), jc))
    state = tr.init_state(llama.params_from_jax(tree, "cpu"))
    for step in range(2):
        toks, labels = _batch(jc.vocab, seed=20 + step)
        batch = tr.shard_batch(tuple(map(torch.from_numpy, (toks, labels))))
        flat_g, _ = tr.grads(state, batch)
        g = flat_g.numpy().reshape(ep, dp, -1)
        for a, b in tr._rep_spans:
            assert (g[:, :, a:b] == g[:1, :, a:b]).all()
        w_old = state.w_own.numpy().reshape(ep, dp, -1)
        state = tr.apply_grads(state, flat_g)
        for e in range(ep):
            g_sum = jax_ring_golden.ring_reduce_scatter(
                g[e], jcfg.BFPConfig(), "sublane")
            w_ref = w_old[e] - np.float32(0.1) * (g_sum / np.float32(dp))
            np.testing.assert_array_equal(
                state.w_own.numpy().reshape(ep, dp, -1)[e], w_ref)
            q = np.concatenate([jax_bfp_golden.bfp_decode(
                *jax_bfp_golden.bfp_encode(w, layout="sublane"),
                layout="sublane") for w in w_ref])
            for d in range(dp):
                np.testing.assert_array_equal(
                    state.replicas[e * dp + d].numpy(), q)
        assert not np.array_equal(w_old[0], w_old[1])   # shards differ


@pytest.mark.parametrize("dp,ep", [(2, 2), (1, 4), (2, 4)])
def test_batch_layout_matches_jax_p_dp_ep(dp, ep):
    """Rank (d, e) of ``VirtualRanks.shard`` holds JAX device (d, e)'s
    rows of ``shard_host_batch(..., P(("dp", "ep"), "sp"))``."""
    x = np.arange(8 * 6, dtype=np.int32).reshape(8, 6)
    mesh = Mesh(np.asarray(jax.devices()[:dp * ep]).reshape(dp, 1, ep),
                ("dp", "sp", "ep"))
    placed = jax_mesh.shard_host_batch(x, mesh, P(("dp", "ep"), "sp"))
    got = VirtualRanks(dp, torch.device("cpu"), ep=ep).shard(
        torch.from_numpy(x))
    for shard in placed.addressable_shards:
        d, _, e = (int(i) for i in np.argwhere(
            mesh.devices == shard.device)[0])
        np.testing.assert_array_equal(got[d, e].numpy(),
                                      np.asarray(shard.data))


def test_ep_trainer_refusals():
    _, pc = _mcfgs()
    cfg = TrainConfig(global_batch=8, mesh=MeshConfig(dp=2, ep=2))
    ranks = make_ranks(cfg.mesh, "cpu")
    loss = llama.dp_loss_fn(pc, 2, 2)
    with pytest.raises(ValueError, match="param_specs"):
        ShardedTrainer(loss, ranks, cfg)
    with pytest.raises(ValueError, match="joint_ranks"):
        ShardedTrainer(lambda p, b: None, ranks, cfg,
                       param_specs=llama.param_specs(pc))
    # clip_norm with ep is ported (tests/test_torch_sp_ep.py): it builds
    # and steps
    tr = ShardedTrainer(loss, ranks, dataclasses.replace(
        cfg, optimizer=OptimizerConfig(clip_norm=1.0)),
        param_specs=llama.param_specs(pc))
    jc, _ = _mcfgs()
    state = tr.init_state(llama.params_from_jax(jax.tree_util.tree_map(
        np.asarray, jax_llama.init(jax.random.PRNGKey(0), jc)), "cpu"))
    state, loss_v = tr.step(state, tr.shard_batch(
        tuple(map(torch.from_numpy, _batch(jc.vocab)))))
    assert np.isfinite(float(loss_v)) and tr._norm_weights is not None
    with pytest.raises(NotImplementedError, match="ShardedTrainer"):
        DPTrainer(loss, ranks, cfg)
    # sp with ep is ported: the ranks build and shard [n, ep, sp, B, Sl]
    r = make_ranks(MeshConfig(dp=1, sp=2, ep=2), "cpu")
    assert (r.n, r.sp, r.ep) == (1, 2, 2)
    assert r.shard(torch.zeros((4, 16))).shape == (1, 2, 2, 2, 8)


# -- (e) decoding with MoE layers ---------------------------------------------------

@pytest.mark.parametrize("cf", [16.0, 0.5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_forward_and_forward_paged_match_jax(dtype, cf):
    """A prefill chunk, then decode ticks of R = 3 slots with one idle
    slot (``active`` false, its row still routed and taking capacity in
    token-major order, as in JAX's tick), logits against JAX's
    ``forward`` / ``forward_paged`` (f32: 1e-5; bf16: 0.1, as
    tests/test_torch_llama_decode.py); cf 0.5 binds the capacity of the
    tick's tokens."""
    jc, pc = _mcfgs(cf, dtype)
    tol = (dict(atol=1e-5, rtol=1e-5) if dtype == "float32"
           else dict(atol=0.1, rtol=0.1))
    tree = jax.tree_util.tree_map(np.asarray, jax_llama.init(
        jax.random.PRNGKey(4), jc))
    params = llama.params_from_jax(tree, "cpu")
    R, PS, PW, NPG = 3, 4, 4, 16
    rng = np.random.default_rng(5)
    toks = rng.integers(0, jc.vocab, (R, 8)).astype(np.int32)
    table = rng.permutation(np.arange(1, NPG))[:R * PW].reshape(
        R, PW).astype(np.int32)
    dt = getattr(torch, dtype)
    shape = (NPG, jc.n_kv_heads, PS, jc.head_dim)
    pool = [{k: torch.zeros(shape, dtype=dt) for k in ("k", "v")}
            for _ in range(jc.n_layers)]
    jpool = [{k: jnp.zeros(shape, jnp.dtype(dtype)) for k in ("k", "v")}
             for _ in range(jc.n_layers)]
    cache = dec.init_cache(pc, R, PW * PS, device="cpu")
    jcache = jax_dec.init_cache(jc, R, PW * PS)
    active = np.array([True, False, True])
    for chunk, p0 in [(toks[:, :4], 0)] + [(toks[:, s:s + 1], s)
                                           for s in range(4, 8)]:
        got, cache = dec.forward(params, torch.from_numpy(chunk), cache,
                                 p0, pc)
        want, jcache = jax_dec.forward(tree, jnp.asarray(chunk), jcache,
                                       jnp.int32(p0), jc)
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                                   **tol)
        pos = np.full((R,), p0, np.int32)
        act = active if p0 >= 4 else np.ones(R, bool)
        gotp, pool = dec.forward_paged(
            params, torch.from_numpy(chunk), pool, torch.from_numpy(table),
            torch.from_numpy(pos), pc, page_size=PS,
            active=torch.from_numpy(act))
        wantp, jpool = jax_dec.forward_paged(
            tree, jnp.asarray(chunk), jpool, jnp.asarray(table),
            jnp.asarray(pos), jc, page_size=PS, active=jnp.asarray(act))
        np.testing.assert_allclose(_np(gotp), np.asarray(wantp, np.float32),
                                   **tol)


# -- (f) the mixed-dtype working replicas ---------------------------------------------

def test_working_replicas_keep_the_model_dtype_with_an_f32_leaf():
    """A bf16 tree with one f32 leaf: the replicas stay bf16 (views for the
    bf16 leaves), the f32 leaf is held apart exactly, and every leaf has
    the bits of a per-leaf cast of the f32 masters (JAX's
    ``unflatten_tree``), through init and a step."""
    g = torch.Generator().manual_seed(0)
    tree = {"a": torch.randn((6, 40), generator=g).to(torch.bfloat16),
            "r": torch.randn((40, 3), generator=g),
            "z": torch.randn((40,), generator=g).to(torch.bfloat16)}
    cfg = TrainConfig(global_batch=4, mesh=MeshConfig(dp=2),
                      collective=CollectiveConfig(impl="xla"),
                      optimizer=OptimizerConfig(kind="sgd",
                                                learning_rate=0.1))

    def loss(p, b):
        h = (b[0].to(torch.bfloat16) @ p["a"]).float() @ p["r"]
        return (h.square().mean() + p["z"].float().sum()) * 1e-2

    tr = DPTrainer(loss, VirtualRanks(2, torch.device("cpu")), cfg)
    state = tr.init_state(tree)
    for _ in range(2):
        assert state.replicas.dtype == torch.bfloat16
        assert state.side.dtype == torch.float32
        assert state.side.shape == (2, 120)
        assert state.params["a"]._base is not None    # a view
        masters = tr.params_from_master(state.w_own)
        flat = state.w_own.reshape(-1)
        want = fused_update.unflatten_tree(flat, tr._meta)
        for k in tree:
            assert state.params[k].dtype == tree[k].dtype
            assert torch.equal(state.params[k], want[k])
            assert torch.equal(masters[k], want[k])
        state, _ = tr.step(state, tr.shard_batch(
            (torch.randn((4, 6), generator=g),)))
    one = {"a": tree["a"], "z": tree["z"]}
    st1 = DPTrainer(lambda p, b: p["a"].float().sum(),
                    VirtualRanks(2, torch.device("cpu")), cfg).init_state(one)
    assert st1.side is None and st1.replicas.dtype == torch.bfloat16


# -- (g) the drivers on the CPU ----------------------------------------------------------

def test_train_llama_moe_ep_on_cpu():
    out = train_llama.main([
        "--model=tiny", "--device=cpu", "--model.moe_experts=4",
        "--model.attn_block=16", "--seq=32", "--global_batch=4",
        "--mesh.dp=2", "--mesh.ep=2", "--iters=2",
        "--collective.impl=ring", "--collective.compression.codec=pallas",
        "--collective.fused_kernel=true"])
    assert out["mesh"]["ep"] == 2 and out["mesh"]["dp"] == 2
    assert np.isfinite(out["loss_first"]) and np.isfinite(out["loss_last"])
    mcfg = dataclasses.replace(llama.LlamaConfig.tiny(), moe_experts=4)
    assert out["params"] == llama.num_params(mcfg)
    assert out["active_params"] == llama.active_params(mcfg) < out["params"]
    # sp with MoE is ported (tests/test_torch_sp_ep.py): it parses
    mcfg, cfg, _, _ = train_llama.parse(["--model.moe_experts=4",
                                         "--seq=256", "--mesh.sp=2"])
    assert cfg.mesh.sp == 2 and mcfg.moe_experts == 4
    with pytest.raises(ValueError, match="moe_experts"):
        train_llama.parse(["--mesh.ep=2", "--global_batch=4"])
    mcfg, cfg, seq, _ = train_llama.parse([
        "--model=llama3_8b", "--model.n_layers=1", "--model.vocab=32000",
        "--model.rope_theta=1000000", "--model.moe_experts=8",
        "--seq=4096", "--global_batch=4", "--mesh.dp=2", "--mesh.ep=2"])
    assert llama.num_params(mcfg) == 1_451_270_144 + 262_144_000 + 4096
    assert (cfg.mesh.ep, mcfg.moe.top_k, mcfg.moe.capacity_factor) == (
        2, 2, 2.0)


def test_serve_llama_moe_on_cpu():
    out = serve_llama.main([
        "--model=tiny", "--device=cpu", "--model.moe_experts=4",
        "--requests=4", "--prompt_min=4", "--prompt_max=12", "--max_new=3",
        "--max_reqs=3", "--page_size=4", "--max_pages_per_seq=8",
        "--n_pages=40", "--prefill_chunk=8"])
    assert out["requests"]["completed"] == 4
    _, _, cfg = serve_llama.parse(["--model.moe_experts=8",
                                   "--model.n_layers=8"])
    assert cfg.moe.num_experts == 8 and cfg.n_layers == 8
    with pytest.raises(ValueError, match="unknown LlamaConfig field"):
        serve_llama.parse(["--model.nope=1"])
