"""``train_llama --data=`` batches with sp and with MoE on the port
against the JAX package, on the CPU.

The text batches carry the global label count of each microbatch as a
third leaf (``models.bert.with_global_count``); with sp it replicates over
a dp rank's sequence shards and with ep over its ep ranks
(``VirtualRanks.shard_count``), and a MoE model's joint loss divides its
pooled CE by it.  The batches are ``text.lm_batches`` over a
``ByteTokenizer`` on a small text of short documents, so about a tenth of
the labels are -100 and the ranks' valid counts differ.  The same numpy
batches and JAX's ``init`` weights go through both packages:

- (a) the dense loss at dp = 2 x sp = 2 against JAX's ``loss_fn(sp_axis,
  dp_axis)`` under ``shard_map`` and against the unsharded loss (rtol
  1e-5: every JAX device's value is the global mean, the port's dp ranks
  average to it);
- (b) the MoE joint loss at dp = 2 x ep = 2 and dp = 2 x sp = 2 x ep = 2
  against JAX's ``loss_fn(dp_axis, ep_axis[, sp_axis])`` under
  ``shard_map`` (rtol 1e-5), and bit-equal with and without the count;
- (c) ``ShardedTrainer`` (``train_llama.build``) over dp x sp and dp x ep,
  at ``accum_steps`` 1 and 2, against unsharded JAX SGD steps on the same
  microbatches (rtol 5e-4, atol 5e-5: JAX's own sharded sp and ep
  trainers are red on this JAX, ROADMAP C.4, so the oracle is their
  contract, the single-device gradient of the global mean);
- (d) ``train_llama.main --data=`` with sp (and accumulation), with MoE
  over ep, and with MoE over ep and pp (``llama.pp_dp_loss_fn`` reading
  the count) on the CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from fpga_ai_nic_tpu import text as jax_text
from fpga_ai_nic_tpu.models import llama as jax_llama
from fpga_ai_nic_tpu_torch import train_llama
from fpga_ai_nic_tpu_torch.models import bert, llama
from fpga_ai_nic_tpu_torch.ops import fused_update
from fpga_ai_nic_tpu_torch.parallel.mesh import CountedBatch, VirtualRanks
from fpga_ai_nic_tpu_torch.parallel.sharded import split_ep
from fpga_ai_nic_tpu_torch.utils.config import (
    CollectiveConfig, MeshConfig, OptimizerConfig, TrainConfig)

JC = jax_llama.LlamaConfig.tiny(vocab=384, ffn_dim=64)
JC_MOE = dataclasses.replace(JC, moe_experts=4, moe_top_k=2,
                             moe_capacity_factor=16.0)
B, S = 8, 32
LOSS_RTOL = 1e-5            # f32 sums over the same tokens in other orders
TRAIN_TOL = dict(rtol=5e-4, atol=5e-5)   # the sharded trainer tests' limit


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Short documents (blank-line separated): each starts a -100 label."""
    rng = np.random.default_rng(3)
    docs = [" ".join("".join(chr(97 + c) for c in rng.integers(0, 26, 4))
                     for _ in range(int(rng.integers(1, 5))))
            for _ in range(400)]
    path = tmp_path_factory.mktemp("data") / "docs.txt"
    path.write_text("\n\n".join(docs) + "\n")
    return str(path)


def _batches(path, count=2):
    stream = jax_text.lm_batches(path, jax_text.ByteTokenizer(),
                                 batch_size=B, seq_len=S, seed=0,
                                 epochs=None)
    out = [next(stream) for _ in range(count)]
    for _, labels in out:
        valid = (labels >= 0).reshape(4, -1).sum(axis=1)
        assert (labels < 0).any() and len(set(valid.tolist())) > 1
    return out


def _params(jc, seed=0):
    return jax.tree_util.tree_map(
        np.asarray, jax_llama.init(jax.random.PRNGKey(seed), jc))


def _pc(jc):
    return llama.LlamaConfig(**jc.__dict__)


def _jax_sharded_loss(jc, params, batch, dp, sp, ep):
    """JAX's ``loss_fn`` on every device of a (dp, sp, ep) mesh under
    ``shard_map`` (``check_vma=False``), the batch at ``P(("dp", "ep"),
    "sp")``, the experts at ``param_specs(ep_axis="ep")``."""
    mesh = Mesh(np.asarray(jax.devices()[:dp * sp * ep]).reshape(dp, sp, ep),
                ("dp", "sp", "ep"))
    ep_axis = "ep" if ep > 1 else None
    spec = P(("dp", "ep"), "sp")
    f = jax.jit(jax.shard_map(
        lambda p, b: jax_llama.loss_fn(
            p, b, jc, sp_axis="sp" if sp > 1 else None, dp_axis="dp",
            ep_axis=ep_axis)[None],
        mesh=mesh, in_specs=(jax_llama.param_specs(jc, tp_axis=None,
                                                   ep_axis=ep_axis),
                             (spec, spec)),
        out_specs=P(("dp", "sp", "ep")), check_vma=False))
    return np.asarray(f(params, tuple(map(jnp.asarray, batch))))


def _counted(batch, dp, accum=1, ep=1):
    return bert.with_global_count(tuple(map(torch.from_numpy, batch)), dp,
                                  accum, ep)


# -- (a) the dense loss with sp -----------------------------------------------

def test_sp_masked_loss_matches_jax_shard_map(corpus):
    batch = _batches(corpus, 1)[0]
    params = _params(JC)
    want = _jax_sharded_loss(JC, params, batch, 2, 2, 1)
    assert np.all(want == want[0])
    full = float(jax_llama.loss_fn(params, tuple(map(jnp.asarray, batch)),
                                   JC))
    np.testing.assert_allclose(want[0], full, rtol=LOSS_RTOL)
    ranks = VirtualRanks(2, torch.device("cpu"), sp=2)
    tb = ranks.shard_batch(_counted(batch, 2))
    assert tb[0].shape == (2, 2, B // 2, S // 2) and tb[2].shape == (2, 1)
    assert int(tb[2][0, 0]) == int((batch[1] >= 0).sum())
    tree = llama.params_from_jax(params, "cpu")
    per_rank = [float(llama.loss_fn(tree, tuple(b[d] for b in tb), _pc(JC),
                                    sp_axis="sp", dp_size=2))
                for d in range(2)]
    # n_dp * local_sum / count a rank: JAX's dp_axis weighting, whose mean
    # over the dp ranks is the global value
    assert per_rank[0] != per_rank[1]
    np.testing.assert_allclose(np.mean(per_rank), want[0], rtol=LOSS_RTOL)


# -- (b) the MoE joint loss ---------------------------------------------------

@pytest.mark.parametrize("dp,sp,ep", [(2, 1, 2), (2, 2, 2)])
def test_moe_masked_loss_matches_jax_shard_map(corpus, dp, sp, ep):
    batch = _batches(corpus, 1)[0]
    params = _params(JC_MOE, 1)
    want = _jax_sharded_loss(JC_MOE, params, batch, dp, sp, ep)
    assert np.all(want == want[0])
    pc = _pc(JC_MOE)
    trees = split_ep(llama.params_from_jax(params, "cpu"),
                     llama.param_specs(pc), ep)
    ranks = VirtualRanks(dp, torch.device("cpu"), sp, ep)
    tb = ranks.shard_batch(_counted(batch, dp, ep=ep))
    assert tb[2].shape == (dp, ep, 1)
    assert (tb[2] == int((batch[1] >= 0).sum())).all()
    loss = llama.dp_loss_fn(pc, dp, ep, n_sp=sp)
    per_rank = [trees[e] for e in range(ep) for _ in range(dp)]
    with_count = loss(per_rank, tb)
    np.testing.assert_allclose(with_count.detach().numpy(),
                               np.full(dp * ep, want[0]), rtol=LOSS_RTOL)
    # the count leaf is the labels the call pools: the same bits
    assert torch.equal(with_count, loss(per_rank, tb[:2]))


# -- (c) the trainer ----------------------------------------------------------

def _ref_steps(jc, tree, batches, dp, ep, accum):
    """Unsharded SGD steps (lr 0.1): a step's gradient the mean over its
    microbatches of the gradient of the global mean loss, microbatch k
    the k-th part of every (dp, ep) rank's rows."""
    ranks = dp * ep
    for toks, labels in batches:
        rows = np.arange(B).reshape(ranks, accum, -1)
        acc = None
        for k in range(accum):
            idx = rows[:, k].reshape(-1)
            mb = (jnp.asarray(toks[idx]), jnp.asarray(labels[idx]))
            g = jax.grad(lambda p: jax_llama.loss_fn(p, mb, jc))(tree)
            acc = g if acc is None else jax.tree_util.tree_map(
                jnp.add, acc, g)
        tree = jax.tree_util.tree_map(
            lambda w, gg: (w.astype(jnp.float32)
                           - 0.1 * (gg / accum).astype(jnp.float32)
                           ).astype(w.dtype), tree, acc)
    return tree


@pytest.mark.parametrize("moe,dp,sp,ep,accum", [
    (False, 2, 2, 1, 1), (False, 2, 2, 1, 2),
    (True, 2, 1, 2, 1), (True, 2, 1, 2, 2)])
def test_data_trainer_matches_unsharded(corpus, moe, dp, sp, ep, accum):
    jc = JC_MOE if moe else JC
    pc = _pc(jc)
    batches = _batches(corpus, 2)
    params = _params(jc, 2)
    want = _ref_steps(jc, params, batches, dp, ep, accum)
    cfg = TrainConfig(global_batch=B, accum_steps=accum,
                      mesh=MeshConfig(dp=dp, sp=sp, ep=ep),
                      collective=CollectiveConfig(impl="xla"),
                      optimizer=OptimizerConfig(kind="sgd",
                                                learning_rate=0.1))
    tr, _ = train_llama.build(pc, cfg, "cpu", dp_size=dp)
    state = tr.init_state(llama.params_from_jax(params, "cpu"))
    losses = []
    for b in batches:
        state, loss = tr.step(state, tr.shard_batch(
            _counted(b, dp, accum, ep)))
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    got = fused_update.tree_leaves(tr.global_params(state))
    for g, w in zip(got, jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g.detach().float().numpy(),
                                   np.asarray(w, np.float32), **TRAIN_TOL)


# -- (d) the driver -----------------------------------------------------------

@pytest.mark.parametrize("flags", [
    ["--mesh.sp=2", "--accum_steps=2", "--seq=256", "--global_batch=4"],
    ["--model.moe_experts=4", "--model.moe_top_k=2", "--mesh.ep=2",
     "--seq=32", "--global_batch=8"],
    ["--model.moe_experts=4", "--model.moe_top_k=2", "--mesh.ep=2",
     "--mesh.pp=2", "--microbatches=2", "--seq=32", "--global_batch=8"]],
    ids=["sp_accum", "moe_ep", "moe_ep_pp"])
def test_train_llama_data_sp_and_moe_on_cpu(corpus, flags):
    """sp shards are whole 128-token blocks (the driver's rule)."""
    out = train_llama.main([
        "--model=tiny", "--device=cpu", "--model.vocab=384",
        "--model.ffn_dim=64", "--mesh.dp=2", "--iters=2",
        f"--data={corpus}"] + flags)
    assert np.isfinite(out["losses"]).all() and len(out["losses"]) == 3
    assert 0 < out["data"]["masked_share"] < 0.5


def test_only_the_marked_count_leaf_replicates():
    """``shard_batch`` reads the count leaf from the batch's type
    (``CountedBatch``), never from a leaf's shape or dtype: an unmarked
    1-D int64 leaf under ep is per-example rows, split like the others."""
    ranks = VirtualRanks(2, torch.device("cpu"), ep=2)
    toks = torch.arange(8 * 4).reshape(8, 4)
    labels = torch.arange(8, dtype=torch.int64)
    plain = ranks.shard_batch((toks, labels))
    assert plain[1].shape == (2, 2, 2)
    assert torch.equal(plain[1].reshape(-1), labels)
    counted = ranks.shard_batch(bert.with_global_count((toks, toks), 2,
                                                       ep=2))
    assert isinstance(bert.with_global_count((toks, toks), 2), CountedBatch)
    assert counted[2].shape == (2, 2, 1) and (counted[2] == 32).all()
