"""``ShardedTrainer(loss_and_grads_fn=)`` without pp on the port against
the JAX package, on the CPU.

At pp = 1 the trainer calls JAX's explicit-gradient hook,
``loss_and_grads_fn(params, batch) -> (loss, grads)``, a dp rank at a time
(or once over every rank, marked ``joint_ranks``) where it would run
autograd; the reduce-scatter, the update and the gather are unchanged.
The function here is autograd of the Llama loss written out as a function
on both sides:

- (a) two steps at dp = 2 (impl "xla": exact sums) against JAX's
  ``ShardedTrainer`` with the same function: losses at rtol 1e-5, masters
  and working weights within 1e-6 absolute (the sharded Llama tests'
  limit: f32 gradients differing in the last bits, times lr);
- (b) bit-equal to the port's own autograd route, under impl "xla" and
  the BFP ring route of the fused kernels (their plain versions here);
- (c) a MoE model over dp = 2 x ep = 2 through a ``joint_ranks`` function
  bit-equal to the autograd route, the ep sums included;
- (d) the refusal that stays: ``accum_steps > 1``, as JAX's.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import jax
import jax.numpy as jnp

from fpga_ai_nic_tpu.models import llama as jax_llama
from fpga_ai_nic_tpu.parallel import ShardedTrainer as JaxShardedTrainer
from fpga_ai_nic_tpu.parallel import make_mesh
from fpga_ai_nic_tpu.utils import config as jcfg
from fpga_ai_nic_tpu_torch.models import llama
from fpga_ai_nic_tpu_torch.ops import fused_update
from fpga_ai_nic_tpu_torch.parallel.mesh import VirtualRanks, make_ranks
from fpga_ai_nic_tpu_torch.parallel.sharded import ShardedTrainer
from fpga_ai_nic_tpu_torch.utils.config import (
    BFPConfig, CollectiveConfig, MeshConfig, OptimizerConfig, TrainConfig)

N, BATCH, SEQ, LR = 2, 4, 64, 0.1
JCFG = dataclasses.replace(jax_llama.LlamaConfig.tiny(), attn_impl="xla")
CFG = llama.LlamaConfig(**JCFG.__dict__)
JMOE = dataclasses.replace(
    jax_llama.LlamaConfig.tiny(ffn_dim=64), moe_experts=4, moe_top_k=2,
    moe_capacity_factor=16.0)
MOE = llama.LlamaConfig(**JMOE.__dict__)
MASTER_ATOL = 1e-6
BFP_RING = CollectiveConfig(impl="ring", compression=BFPConfig(codec="pallas"),
                            fused_kernel=True, fused_optimizer=True)


def _tokens(seed, B=BATCH, vocab=CFG.vocab):
    toks = np.random.default_rng(seed).integers(
        0, vocab, (B, SEQ + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def _jax_params(cfg, seed=0):
    return jax.tree_util.tree_map(
        np.asarray, jax_llama.init(jax.random.PRNGKey(seed), cfg))


def _flat(tree):
    return np.concatenate([np.asarray(v, np.float32).reshape(-1)
                           for v in jax.tree_util.tree_leaves(tree)])


def _grads_of(loss_fn):
    """``(loss, grads)`` of ``loss_fn(tree, batch)`` by autograd, as an
    explicit-gradient function of one rank's tree."""
    def fn(params, batch):
        pairs = fused_update._leaves(params)
        leaves = [t.detach().requires_grad_() for _, t in pairs]
        keys = tuple(p for p, _ in pairs)
        loss = loss_fn(fused_update.tree_from_leaves(keys, leaves), batch)
        gs = torch.autograd.grad(loss, leaves)
        return loss.detach(), fused_update.tree_from_leaves(keys, list(gs))
    return fn


def _joint_grads_of(loss_fn):
    """The same for a ``joint_ranks`` loss: ``(losses [n], grads a tree a
    rank)``."""
    def fn(trees, batch):
        pairs = [fused_update._leaves(t) for t in trees]
        keys = tuple(p for p, _ in pairs[0])
        leaves = [[t.detach().requires_grad_() for _, t in ps]
                  for ps in pairs]
        losses = loss_fn([fused_update.tree_from_leaves(keys, ls)
                          for ls in leaves], batch)
        gs = torch.autograd.grad(losses.sum(),
                                 [t for ls in leaves for t in ls])
        k = len(keys)
        return losses.detach(), [fused_update.tree_from_leaves(
            keys, list(gs[i * k:(i + 1) * k])) for i in range(len(trees))]
    fn.joint_ranks = True
    return fn


def _port_trainer(coll, explicit):
    cfg = TrainConfig(global_batch=BATCH, mesh=MeshConfig(dp=N),
                      collective=coll,
                      optimizer=OptimizerConfig(kind="sgd", learning_rate=LR))
    loss = lambda p, b: llama.loss_fn(p, b, CFG)  # noqa: E731
    ranks = VirtualRanks(N, torch.device("cpu"))
    if explicit:
        return ShardedTrainer(None, ranks, cfg,
                              loss_and_grads_fn=_grads_of(loss))
    return ShardedTrainer(loss, ranks, cfg)


def _run(tr, params, seeds, vocab=CFG.vocab, B=BATCH):
    st = tr.init_state(params)
    losses = []
    for seed in seeds:
        toks, labels = _tokens(seed, B, vocab)
        st, loss = tr.step(st, tr.shard_batch((torch.from_numpy(toks),
                                               torch.from_numpy(labels))))
        losses.append(float(loss))
    return st, losses


def test_explicit_grads_match_jax_sharded_trainer():
    params = _jax_params(JCFG, 2)
    jc = jcfg.TrainConfig(global_batch=BATCH, mesh=jcfg.MeshConfig(dp=N),
                          collective=jcfg.CollectiveConfig(impl="xla"),
                          optimizer=jcfg.OptimizerConfig(kind="sgd",
                                                         learning_rate=LR))
    jloss = lambda p, b: jax_llama.loss_fn(p, b, JCFG,  # noqa: E731
                                           dp_axis="dp")
    jtr = JaxShardedTrainer(
        None, make_mesh(jc.mesh), jc, jax_llama.param_specs(
            JCFG, tp_axis=None),
        loss_and_grads_fn=lambda p, b: jax.value_and_grad(jloss)(p, b))
    jst = jtr.init_state(jax.tree_util.tree_map(jnp.asarray, params))
    tr = _port_trainer(CollectiveConfig(impl="xla"), explicit=True)
    st = tr.init_state(llama.params_from_jax(params, "cpu"))
    size = _flat(params).size
    for step in range(2):
        toks, labels = _tokens(10 + step)
        jst, jl = jtr.step(jst, jtr.shard_batch((jnp.asarray(toks),
                                                 jnp.asarray(labels))))
        st, loss = tr.step(st, tr.shard_batch((torch.from_numpy(toks),
                                               torch.from_numpy(labels))))
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
        np.testing.assert_allclose(st.w_own.numpy().reshape(-1)[:size],
                                   _flat(jst.params), rtol=0,
                                   atol=MASTER_ATOL)
    np.testing.assert_allclose(st.replicas[1].numpy()[:size],
                               _flat(jst.params), rtol=0, atol=MASTER_ATOL)


@pytest.mark.parametrize("coll", [CollectiveConfig(impl="xla"), BFP_RING],
                         ids=["xla", "bfp_ring"])
def test_explicit_grads_bitequal_to_autograd_route(coll):
    params = llama.params_from_jax(_jax_params(JCFG, 3), "cpu")
    got, lg = _run(_port_trainer(coll, True), params, (20, 21))
    want, lw = _run(_port_trainer(coll, False), params, (20, 21))
    assert lg == lw
    assert torch.equal(got.w_own, want.w_own)
    assert torch.equal(got.replicas, want.replicas)


def test_explicit_joint_grads_bitequal_with_ep():
    cfg = TrainConfig(global_batch=8, mesh=MeshConfig(dp=2, ep=2),
                      collective=CollectiveConfig(impl="xla"),
                      optimizer=OptimizerConfig(kind="sgd", learning_rate=LR))
    ranks = make_ranks(cfg.mesh, "cpu")
    specs = llama.param_specs(MOE)
    loss = llama.dp_loss_fn(MOE, 2, 2)
    params = llama.params_from_jax(_jax_params(JMOE, 4), "cpu")
    trs = {"explicit": ShardedTrainer(
        None, ranks, cfg, param_specs=specs,
        loss_and_grads_fn=_joint_grads_of(loss)),
        "autograd": ShardedTrainer(loss, ranks, cfg, param_specs=specs)}
    out = {k: _run(tr, params, (30, 31), MOE.vocab, 8)
           for k, tr in trs.items()}
    assert out["explicit"][1] == out["autograd"][1]
    assert np.isfinite(out["explicit"][1]).all()
    for a, b in ((out["explicit"][0].w_own, out["autograd"][0].w_own),
                 (out["explicit"][0].replicas, out["autograd"][0].replicas)):
        assert torch.equal(a, b)


def test_explicit_grads_refuse_accumulation():
    cfg = TrainConfig(global_batch=8, mesh=MeshConfig(dp=2), accum_steps=2,
                      collective=CollectiveConfig(impl="xla"))
    with pytest.raises(ValueError, match="accum_steps"):
        ShardedTrainer(None, make_ranks(cfg.mesh, "cpu"), cfg,
                       loss_and_grads_fn=_grads_of(None))
