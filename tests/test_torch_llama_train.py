"""The port's Llama training path against the JAX package.

``loss_fn`` and its gradients on ``LlamaConfig.tiny`` with
``attn_block=128`` (weights carried across by ``params_from_jax``) against
JAX's ``llama.loss_fn`` with the Pallas kernels in interpret mode and with
the checkpointed XLA route; then ``ShardedTrainer`` at dp=2 for two steps:

- with ``impl="xla"`` against JAX's own ``ShardedTrainer`` on the CPU
  mesh;
- with the slice's configuration (ring, BFP sublane codec, fused ring
  kernels, SGD) against the composition the JAX package defines for it:
  JAX's ``ShardedTrainer`` cannot run that configuration on the CPU (the
  Pallas codec in interpret mode fails the varying-axes check of its
  gradient ``shard_map``), so per-rank ``jax.grad`` feeds
  ``ring_golden.ring_reduce_scatter(layout="sublane")``, the division by
  n, ``optim.apply``'s SGD and the quantize-once gather of ``bfp_golden``.

Inputs are f32 and seeded; tolerances are stated at each check.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import jax
import jax.numpy as jnp

from fpga_ai_nic_tpu.models import llama as jax_llama
from fpga_ai_nic_tpu.ops import bfp_golden as jax_bfp_golden
from fpga_ai_nic_tpu.ops import ring_golden as jax_ring_golden
from fpga_ai_nic_tpu.parallel import ShardedTrainer as JaxShardedTrainer
from fpga_ai_nic_tpu.parallel import make_mesh
from fpga_ai_nic_tpu.utils import config as jcfg
from fpga_ai_nic_tpu_torch import train_llama
from fpga_ai_nic_tpu_torch.models import llama
from fpga_ai_nic_tpu_torch.ops import fused_update
from fpga_ai_nic_tpu_torch.parallel.mesh import VirtualRanks
from fpga_ai_nic_tpu_torch.parallel.sharded import ShardedTrainer
from fpga_ai_nic_tpu_torch.utils.config import (
    BFPConfig, CollectiveConfig, MeshConfig, OptimizerConfig, TrainConfig)

N, BATCH, SEQ, LR = 2, 4, 128, 0.1
JCFG = dataclasses.replace(jax_llama.LlamaConfig.tiny(), attn_block=128)
CFG = dataclasses.replace(llama.LlamaConfig.tiny(), attn_block=128)


def _tokens(seed=0, B=BATCH):
    toks = np.random.default_rng(seed).integers(
        0, CFG.vocab, (B, SEQ + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def _jax_params(seed=0):
    return jax.tree_util.tree_map(
        np.asarray, jax_llama.init(jax.random.PRNGKey(seed), JCFG))


def _flat(tree):
    return np.concatenate([np.asarray(v, np.float32).reshape(-1)
                           for v in jax.tree_util.tree_leaves(tree)])


def _jax_value_grad(params, batch, impl):
    c = dataclasses.replace(JCFG, attn_impl=impl)
    loss, g = jax.value_and_grad(
        lambda p: jax_llama.loss_fn(p, batch, c))(params)
    return float(loss), _flat(g)


def _port_value_grad(params, batch, impl):
    c = dataclasses.replace(CFG, attn_impl=impl)
    tree = llama.params_from_jax(params, "cpu")
    leaves = [t.requires_grad_() for t in fused_update.tree_leaves(tree)]
    loss = llama.loss_fn(tree, tuple(torch.from_numpy(b) for b in batch), c)
    g = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), torch.cat([x.reshape(-1) for x in g]).numpy()


@pytest.mark.parametrize("port_impl", ["pallas", "xla"])
@pytest.mark.parametrize("jax_impl", ["pallas", "xla"])
def test_loss_and_grads_match_jax(port_impl, jax_impl):
    """Loss at rtol 1e-5 and the gradient norm at rtol 1e-4
    (``test_flash_pallas.py``'s llama parity limits); elementwise, every
    gradient within 1e-4 of the largest one plus 1e-3 relative: f32 sums
    in other orders through two layers, the log-softmax and the
    embedding's scatter-add."""
    params = _jax_params()
    batch = _tokens()
    l_ref, g_ref = _jax_value_grad(params, tuple(map(jnp.asarray, batch)),
                                   jax_impl)
    l_got, g_got = _port_value_grad(params, batch, port_impl)
    np.testing.assert_allclose(l_got, l_ref, rtol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(g_got), np.linalg.norm(g_ref),
                               rtol=1e-4)
    np.testing.assert_allclose(g_got, g_ref, rtol=1e-3,
                               atol=1e-4 * np.abs(g_ref).max())


def test_apply_gqa_routes_agree():
    """Grouped K/V to the flash route and repeated K/V to the torch paths
    give the same logits (f32, 1e-5)."""
    params = llama.params_from_jax(_jax_params(1), "cpu")
    toks = torch.from_numpy(_tokens(1)[0])
    out = {impl: llama.apply(params, toks, dataclasses.replace(
        CFG, attn_impl=impl)) for impl in ("pallas", "xla")}
    full = llama.apply(params, toks, dataclasses.replace(CFG,
                                                         attn_block=None))
    torch.testing.assert_close(out["pallas"], out["xla"], rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(full, out["xla"], rtol=1e-5, atol=1e-5)


def _port_trainer(coll):
    cfg = TrainConfig(global_batch=BATCH, mesh=MeshConfig(dp=N),
                      collective=coll,
                      optimizer=OptimizerConfig(kind="sgd", learning_rate=LR))
    c = dataclasses.replace(CFG, attn_impl="pallas")
    return ShardedTrainer(lambda p, b: llama.loss_fn(p, b, c),
                          VirtualRanks(N, torch.device("cpu")), cfg)


def test_sharded_trainer_xla_matches_jax_sharded_trainer():
    """impl="xla" (exact sums): two steps against JAX's ShardedTrainer on
    the CPU mesh — losses at rtol 1e-5, masters and working weights
    within 1e-6 absolute (f32 gradients differing in the last bits,
    times lr)."""
    params = _jax_params(2)
    jc = jcfg.TrainConfig(global_batch=BATCH, mesh=jcfg.MeshConfig(dp=N),
                          collective=jcfg.CollectiveConfig(impl="xla"),
                          optimizer=jcfg.OptimizerConfig(kind="sgd",
                                                         learning_rate=LR))
    c = dataclasses.replace(JCFG, attn_impl="xla")
    jtr = JaxShardedTrainer(
        lambda p, b: jax_llama.loss_fn(p, b, c, dp_axis="dp"),
        make_mesh(jc.mesh), jc, jax_llama.param_specs(c, tp_axis=None))
    jst = jtr.init_state(jax.tree_util.tree_map(jnp.asarray, params))
    tr = _port_trainer(CollectiveConfig(impl="xla"))
    st = tr.init_state(llama.params_from_jax(params, "cpu"))
    for step in range(2):
        toks, labels = _tokens(10 + step)
        jst, jl = jtr.step(jst, jtr.shard_batch((jnp.asarray(toks),
                                                 jnp.asarray(labels))))
        st, loss = tr.step(st, tr.shard_batch((torch.from_numpy(toks),
                                               torch.from_numpy(labels))))
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
        np.testing.assert_allclose(st.w_own.numpy().reshape(-1)[:_flat(
            params).size], _flat(jst.params), rtol=0, atol=1e-6)
    np.testing.assert_allclose(st.replicas[1].numpy()[:_flat(params).size],
                               _flat(jst.params), rtol=0, atol=1e-6)


def test_sharded_trainer_slice_config_matches_jax_composition():
    """The slice's collective (BFP ring, fused ring kernels' route): two
    steps.  Losses at rtol 1e-5; masters within lr * 2^-6 * max|g| per
    step — where torch's and XLA's gradients straddle a BFP rounding
    boundary one grid step (2^-6 of a block max) can flip, and the
    division by n keeps it below max|g|."""
    coll = CollectiveConfig(impl="ring", compression=BFPConfig(
        codec="pallas"), fused_kernel=True)
    tr = _port_trainer(coll)
    params = _jax_params(3)
    st = tr.init_state(llama.params_from_jax(params, "cpu"))
    L_pad = N * st.w_own.shape[1]
    assert L_pad % (N * 16 * 128) == 0
    w_ref = np.pad(_flat(params), (0, L_pad - _flat(params).size))
    w_ref = w_ref.reshape(N, -1)
    p_ref, atol = params, 0.0
    jaxc = dataclasses.replace(JCFG, attn_impl="xla")
    vg = jax.jit(jax.value_and_grad(
        lambda p, b: jax_llama.loss_fn(p, b, jaxc)))
    for step in range(2):
        toks, labels = _tokens(20 + step)
        rows, losses = [], []
        for i in range(N):
            sl = slice(i * BATCH // N, (i + 1) * BATCH // N)
            loss_i, g = vg(p_ref, (jnp.asarray(toks[sl]),
                                   jnp.asarray(labels[sl])))
            rows.append(np.pad(_flat(g), (0, L_pad - _flat(g).size)))
            losses.append(np.float32(loss_i))
        flat_g = np.stack(rows)
        g_sum = jax_ring_golden.ring_reduce_scatter(
            flat_g, jcfg.BFPConfig(), "sublane")
        w_ref = w_ref - np.float32(LR) * (g_sum / np.float32(N))
        q = np.concatenate([jax_bfp_golden.bfp_decode(
            *jax_bfp_golden.bfp_encode(w, layout="sublane"),
            layout="sublane") for w in w_ref])
        st, loss = tr.step(st, tr.shard_batch((torch.from_numpy(toks),
                                               torch.from_numpy(labels))))
        np.testing.assert_allclose(float(loss), np.mean(losses), rtol=1e-5)
        atol += LR * 2.0 ** -6 * float(np.abs(flat_g).max())
        np.testing.assert_allclose(st.w_own.numpy(), w_ref, rtol=0,
                                   atol=atol)
        leaves, treedef = jax.tree_util.tree_flatten(p_ref)
        out, off = [], 0
        for leaf in leaves:
            out.append(q[off:off + leaf.size].reshape(leaf.shape))
            off += leaf.size
        p_ref = jax.tree_util.tree_unflatten(treedef, out)
    reps = st.replicas.numpy()
    assert st.step == 2 and (reps == reps[0]).all()


def test_driver_runs_on_cpu():
    out = train_llama.main([
        "--model=tiny", "--device=cpu", "--model.attn_block=128",
        "--seq=128", "--global_batch=4", "--mesh.dp=2", "--iters=2",
        "--collective.impl=ring", "--collective.compression.codec=pallas",
        "--collective.fused_kernel=true"])
    assert np.isfinite(out["loss_first"]) and np.isfinite(out["loss_last"])
    assert out["params"] == llama.num_params(CFG)
    assert out["mesh"]["dp"] == 2 and out["device"] == "cpu"
    mcfg, cfg, seq, device = train_llama.parse(
        ["--model=llama3_8b", "--model.n_layers=4", "--model.attn_block=512",
         "--seq=4096", "--mesh.dp=2"])
    assert (mcfg.n_layers, mcfg.attn_block, mcfg.dim, seq, device) == (
        4, 512, 4096, 4096, "cuda")
    assert llama.num_params(mcfg) == 1_923_125_248
    with pytest.raises(ValueError, match="unknown LlamaConfig field"):
        train_llama.parse(["--model.nope=1"])


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        train_llama.main(["--iters=1", "--global_batch=2"])


def test_unported_options_raise():
    params = llama.params_from_jax(_jax_params(), "cpu")
    toks = torch.from_numpy(_tokens()[0])
    batch = (toks, toks)
    # remat is ported (tests/test_torch_remat.py): same value as without
    assert torch.equal(llama.loss_fn(params, batch, CFG, remat=True),
                       llama.loss_fn(params, batch, CFG))
    with pytest.raises(NotImplementedError, match="dp_axis"):
        llama.loss_fn(params, batch, CFG, dp_axis="dp")
    # tp_axis (ported: tests/test_torch_tp.py) takes the tp ranks' trees
    with pytest.raises(ValueError, match="tp ranks' trees"):
        llama.loss_fn(params, batch, CFG, tp_axis="tp")
    # ep_axis (ported with MoE, tests/test_torch_moe.py) takes the ep
    # ranks' trees and [n_ep, B, S] tokens: one tree is refused
    with pytest.raises(ValueError, match="ep ranks' trees"):
        llama.loss_fn(params, batch, CFG, ep_axis="ep")
    # sp_axis (ported with sequence parallelism): the loss over the two
    # stacked sequence shards is the whole sequence's (f32, rtol 1e-5;
    # tests/test_torch_sp.py holds it against JAX's sp loss)
    shards = tuple(t.reshape(BATCH, 2, SEQ // 2).transpose(0, 1)
                   for t in batch)
    np.testing.assert_allclose(
        float(llama.loss_fn(params, shards, CFG, sp_axis="sp")),
        float(llama.loss_fn(params, batch, CFG)), rtol=1e-5)
    with pytest.raises(ValueError, match="n_sp"):
        llama.loss_fn(params, batch, CFG, sp_axis="sp")
    ranks = VirtualRanks(2, torch.device("cpu"))
    # pp with tp is ported (tests/test_torch_pp_tp.py): the trainer builds
    pptp = MeshConfig(dp=2, tp=2, pp=2)
    tr = ShardedTrainer(lambda p, b: None, VirtualRanks(
        2, torch.device("cpu"), pp=2, tp=2), TrainConfig(mesh=pptp),
        param_specs=llama.stacked_param_specs(CFG, tp_axis="tp", tp_size=2))
    assert tr.n_shards == 4
    # accumulation is ported (tests/test_torch_accum.py)
    assert ShardedTrainer(lambda p, b: None, ranks, TrainConfig(
        mesh=MeshConfig(dp=2), accum_steps=2)).cfg.accum_steps == 2
    # as the JAX package's: integrity checks are DPTrainer's
    with pytest.raises(ValueError, match="DPTrainer only"):
        ShardedTrainer(lambda p, b: None, ranks, TrainConfig(
            mesh=MeshConfig(dp=2), collective=CollectiveConfig(
                impl="ring", integrity_check=True)))
    # loss_and_grads_fn without pp is ported
    # (tests/test_torch_explicit_grads.py): the trainer builds
    assert ShardedTrainer(None, ranks, TrainConfig(mesh=MeshConfig(dp=2)),
                          loss_and_grads_fn=lambda p, b: None
                          ).loss_and_grads_fn is not None


class _F32ReplicaTrainer(ShardedTrainer):
    """The route before the replicas moved to the model dtype: f32
    replicas, each rank's leaves cast to bf16 every step."""

    def _working(self, flat):
        return flat, None          # (replicas, no side leaves)


@pytest.mark.parametrize("coll", [
    CollectiveConfig(impl="xla"),
    CollectiveConfig(impl="ring", compression=BFPConfig(codec="pallas"),
                     fused_kernel=True)], ids=["xla", "bfp_ring"])
def test_bf16_replicas_bitequal_to_f32_replica_route(coll):
    """A bf16 model keeps its working replicas in bf16 (cast once after
    the all-gather, as JAX's gather casts); three steps give losses,
    masters and working params bit-equal to the f32-replica route's on the
    same seed: the cast is elementwise, so where it happens changes no
    value the model sees."""
    c = dataclasses.replace(CFG, dtype="bfloat16", attn_impl="xla")
    cfg = TrainConfig(global_batch=BATCH, mesh=MeshConfig(dp=N),
                      collective=coll,
                      optimizer=OptimizerConfig(kind="sgd", learning_rate=LR))
    ranks = VirtualRanks(N, torch.device("cpu"))
    params = llama.init(torch.Generator().manual_seed(4), c, "cpu")
    runs = []
    for cls in (ShardedTrainer, _F32ReplicaTrainer):
        tr = cls(lambda p, b: llama.loss_fn(p, b, c), ranks, cfg)
        st = tr.init_state(params)
        losses = []
        for step in range(3):
            toks, labels = _tokens(30 + step)
            st, loss = tr.step(st, tr.shard_batch((torch.from_numpy(toks),
                                                   torch.from_numpy(labels))))
            losses.append(float(loss))
        runs.append((st, losses))
    (new, l_new), (old, l_old) = runs
    assert new.replicas.dtype == torch.bfloat16
    assert old.replicas.dtype == torch.float32
    assert l_new == l_old
    assert torch.equal(new.w_own, old.w_own)
    for a, b in zip(fused_update.tree_leaves(new.params),
                    fused_update.tree_leaves(old.params)):
        assert a.dtype == b.dtype == torch.bfloat16
        assert torch.equal(a, b)
    assert torch.equal(new.replicas[1],
                       old.replicas[1].to(torch.bfloat16))
