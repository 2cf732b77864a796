"""Sequence parallelism on the port against the JAX package.

The port stacks the sp ranks as a leading dimension (q [n, B, H, Sl, dh],
tokens [n_sp, B, Sl]); JAX runs them as devices of a ``shard_map`` over
the 8 CPU devices.  The same seeded numpy inputs go through both:

- (a) the flash plain versions with q/k offsets against
  ``flash_pallas._flash4`` in interpret mode, forward and q/k/v grads, at
  a past hop, the diagonal, the gathered shape, an offset difference that
  is not a multiple of 64 and a chunk wholly in the future;
- (b) the ``with_lse=True`` entry's gradients for a loss that uses lse;
- (c) ``ring_flash_attention``, ``ring_attention`` and
  ``gathered_attention`` at n = 2 and 4, MHA and GQA, causal or not;
- (d) the Llama ``loss_fn`` at sp = 2 and 4 against JAX's under
  ``shard_map`` and against JAX's unsharded loss and ``jax.grad``;
- (e) ``ShardedTrainer`` at dp = 2 x sp = 2 against two unsharded JAX
  SGD steps (JAX's own sp trainer fails its varying-axes check on this
  JAX, ROADMAP C.4, so the oracle is its contract: the same weights as
  one device);
- (f) the ``P(dp, sp)`` batch layout and the sp positions;
- (g) ``train_llama.main`` with ``--mesh.sp=2`` on the CPU.

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
from fpga_ai_nic_tpu.ops import flash_pallas
from fpga_ai_nic_tpu.ops import ring_attention as jax_ra
from fpga_ai_nic_tpu.parallel import mesh as jax_mesh
from fpga_ai_nic_tpu_torch import train_llama
from fpga_ai_nic_tpu_torch.models import llama
from fpga_ai_nic_tpu_torch.ops import flash_attention as fa
from fpga_ai_nic_tpu_torch.ops import fused_update
from fpga_ai_nic_tpu_torch.ops import ring_attention as ra
from fpga_ai_nic_tpu_torch.parallel.mesh import VirtualRanks, make_ranks
from fpga_ai_nic_tpu_torch.parallel.sharded import ShardedTrainer
from fpga_ai_nic_tpu_torch.utils.config import (
    CollectiveConfig, MeshConfig, OptimizerConfig, TrainConfig)

FWD_TOL = dict(atol=2e-5, rtol=2e-5)    # test_offsets_match_sliced_full_...
GRAD_TOL = dict(atol=5e-5, rtol=5e-4)   # the flash tests' gradient limit
RING_FWD_TOL = dict(atol=3e-5, rtol=3e-5)   # test_sp_impl_routing_parity
RING_GRAD_TOL = dict(atol=1e-4, rtol=1e-3)  # TestRingFlash.test_grads_...


def _qkv(seed, B, H, Hkv, Sq, Sk, dh):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, Sq, dh)).astype(np.float32),
            rng.standard_normal((B, Hkv, Sk, dh)).astype(np.float32),
            rng.standard_normal((B, Hkv, Sk, dh)).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


# -- (a), (b): the offset channel ----------------------------------------------

# name: (Sq, Sk, q_offset, k_offset)
OFFSET_CASES = {
    "past_hop": (256, 256, 256, 0),
    "diagonal": (256, 256, 256, 256),
    "gathered": (128, 512, 256, 0),        # k tiles past 383 see nothing
    "not_a_tile_multiple": (256, 256, 100, 0),
    "future_chunk": (256, 256, 0, 256),    # out 0, lse -1e30, no gradient
}


def _jax_flash(q, k, v, q_offset, k_offset, causal=True):
    return flash_pallas._flash4(q, k, v, q_offset, k_offset, None, causal,
                                128, 128, True, with_lse=True)


@pytest.mark.parametrize("case", sorted(OFFSET_CASES))
def test_offsets_plain_match_pallas(case):
    """Forward (out and lse) within 2e-5 and the q/k/v gradients of a
    random output cotangent within atol 5e-5 / rtol 5e-4 of JAX's Pallas
    kernels in interpret mode, GQA (H=4, Hkv=2, dh=64)."""
    Sq, Sk, qo, ko = OFFSET_CASES[case]
    q, k, v = _qkv(11, 1, 4, 2, Sq, Sk, 64)
    (out, lse), vjp = jax.vjp(lambda *a: _jax_flash(*a, qo, ko),
                              *map(jnp.asarray, (q, k, v)))
    do = np.random.default_rng(12).standard_normal(out.shape).astype(
        np.float32)
    want = vjp((jnp.asarray(do), jnp.zeros_like(lse)))
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    got_out, got_lse = fa.flash_attention(tq, tk, tv, causal=True,
                                          q_offset=qo, k_offset=ko,
                                          block_k=128, with_lse=True)
    np.testing.assert_allclose(got_out.detach().numpy(), np.asarray(out),
                               **FWD_TOL)
    np.testing.assert_allclose(got_lse.detach().numpy(), np.asarray(lse),
                               **FWD_TOL)
    got = torch.autograd.grad(got_out, (tq, tk, tv),
                              torch.from_numpy(do))
    for a, b, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL,
                                   err_msg=f"d{name}")
    if case == "future_chunk":
        assert not got_out.detach().any()
        assert bool((got_lse == -1e30).all())
        assert all(not g.any() for g in got)


@pytest.mark.parametrize("case", ["past_hop", "diagonal", "gathered"])
def test_with_lse_gradients_match_pallas(case):
    """A loss of both outputs, sum(out * dO) + sum(lse * dL): the lse
    cotangent folds into delta; q/k/v gradients within atol 5e-5 / rtol
    5e-4 of JAX's ``_flash4(..., with_lse=True)`` vjp."""
    Sq, Sk, qo, ko = OFFSET_CASES[case]
    q, k, v = _qkv(13, 1, 4, 2, Sq, Sk, 64)
    (out, lse), vjp = jax.vjp(lambda *a: _jax_flash(*a, qo, ko),
                              *map(jnp.asarray, (q, k, v)))
    rng = np.random.default_rng(14)
    do = rng.standard_normal(out.shape).astype(np.float32)
    dl = rng.standard_normal(lse.shape).astype(np.float32)
    want = vjp((jnp.asarray(do), jnp.asarray(dl)))
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    o, l = fa.flash_attention(tq, tk, tv, q_offset=qo, k_offset=ko,
                              block_k=128, with_lse=True)
    loss = (o * torch.from_numpy(do)).sum() + (l * torch.from_numpy(dl)).sum()
    got = torch.autograd.grad(loss, (tq, tk, tv))
    for a, b, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL,
                                   err_msg=f"d{name}")


def test_offsets_change_nothing_without_causal():
    """Without ``causal`` the pair is ignored, as in the Pallas kernels."""
    q, k, v = _t(*_qkv(15, 1, 2, 2, 128, 256, 32))
    a = fa.flash_attention(q, k, v, causal=False)
    b = fa.flash_attention(q, k, v, causal=False, q_offset=0, k_offset=999)
    assert torch.equal(a, b)


# -- (c): ring and gathered attention over the stacked sp ranks ---------------

def _shard(t, n):
    """[B, h, n Sl, dh] -> [n, B, h, Sl, dh]: rank i's contiguous chunk."""
    B, h, S, dh = t.shape
    return t.reshape(B, h, n, S // n, dh).permute(2, 0, 1, 3, 4)


def _unshard(t):
    n, B, h, Sl, dh = t.shape
    return t.permute(1, 2, 0, 3, 4).reshape(B, h, n * Sl, dh)


def _jax_sp(fn, n):
    mesh = Mesh(np.array(jax.devices()[:n]), ("sp",))
    return jax.jit(jax.shard_map(fn, mesh=mesh,
                                 in_specs=P(None, None, "sp", None),
                                 out_specs=P(None, None, "sp", None),
                                 check_vma=False))


# variant: (JAX function of (q, k, v, causal), port function, grouped K/V)
SP_VARIANTS = {
    "ring_flash": (
        lambda q, k, v, c: flash_pallas.ring_flash_attention(
            q, k, v, "sp", causal=c, block_q=128, block_k=128,
            interpret=True),
        lambda q, k, v, c: fa.ring_flash_attention(
            q, k, v, "sp", causal=c, block_q=128, block_k=128), True),
    "ring_xla": (
        lambda q, k, v, c: jax_ra.ring_attention(q, k, v, "sp", causal=c,
                                                 impl="xla"),
        lambda q, k, v, c: ra.ring_attention(q, k, v, "sp", causal=c,
                                             impl="xla"), False),
    "gathered_pallas": (
        lambda q, k, v, c: jax_ra.gathered_attention(q, k, v, "sp",
                                                     causal=c,
                                                     impl="pallas"),
        lambda q, k, v, c: ra.gathered_attention(q, k, v, "sp", causal=c,
                                                 impl="pallas"), True),
    "gathered_xla": (
        lambda q, k, v, c: jax_ra.gathered_attention(q, k, v, "sp",
                                                     causal=c, impl="xla"),
        lambda q, k, v, c: ra.gathered_attention(q, k, v, "sp", causal=c,
                                                 impl="xla"), False),
}


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("heads", ["mha", "gqa"])
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("variant", sorted(SP_VARIANTS))
def test_sp_attention_matches_jax(variant, n, heads, causal):
    """Forward within atol/rtol 3e-5 and the q/k/v gradients of
    sum(o cos o) within atol 1e-4 / rtol 1e-3 of JAX's function under
    ``shard_map`` (the JAX tests' own limits).  The plain routes take
    repeat-expanded K/V (Hkv = H), as ``models/llama.py`` gives them."""
    jfn, pfn, grouped = SP_VARIANTS[variant]
    H, Hkv = (4, 2) if heads == "gqa" else (2, 2)
    q, k, v = _qkv(20 + n, 1, H, Hkv, n * 128, n * 128, 32)
    if not grouped:
        k, v = (np.repeat(t, H // Hkv, axis=1) for t in (k, v))

    def jloss(q, k, v):
        o = _jax_sp(lambda *a: jfn(*a, causal), n)(q, k, v)
        return jnp.sum(o * jnp.cos(o)), o

    (_, want), gw = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                       has_aux=True)(
        *map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    got = _unshard(pfn(*(_shard(t, n) for t in (tq, tk, tv)), causal))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **RING_FWD_TOL)
    gg = torch.autograd.grad((got * torch.cos(got)).sum(), (tq, tk, tv))
    for a, b, name in zip(gg, gw, "qkv"):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **RING_GRAD_TOL,
                                   err_msg=f"d{name}")


def test_ring_attention_routes_and_knobs():
    """"auto" on the CPU takes the plain ring, as JAX's off a TPU; the
    kernel ring gives the same attention (3e-5); pinned "pallas" rejects
    the plain ring's knobs, "auto" keeps the plain ring with them."""
    n = 2
    q, k, v = _t(*_qkv(30, 1, 2, 2, n * 128, n * 128, 32))
    sq, sk, sv = (_shard(t, n) for t in (q, k, v))
    auto = ra.ring_attention(sq, sk, sv, "sp")
    xla = ra.ring_attention(sq, sk, sv, "sp", impl="xla")
    assert torch.equal(auto, xla)
    kern = ra.ring_attention(sq, sk, sv, "sp", impl="pallas")
    torch.testing.assert_close(kern, xla, **RING_FWD_TOL)
    for kw in ({"unroll": True}, {"k_block": None}):
        with pytest.raises(ValueError, match="cannot honor"):
            ra.ring_attention(sq, sk, sv, "sp", impl="pallas", **kw)
        assert ra.ring_attention(sq, sk, sv, "sp", **kw).shape == xla.shape


# -- (d): the Llama loss over the sp stack ------------------------------------

SP_CFG = jax_llama.LlamaConfig.tiny(n_kv_heads=4)    # head_dim 16
PORT_SP_CFG = llama.LlamaConfig.tiny(n_kv_heads=4)


def _flat(tree):
    return np.concatenate([np.asarray(v, np.float32).reshape(-1)
                           for v in jax.tree_util.tree_leaves(tree)])


def _sp_batch(sp, seed=40, B=2, Sl=128):
    toks = np.random.default_rng(seed).integers(
        0, SP_CFG.vocab, (B, sp * Sl + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def _jax_sp_loss_grad(params, batch, sp, impl):
    """JAX's sp loss and gradient: ``loss_fn(sp_axis="sp")`` under
    ``shard_map`` over (dp=1, sp), the params replicated, as
    ``test_sp_attn_impl_parity`` runs it (``check_vma=False``: the Pallas
    interpreter fails the varying-axes check).  Each device's gradient is
    its share (the ring's permutes carry the cotangents between shards);
    their sum over sp is the gradient, as the varying-axes transposes
    psum it in JAX's trainer."""
    c = dataclasses.replace(SP_CFG, attn_impl=impl)
    mesh = Mesh(np.asarray(jax.devices()[:sp]).reshape(1, sp), ("dp", "sp"))

    def lg(p, b):
        loss, g = jax.value_and_grad(
            lambda p: jax_llama.loss_fn(p, b, c, sp_axis="sp"))(p)
        return loss[None], jax.tree_util.tree_map(lambda x: x[None], g)

    f = jax.jit(jax.shard_map(
        lg, mesh=mesh, in_specs=(P(), (P("dp", "sp"), P("dp", "sp"))),
        out_specs=(P(("dp", "sp")), P(("dp", "sp"))), check_vma=False))
    loss, g = f(params, tuple(map(jnp.asarray, batch)))
    loss = np.asarray(loss)
    assert np.all(loss == loss[0])          # every sp rank: the global mean
    return float(loss[0]), _flat(jax.tree_util.tree_map(
        lambda x: np.asarray(x).sum(0), g))


def _port_sp_loss_grad(params, batch, sp, impl):
    c = dataclasses.replace(PORT_SP_CFG, attn_impl=impl)
    tree = llama.params_from_jax(params, "cpu")
    leaves = [t.requires_grad_() for t in fused_update.tree_leaves(tree)]
    ranks = VirtualRanks(1, torch.device("cpu"), sp)
    toks, labels = (ranks.shard(torch.from_numpy(b))[0] for b in batch)
    loss = llama.loss_fn(tree, (toks, labels), c, sp_axis="sp")
    g = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), torch.cat([x.reshape(-1) for x in g]).numpy()


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("sp", [2, 4])
def test_llama_sp_loss_matches_jax(sp, impl):
    """Loss at rtol 1e-5 and gradient norm at rtol 1e-4 (the JAX sp
    parity test's limits), elementwise within 1e-3 relative plus 1e-4 of
    the largest gradient (``test_torch_llama_train.py``'s), against JAX's
    sp loss under ``shard_map`` and against JAX's unsharded loss and
    ``jax.grad`` on the whole sequence."""
    params = jax.tree_util.tree_map(
        np.asarray, jax_llama.init(jax.random.PRNGKey(3), SP_CFG))
    batch = _sp_batch(sp)
    l_got, g_got = _port_sp_loss_grad(params, batch, sp, impl)
    l_sp, g_sp = _jax_sp_loss_grad(params, batch, sp, impl)
    l_full, g_full = jax.value_and_grad(lambda p: jax_llama.loss_fn(
        p, tuple(map(jnp.asarray, batch)), SP_CFG))(params)
    for l_ref, g_ref in ((l_sp, g_sp), (float(l_full), _flat(g_full))):
        np.testing.assert_allclose(l_got, l_ref, rtol=1e-5)
        np.testing.assert_allclose(np.linalg.norm(g_got),
                                   np.linalg.norm(g_ref), rtol=1e-4)
        np.testing.assert_allclose(g_got, g_ref, rtol=1e-3,
                                   atol=1e-4 * np.abs(g_ref).max())


def test_llama_sp_gqa_stays_grouped_on_the_kernel_route(monkeypatch):
    """On the kernel route grouped K/V reach the ring (JAX's
    ``kernel_branch``); on the plain route they are repeated first."""
    seen = []
    orig = ra.ring_attention

    def spy(q, k, v, *a, **kw):
        seen.append((kw.get("impl"), q.shape[2], k.shape[2]))
        return orig(q, k, v, *a, **kw)

    monkeypatch.setattr(llama, "ring_attention", spy)
    params = llama.params_from_jax(jax.tree_util.tree_map(
        np.asarray, jax_llama.init(jax.random.PRNGKey(3),
                                   jax_llama.LlamaConfig.tiny())), "cpu")
    toks = VirtualRanks(1, torch.device("cpu"), 2).shard(
        torch.from_numpy(_sp_batch(2)[0]))[0]
    for impl in ("pallas", "xla"):
        llama.apply(params, toks, dataclasses.replace(
            llama.LlamaConfig.tiny(), attn_impl=impl), sp_axis="sp")
    assert seen[0] == ("pallas", 4, 2) and seen[2] == ("xla", 4, 4)


# -- (e): the dp x sp trainer against unsharded training -------------------------

@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_sharded_trainer_dp_sp_matches_unsharded(impl):
    """dp=2 x sp=2, two SGD steps (lr 0.1) against two unsharded JAX
    steps on the whole batch (``test_sharded_training_matches_unsharded``'s
    contract and tolerance: rtol 5e-4, atol 5e-5 on every weight)."""
    jc = dataclasses.replace(jax_llama.LlamaConfig.tiny(), attn_impl=impl)
    pc = dataclasses.replace(llama.LlamaConfig.tiny(), attn_impl=impl)
    params0 = jax_llama.init(jax.random.PRNGKey(5), jc)
    toks, labels = _sp_batch(2, seed=50, B=4)

    def ref_step(params):
        g = jax.grad(lambda p: jax_llama.loss_fn(
            p, (jnp.asarray(toks), jnp.asarray(labels)), jc))(params)
        return jax.tree_util.tree_map(
            lambda w, gg: (w.astype(jnp.float32)
                           - 0.1 * gg.astype(jnp.float32)).astype(w.dtype),
            params, g)

    want = ref_step(ref_step(params0))
    cfg = TrainConfig(global_batch=4, mesh=MeshConfig(dp=2, sp=2),
                      collective=CollectiveConfig(impl="xla"),
                      optimizer=OptimizerConfig(kind="sgd",
                                                learning_rate=0.1))
    tr = ShardedTrainer(lambda p, b: llama.loss_fn(p, b, pc, sp_axis="sp"),
                        make_ranks(cfg.mesh, "cpu"), cfg)
    state = tr.init_state(llama.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params0), "cpu"))
    batch = tr.shard_batch(tuple(map(torch.from_numpy, (toks, labels))))
    assert batch[0].shape == (2, 2, 2, 128)
    for _ in range(2):
        state, loss = tr.step(state, batch)
        assert np.isfinite(float(loss))
    got = [t.numpy() for t in fused_update.tree_leaves(state.params)]
    for g, w in zip(got, jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g, np.asarray(w, np.float32), rtol=5e-4,
                                   atol=5e-5)


def test_sp_on_unported_trainers_and_axes_raises():
    ranks = VirtualRanks(2, torch.device("cpu"), 2)
    cfg = TrainConfig(global_batch=4, mesh=MeshConfig(dp=2, sp=2))
    from fpga_ai_nic_tpu_torch.parallel.ddp import DDPTrainer
    from fpga_ai_nic_tpu_torch.parallel.train import DPTrainer
    for cls in (DPTrainer, DDPTrainer):
        with pytest.raises(NotImplementedError, match="ShardedTrainer"):
            cls(lambda p, b: None, ranks, cfg)
    with pytest.raises(ValueError, match="does not describe"):
        ShardedTrainer(lambda p, b: None, VirtualRanks(2, torch.device(
            "cpu")), cfg)
    # tp is ported (tests/test_torch_tp.py), and pp with tp
    # (tests/test_torch_pp_tp.py)
    assert make_ranks(MeshConfig(dp=2, tp=2, pp=2), "cpu").pp == 2
    # fsdp is ported (tests/test_torch_fsdp.py): FSDPTrainer runs the fsdp
    # axis alone, and the other trainers refuse it
    with pytest.raises(NotImplementedError, match="fsdp axis alone"):
        make_ranks(MeshConfig(dp=2, fsdp=2), "cpu")
    fr = make_ranks(MeshConfig(fsdp=2), "cpu")
    for cls in (DPTrainer, DDPTrainer, ShardedTrainer):
        with pytest.raises(NotImplementedError, match="FSDPTrainer"):
            cls(lambda p, b: None, fr, TrainConfig(
                global_batch=4, mesh=MeshConfig(fsdp=2)))
    # pp is ported (tests/test_torch_pp.py), and together with sp and ep
    # (tests/test_torch_pp_axes.py)
    assert make_ranks(MeshConfig(dp=2, pp=2), "cpu").pp == 2
    r = make_ranks(MeshConfig(dp=2, pp=2, sp=2, ep=2), "cpu")
    assert (r.n, r.pp, r.sp, r.ep) == (2, 2, 2, 2)
    # ep is ported (tests/test_torch_moe.py), and together with sp
    # (tests/test_torch_sp_ep.py)
    assert make_ranks(MeshConfig(dp=2, ep=2), "cpu").ep == 2
    r = make_ranks(MeshConfig(dp=2, sp=2, ep=2), "cpu")
    assert (r.n, r.sp, r.ep) == (2, 2, 2)
    with pytest.raises(ValueError, match="sequence axis"):
        ranks.shard(torch.zeros((4, 3)))


# -- (f): the batch layout and the positions ------------------------------------

@pytest.mark.parametrize("dp,sp", [(2, 2), (1, 4), (2, 4)])
def test_batch_layout_matches_jax_p_dp_sp(dp, sp):
    """Rank (d, s) of ``VirtualRanks.shard`` holds exactly JAX device
    (d, s)'s shard of ``shard_host_batch(..., P("dp", "sp"))``."""
    x = np.arange(4 * 16 * 8, dtype=np.int32).reshape(4, 16 * 8)
    mesh = Mesh(np.asarray(jax.devices()[:dp * sp]).reshape(dp, sp),
                ("dp", "sp"))
    placed = jax_mesh.shard_host_batch(x, mesh, P("dp", "sp"))
    got = VirtualRanks(dp, torch.device("cpu"), sp).shard(
        torch.from_numpy(x))
    assert got.shape == (dp, sp, 4 // dp, 128 // sp)
    for shard in placed.addressable_shards:
        d, s = (int(np.argwhere(mesh.devices == shard.device)[0][i])
                for i in (0, 1))
        np.testing.assert_array_equal(got[d, s].numpy(),
                                      np.asarray(shard.data))


@pytest.mark.parametrize("sp", [2, 4])
def test_positions_match_jax(sp):
    S = 16
    mesh = Mesh(np.asarray(jax.devices()[:sp]), ("sp",))
    want = jax.jit(jax.shard_map(
        lambda: jax_llama._positions(S, "sp")[None], mesh=mesh,
        in_specs=(), out_specs=P("sp"), check_vma=False))()
    got = llama._positions(S, "sp", n_sp=sp)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(llama._positions(S), torch.arange(S,
                                                         dtype=torch.int32))


# -- (g): train_llama.main ---------------------------------------------------------

def test_train_llama_sp_on_cpu():
    out = train_llama.main([
        "--model=tiny", "--device=cpu", "--model.attn_block=128",
        "--seq=256", "--global_batch=4", "--mesh.dp=2", "--mesh.sp=2",
        "--iters=2"])
    assert out["mesh"]["sp"] == 2 and out["mesh"]["dp"] == 2
    assert np.isfinite(out["loss_first"]) and np.isfinite(out["loss_last"])
    assert out["tokens_per_sec"] > 0


def test_train_llama_refuses_shards_off_the_lane():
    with pytest.raises(ValueError, match="multiple of 128"):
        train_llama.parse(["--seq=384", "--mesh.sp=2"])
    with pytest.raises(ValueError, match="multiple of 128"):
        train_llama.parse(["--seq=250", "--mesh.sp=2"])
    mcfg, cfg, seq, _ = train_llama.parse(["--seq=256", "--mesh.sp=2"])
    assert cfg.mesh.sp == 2 and seq == 256
