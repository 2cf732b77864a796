"""The port's ResNet slice (``models/resnet.py``, sync-BN's joint graph in
``parallel/train.py``, ``data.py``, ``train_resnet.py`` and the ``resnet``
arm of the codec eval) against the JAX package, on the CPU.

The JAX functions run on the 8-device CPU mesh.  JAX's per-rank sync-BN
gradients come from ``jax.shard_map`` with the params cast dp-varying
before ``jax.grad`` (``out_specs=P("dp")``), as JAX's ``DPTrainer`` takes
them: rank j's gradient is d(sum_i loss_i)/d(theta_j).  The slice's
collective (``BFPConfig(codec="pallas")``, the fused kernels' route) is
held against the numpy golden composition, since JAX's trainers cannot
run the pallas codec on the CPU (ROADMAP C.3).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

from fpga_ai_nic_tpu import optim as jax_optim
from fpga_ai_nic_tpu.evals import codec_convergence as jax_cc
from fpga_ai_nic_tpu.models import resnet as jax_resnet
from fpga_ai_nic_tpu.ops import bfp_golden as jax_bfp_golden
from fpga_ai_nic_tpu.ops import ring_golden as jax_ring_golden
from fpga_ai_nic_tpu.parallel import DDPTrainer as JaxDDPTrainer
from fpga_ai_nic_tpu.parallel import DPTrainer as JaxDPTrainer
from fpga_ai_nic_tpu.parallel import make_mesh
from fpga_ai_nic_tpu.utils import config as jcfg
from fpga_ai_nic_tpu_torch import data, train_resnet
from fpga_ai_nic_tpu_torch.evals import codec_convergence as cc
from fpga_ai_nic_tpu_torch.models import resnet
from fpga_ai_nic_tpu_torch.ops import bucketed, fused_update
from fpga_ai_nic_tpu_torch.parallel.ddp import DDPTrainer, replicas_identical
from fpga_ai_nic_tpu_torch.parallel.mesh import VirtualRanks
from fpga_ai_nic_tpu_torch.parallel.train import (DPTrainer, joint_grads,
                                                  per_rank_grads)
from fpga_ai_nic_tpu_torch.utils import config as tcfg

CFG = resnet.ResNetConfig.tiny()
JCFG = jax_resnet.ResNetConfig.tiny()
N, BATCH, HW, STEPS = 8, 32, 16, 3
LR, MOM, WD = 0.1, 0.9, 1e-4
# f32 sums over a few thousand terms in other orders than XLA's: the
# gradients agreed to 7e-7 of their norm on the CPU; per-rank moments in
# place of the pooled ones move them by 0.8-1.3 of it
GRAD_REL_TOL = 1e-5


def _data(rng, n=BATCH, hw=HW):
    """``tests/test_resnet.py``'s batch: N(0, 1) images, uniform labels."""
    x = rng.standard_normal((n, hw, hw, 3)).astype(np.float32)
    y = rng.integers(0, CFG.num_classes, n).astype(np.int32)
    return x, y


@functools.lru_cache(maxsize=None)
def _jax_params(cfg=JCFG, seed=0):
    """JAX's initial weights and their numpy tree (read-only: shared)."""
    p = jax_resnet.init(jax.random.PRNGKey(seed), cfg)
    return p, jax.tree_util.tree_map(np.asarray, p)


def _flat(tree):
    return np.concatenate([np.asarray(t, np.float32).reshape(-1)
                           for t in jax.tree_util.tree_leaves(tree)])


def _unflat(flat, like):
    leaves, treedef = jax.tree_util.tree_flatten(like)
    out, off = [], 0
    for leaf in leaves:
        out.append(jnp.asarray(flat[off:off + leaf.size].reshape(
            leaf.shape), leaf.dtype))
        off += leaf.size
    return jax.tree_util.tree_unflatten(treedef, out)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@functools.lru_cache(maxsize=None)
def _jax_rank_grads_fn(n):
    """JAX's per-rank sync-BN losses and gradients over n CPU devices."""
    def per_rank(p, b):
        pv = jax.tree_util.tree_map(
            lambda t: lax.pcast(t, "dp", to="varying"), p)
        loss, g = jax.value_and_grad(lambda q: jax_resnet.loss_fn(
            q, b, JCFG, bn_axis="dp"))(pv)
        return loss[None], jax.tree_util.tree_map(lambda t: t[None], g)
    return jax.jit(jax.shard_map(
        per_rank, mesh=make_mesh(jcfg.MeshConfig(dp=n)),
        in_specs=(P(), P("dp")), out_specs=P("dp")))


def _jax_rank_grads(params, x, y, n=N):
    """([n] losses, [n, L] flat gradient rows in forward leaf order)."""
    losses, g = _jax_rank_grads_fn(n)(params, (jnp.asarray(x),
                                               jnp.asarray(y)))
    return np.asarray(losses), np.concatenate(
        [np.asarray(t, np.float32).reshape(n, -1)
         for t in jax.tree_util.tree_leaves(g)], axis=1)


def _port_replicas(pn, n=N):
    tree = resnet.from_jax_params(pn, "cpu")
    meta = fused_update.flat_meta(tree, tcfg.CollectiveConfig(), n)
    flat = fused_update.flatten_tree(tree, meta)
    return flat.reshape(1, -1).expand(n, -1), meta


def _split(x, y, n=N):
    return (torch.from_numpy(x).reshape(n, -1, *x.shape[1:]),
            torch.from_numpy(y).reshape(n, -1))


# -- layers ------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 3, 7])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("side", [15, 16, 17])
def test_conv_same_padding_matches_lax(side, stride, k):
    """``_conv`` == ``lax.conv_general_dilated(..., "SAME", NHWC/HWIO)``
    in shape and within 1e-5 (f32 sums of at most 7*7*4 products in other
    orders); an even side at stride 2 pads (k-2)//2 low and k//2 high,
    which a symmetric pad would shift by one pixel."""
    rng = np.random.default_rng(side * 100 + stride * 10 + k)
    x = rng.standard_normal((2, side, side + 1, 4)).astype(np.float32)
    w = rng.standard_normal((k, k, 4, 5)).astype(np.float32)
    want = np.asarray(jax_resnet._conv(jnp.asarray(x), jnp.asarray(w),
                                       stride))
    got = resnet._conv(torch.from_numpy(x), torch.from_numpy(w),
                       stride).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("side", [15, 16, 17])
def test_max_pool_matches_reduce_window(side):
    """``_max_pool`` == ``lax.reduce_window(-inf, max, 3x3, stride 2,
    SAME)`` bit for bit; on an even side the pad is (0, 1) of -inf."""
    rng = np.random.default_rng(side)
    x = rng.standard_normal((2, side, side + 1, 3)).astype(np.float32) - 5
    want = np.asarray(lax.reduce_window(
        jnp.asarray(x), -jnp.inf, lax.max, (1, 3, 3, 1), (1, 2, 2, 1),
        "SAME"))
    got = resnet._max_pool(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


# -- forward and statistics ---------------------------------------------------

def _stats_np(stats):
    return [{k: np.asarray(s[k]) for k in ("mean", "var")}
            for s in stats["bn"]]


def test_forward_f32_train_and_eval_match_jax(rng):
    """The tiny f32 model's logits in train mode (batch moments) and in
    eval mode (after three ``compute_stats`` steps in each package) within
    JAX's own rtol 1e-4 / atol 1e-5 (``tests/test_resnet.py``), and the
    running statistics within 1e-5 (f32 means over 4k-16k values)."""
    jp, pn = _jax_params()
    tp = resnet.from_jax_params(pn, "cpu")
    x, _ = _data(rng, n=16)
    want = np.asarray(jax_resnet.apply(jp, jnp.asarray(x), JCFG))
    got = resnet.apply(tp, torch.from_numpy(x), CFG).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    jst, tst = jax_resnet.init_stats(JCFG), resnet.init_stats(CFG, "cpu")
    assert [(s["mean"].shape, s["var"].shape) for s in _stats_np(tst)] == \
        [(s["mean"].shape, s["var"].shape) for s in _stats_np(jst)]
    calib = jax.jit(lambda p, xb, s: jax_resnet.compute_stats(p, xb, JCFG,
                                                              s))
    for _ in range(3):
        jst = calib(jp, jnp.asarray(x), jst)
        tst = resnet.compute_stats(tp, torch.from_numpy(x), CFG, tst)
    for a, b in zip(_stats_np(tst), _stats_np(jst)):
        for k in ("mean", "var"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-5)
    want = np.asarray(jax_resnet.apply(jp, jnp.asarray(x), JCFG, stats=jst))
    got = resnet.apply(tp, torch.from_numpy(x), CFG,
                       stats=tst).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_forward_bf16_matches_jax(rng):
    """The tiny model in bf16, train mode: logits within 2^-6 of the
    largest (bf16 keeps 8 significant bits; a conv output rounded the
    other way moves a logit by an ulp, 2^-8 of its binade, and a few such
    roundings may add up); 0.0039 on the CPU."""
    bcfg = dataclasses.replace(CFG, dtype="bfloat16")
    jp, pn = _jax_params(dataclasses.replace(JCFG, dtype="bfloat16"))
    x, _ = _data(rng, n=16)
    want = np.asarray(jax_resnet.apply(
        jp, jnp.asarray(x), dataclasses.replace(JCFG, dtype="bfloat16")),
        np.float32)
    got = resnet.apply(resnet.from_jax_params(pn, "cpu"),
                       torch.from_numpy(x), bcfg).detach().float().numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2.0 ** -6 * np.abs(want).max())


def test_num_params_and_from_jax_params_roundtrip():
    """ResNet-50 has 25,557,032 parameters, counted from the shapes alone
    (as JAX's ``num_params``); JAX's tiny trees (f32 and bf16) come across
    with every leaf's shape, dtype and bits, in JAX's leaf order."""
    assert resnet.num_params(resnet.ResNetConfig.resnet50()) == 25_557_032
    assert resnet.num_params(CFG) == jax_resnet.num_params(JCFG)
    for dt in ("float32", "bfloat16"):
        _, pn = _jax_params(dataclasses.replace(JCFG, dtype=dt))
        back = fused_update.tree_leaves(resnet.from_jax_params(pn, "cpu"))
        for a, b in zip(back, jax.tree_util.tree_leaves(pn)):
            assert str(a.dtype) == f"torch.{dt}" and a.shape == b.shape
            if dt == "bfloat16":
                np.testing.assert_array_equal(a.view(torch.int16).numpy(),
                                              b.view(np.int16))
            else:
                np.testing.assert_array_equal(a.numpy(), b)
        shapes = [tuple(t.shape) for t in fused_update.tree_leaves(
            resnet.init(torch.Generator().manual_seed(0),
                        dataclasses.replace(CFG, dtype=dt), "cpu"))]
        assert shapes == [b.shape for b in jax.tree_util.tree_leaves(pn)]


def test_bn_axis_outside_the_joint_graph_raises(rng):
    """``bn_axis="dp"`` never quietly means per-rank moments."""
    _, pn = _jax_params()
    x, y = _data(rng, n=4)
    tp = resnet.from_jax_params(pn, "cpu")
    batch = (torch.from_numpy(x), torch.from_numpy(y))
    with pytest.raises(ValueError, match="loss_fn_ranks"):
        resnet.loss_fn(tp, batch, CFG, bn_axis="dp")
    with pytest.raises(ValueError, match="loss_fn_ranks"):
        resnet.apply(tp, batch[0], CFG, bn_axis="dp")
    assert resnet.dp_loss_fn(CFG).joint_ranks


# -- sync-BN gradients --------------------------------------------------------

def test_sync_bn_grads_match_jax_per_rank(rng):
    """The joint graph's gradient rows equal JAX's per-rank sync-BN
    gradients rank by rank (tiny f32, dp=8), within GRAD_REL_TOL of each
    row's norm, and the losses within 1e-6; the control, every rank's own
    moments (``per_rank_grads`` of ``loss_fn``), exceeds the limit on
    every rank."""
    jp, pn = _jax_params()
    x, y = _data(rng)
    want_l, want = _jax_rank_grads(jp, x, y)
    reps, meta = _port_replicas(pn)
    batch = _split(x, y)
    L = want.shape[1]
    got, loss = joint_grads(resnet.dp_loss_fn(CFG), reps, meta, batch)
    np.testing.assert_allclose(float(loss), want_l.mean(), rtol=1e-6)
    ctl, _ = per_rank_grads(lambda p, b: resnet.loss_fn(p, b, CFG), reps,
                            meta, batch)
    for i in range(N):
        assert _rel(got[i, :L].numpy(), want[i]) <= GRAD_REL_TOL, i
        assert _rel(ctl[i, :L].numpy(), want[i]) > GRAD_REL_TOL, i
    assert not bool(got[:, L:].any())


def test_sync_bn_mean_grad_equals_one_device(rng):
    """JAX's ``test_sync_bn_matches_single_device`` invariant: the ranks'
    joint losses average to ``loss_fn`` on the whole batch through one
    replica, and their gradients, summed over the ranks and divided by n,
    to its gradient (within GRAD_REL_TOL)."""
    _, pn = _jax_params()
    x, y = _data(rng, n=16)
    reps, meta = _port_replicas(pn)
    got, loss = joint_grads(resnet.dp_loss_fn(CFG), reps, meta,
                            _split(x, y))
    one, want_loss = per_rank_grads(
        lambda p, b: resnet.loss_fn(p, b, CFG), reps[:1], meta,
        (torch.from_numpy(x)[None], torch.from_numpy(y)[None]))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    assert _rel((got.sum(0) / N).numpy(), one[0].numpy()) <= GRAD_REL_TOL


# -- trainers -----------------------------------------------------------------

def _train_cfg(mod, kind, trainer="dp", n=N, batch=BATCH):
    comp = {"ring": None, "ring_bfp": mod.BFPConfig(),
            "fused": mod.BFPConfig(codec="pallas")}[kind]
    return mod.TrainConfig(
        global_batch=batch, mesh=mod.MeshConfig(dp=n),
        collective=mod.CollectiveConfig(
            impl="ring", compression=comp, fused_kernel=kind == "fused",
            fused_optimizer=trainer == "dp"),
        optimizer=mod.OptimizerConfig(kind="momentum", learning_rate=LR,
                                      momentum=MOM, weight_decay=WD))


def _port_trainer(kind, trainer="dp", n=N):
    cls = DPTrainer if trainer == "dp" else DDPTrainer
    return cls(resnet.dp_loss_fn(CFG), VirtualRanks(n, torch.device("cpu")),
               _train_cfg(tcfg, kind, trainer, n))


def _masters(state, trainer):
    return (state.w_own.reshape(-1) if trainer == "dp"
            else state.w_master[0]).numpy()


@pytest.mark.parametrize("trainer", ["dp", "ddp"])
@pytest.mark.parametrize("kind", ["ring", "ring_bfp"])
def test_trainer_matches_jax(trainer, kind, rng):
    """Three steps of the port's trainer against JAX's (``DPTrainer`` with
    the fused-formula update on the shards, or the bucketed
    ``DDPTrainer``), momentum SGD (lr 0.1, 0.9, weight decay 1e-4), sync-BN
    over 8 ranks, the same weights and batch: losses within rtol 1e-5,
    masters within 1e-6 of JAX's plus, with BFP on the wire, the bound
    one flipped grid step a step carries (``_flip_bound``); replicas
    bit-identical."""
    jp, pn = _jax_params()
    x, y = _data(rng)
    jc = _train_cfg(jcfg, kind, trainer)
    jcls = JaxDPTrainer if trainer == "dp" else JaxDDPTrainer
    jtr = jcls(lambda p, b: jax_resnet.loss_fn(p, b, JCFG, bn_axis="dp"),
               make_mesh(jc.mesh), jc)
    jstate = jtr.init_state(jp)
    jbatch = jtr.shard_batch((jnp.asarray(x), jnp.asarray(y)))
    tr = _port_trainer(kind, trainer)
    state = tr.init_state(resnet.from_jax_params(pn, "cpu"))
    batch = tr.shard_batch((torch.from_numpy(x), torch.from_numpy(y)))
    flips = _flip_bound(N if trainer == "ddp" else 1)
    for _ in range(STEPS):
        gmax = _grad_max(tr, state, batch) if kind == "ring_bfp" else 0.0
        jstate, jloss = jtr.step(jstate, jbatch)
        state, loss = tr.step(state, batch)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        atol = 1e-6 + flips(N * gmax)
        jw = np.asarray(jstate.w_own if trainer == "dp"
                        else jstate.w_master).reshape(-1)
        np.testing.assert_allclose(_masters(state, trainer), jw, rtol=0,
                                   atol=atol)
        reps = state.replicas
        assert bool((reps == reps[0]).all())
    assert state.step == STEPS


def _grad_max(tr, state, batch):
    """The largest per-rank gradient of a step (either trainer)."""
    g, _ = tr.grads(state, batch)
    return max(float(r.abs().max()) for r in (g if isinstance(g, list)
                                              else [g]))


def _flip_bound(scale):
    """A running bound on what BFP flips move a master: a value on a
    rounding boundary may land one grid step (2^-6 of its block's max,
    the block max at most ``gsum_max``, the largest reduced sum) away, on
    every hop, so the mean gradient moves by at most ``scale`` 2^-6
    ``gsum_max`` / n a step; momentum carries each step's error into
    every later one (m' = 0.9 m + g), and the update moves the master by
    lr times m's error."""
    state = {"m": 0.0, "w": 0.0}

    def step(gsum_max):
        state["m"] = MOM * state["m"] + scale * 2.0 ** -6 * gsum_max / N
        state["w"] += LR * state["m"] * (1 + WD)
        return state["w"]
    return step


def _golden_dp_step(flat_g, w_own, m, step):
    """The slice's collective by the numpy goldens: the sublane ring
    reduce-scatter, ``golden_fused_apply("momentum")`` on each owned
    shard, each new shard quantized once and gathered."""
    cfg = jcfg.BFPConfig()
    g_sum = jax_ring_golden.ring_reduce_scatter(flat_g, cfg, "sublane")
    hyper = np.asarray(jax_optim.fused_hyperparams(
        jax_optim.OptimizerConfig(kind="momentum", learning_rate=LR,
                                  momentum=MOM, weight_decay=WD), step))
    out = [jax_optim.golden_fused_apply("momentum", w_own[i], g_sum[i],
                                        {"m": m[i]}, hyper, N)
           for i in range(N)]
    w_new = np.stack([w for w, _ in out])
    m_new = np.stack([st["m"] for _, st in out])
    q = np.concatenate([jax_bfp_golden.bfp_decode(
        *jax_bfp_golden.bfp_encode(w, layout="sublane"), layout="sublane")
        for w in w_new])
    return w_new, m_new, q


def test_dp_fused_matches_golden_composition(rng):
    """``DPTrainer`` with the slice's collective (fused BFP ring, fused
    momentum SGD; the kernels' plain versions on the CPU), three steps:
    given JAX's per-rank sync-BN gradients, the masters, the momentum
    shards and every replica equal the golden composition's bit for bit;
    at each step's weights the port's own gradients are within
    GRAD_REL_TOL of JAX's and its loss within 1e-6."""
    jp, pn = _jax_params()
    x, y = _data(rng)
    tr = _port_trainer("fused")
    state = tr.init_state(resnet.from_jax_params(pn, "cpu"))
    batch = tr.shard_batch((torch.from_numpy(x), torch.from_numpy(y)))
    w_ref, m_ref = state.w_own.numpy(), np.zeros_like(state.w_own.numpy())
    L_pad = N * w_ref.shape[1]
    p_ref = jp
    for step in range(STEPS):
        jl, jg = _jax_rank_grads(p_ref, x, y)
        flat_g = np.pad(jg, ((0, 0), (0, L_pad - jg.shape[1])))
        g, loss = tr.grads(state, batch)
        np.testing.assert_allclose(float(loss), jl.mean(), rtol=1e-6)
        assert _rel(g.numpy(), flat_g) <= GRAD_REL_TOL
        state = tr.apply_grads(state, torch.from_numpy(flat_g))
        w_ref, m_ref, q = _golden_dp_step(flat_g, w_ref, m_ref, step)
        np.testing.assert_array_equal(state.w_own.numpy(), w_ref)
        np.testing.assert_array_equal(state.opt_state["m"].numpy(), m_ref)
        for i in range(N):
            np.testing.assert_array_equal(state.replicas[i].numpy(), q)
        p_ref = _unflat(q, jp)
    assert state.step == STEPS


def _golden_bucket_mean(rows, plan):
    """The fused BFP all-reduce's spec per bucket: the golden sublane
    reduce-scatter, each owned sum quantized once and gathered, over n;
    assembled in forward leaf order."""
    cfg = jcfg.BFPConfig()
    sizes = [int(np.prod(s)) if s else 1 for s in plan.shapes]
    offs = np.cumsum([0] + sizes[:-1])
    flat = np.zeros(sum(sizes), np.float32)
    for b, row in zip(plan.buckets, rows):
        g_sum = jax_ring_golden.ring_reduce_scatter(row, cfg, "sublane")
        red = np.concatenate([jax_bfp_golden.bfp_decode(
            *jax_bfp_golden.bfp_encode(c, layout="sublane"),
            layout="sublane") for c in g_sum]) / np.float32(N)
        off = 0
        for i, size in zip(b.leaf_ids, b.sizes):
            flat[offs[i]:offs[i] + size] = red[off:off + size]
            off += size
    return flat


def test_ddp_fused_matches_golden_composition(rng):
    """``DDPTrainer`` with the slice's collective (fused BFP ring on every
    bucket), three steps: JAX's per-rank sync-BN gradients through the
    port's bucketed all-reduce give the golden mean bit for bit on every
    rank; the replicated momentum SGD on it gives JAX's ``optim.apply``
    masters and momentum within 1e-7 (XLA may fuse the elementwise
    chain); replicas bit-identical."""
    jp, pn = _jax_params()
    x, y = _data(rng)
    tr = _port_trainer("fused", "ddp")
    state = tr.init_state(resnet.from_jax_params(pn, "cpu"))
    plan = tr.plan
    opt = jax_optim.OptimizerConfig(kind="momentum", learning_rate=LR,
                                    momentum=MOM, weight_decay=WD)
    w_ref, st_ref = _flat(pn), {"m": np.zeros_like(_flat(pn))}
    for step in range(STEPS):
        _, jg = _jax_rank_grads(_unflat(w_ref, jp), x, y)
        rows = bucketed.bucket_rows(plan, N, "cpu")
        sizes = np.cumsum([0] + [int(np.prod(s)) for s in plan.shapes])
        for r in range(N):
            leaves = [torch.from_numpy(jg[r, a:b].reshape(s)) for a, b, s
                      in zip(sizes[:-1], sizes[1:], plan.shapes)]
            bucketed.bucket_locals(leaves, plan, [row[r] for row in rows])
        want = _golden_bucket_mean([r.numpy().copy() for r in rows], plan)
        got = tr.all_reduce(rows)
        for r in range(N):
            np.testing.assert_array_equal(got[r].numpy(), want)
        state = tr.update(state, got)
        w2, st2 = jax_optim.apply(
            opt, jnp.asarray(w_ref), jnp.asarray(want),
            {"m": jnp.asarray(st_ref["m"])}, jnp.asarray(step, jnp.int32))
        w_ref, st_ref = np.asarray(w2), {"m": np.asarray(st2["m"])}
        np.testing.assert_allclose(state.w_master[0].numpy(), w_ref, rtol=0,
                                   atol=1e-7)
        np.testing.assert_allclose(state.opt_state["m"][0].numpy(),
                                   st_ref["m"], rtol=0, atol=1e-7)
        w_ref = state.w_master[0].numpy()     # carry the port's masters
        st_ref = {"m": state.opt_state["m"][0].numpy()}
        assert replicas_identical(state)


# -- the eval arm, the loader and train_resnet --------------------------------

def test_resnet_batches_are_the_reference_stream():
    """The resnet arm's stream is the JAX eval's, bit for bit."""
    _, _, want = jax_cc._make_batches("resnet", 2, 8, 5)
    got = cc._make_batches("resnet", 2, 8, 5)
    for (x, y), (jx, jy) in zip(got, want):
        np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(y.numpy(), np.asarray(jy))


@pytest.mark.parametrize("trainer", ["dp", "ddp"])
def test_resnet_curve_matches_jax(trainer):
    """The resnet arm from JAX's initial weights against JAX's
    ``run_curve`` (tiny ResNet, 16x16 images, sync-BN over 8 ranks, AdamW
    3e-3 through the uncompressed ring), 4 steps: the recorded losses
    within rtol 1e-4 (f32 convolutions summed in other orders, carried
    through AdamW, which divides each coordinate by its own RMS)."""
    params, _, _ = jax_cc._make_batches("resnet", 1, 32, 0)
    want = jax_cc.run_curve("resnet", 4, record_every=1, trainer=trainer)
    got = cc.run_curve("resnet", 4, record_every=1, trainer=trainer,
                       params=resnet.from_jax_params(
                           jax.tree_util.tree_map(np.asarray, params),
                           "cpu"), device="cpu")
    assert got["steps"] == want["steps"] == [1, 2, 3, 4]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)


def test_sharded_loader_keeps_a_bounded_window():
    """The loader yields every batch split as ``shard_batch`` splits it,
    in order, and holds ``prefetch`` of them beside the one it hands out
    (JAX's window)."""
    ranks = VirtualRanks(4, torch.device("cpu"))
    pulled = []

    def make(rng):
        pulled.append(len(pulled))
        return (torch.from_numpy(rng.standard_normal((8, 3))),
                torch.arange(8))
    loader = data.ShardedLoader(
        data.synthetic_batches(make, seed=3, num_batches=5), ranks,
        prefetch=2)
    rng = np.random.default_rng(3)
    for i, (x, y) in enumerate(loader):
        assert len(pulled) == min(i + 3, 5)
        assert x.shape == (4, 2, 3) and y.shape == (4, 2)
        np.testing.assert_array_equal(
            x.numpy(), rng.standard_normal((8, 3)).reshape(4, 2, 3))
    assert i == 4
    with pytest.raises(ValueError):
        data.ShardedLoader([], ranks, prefetch=0)


def test_driver_stream_is_jax_drivers():
    """``train_resnet``'s batches are the JAX driver's, seed for seed:
    images N(0, 1) in f32 rounded to the model dtype (bf16 bits equal to
    ``jnp.asarray(x, bfloat16)``), labels int32."""
    mcfg, cfg, size, _ = train_resnet.parse(
        ["--model=resnet50", "--image-size=8", "--global_batch=4",
         "--seed=3"])
    got = list(train_resnet.batches(mcfg, cfg, size, 2))
    r = np.random.default_rng(3)
    for x, y in got:
        jx = r.standard_normal((4, 8, 8, 3)).astype(np.float32)
        jy = r.integers(0, 1000, 4).astype(np.int32)
        want = np.asarray(jnp.asarray(jx, jnp.bfloat16))
        assert x.dtype == torch.bfloat16 and y.dtype == torch.int32
        np.testing.assert_array_equal(x.view(torch.int16).numpy(),
                                      want.view(np.int16))
        np.testing.assert_array_equal(y.numpy(), jy)


def test_driver_prints_jax_keys_on_cpu_and_raises_without_a_card(
        monkeypatch):
    """``train_resnet --model=tiny --device=cpu`` runs the plain versions
    and prints JAX's keys; without ``--device=cpu`` on a machine with no
    card it raises."""
    out = train_resnet.main(["--model=tiny", "--device=cpu", "--mesh.dp=2",
                             "--global_batch=8", "--iters=2", "--bfp=1",
                             "--collective.fused_optimizer=true",
                             "--optimizer.kind=momentum"])
    assert set(out) >= {"loss_first", "loss_last", "samples_per_sec",
                        "wall_s", "params"}
    assert out["params"] == jax_resnet.num_params(JCFG)
    assert np.isfinite([out["loss_first"], out["loss_last"]]).all()
    assert out["device"] == "cpu" and out["codec"]["backend"] == "pallas"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        train_resnet.main(["--model=tiny", "--global_batch=8", "--iters=1"])
