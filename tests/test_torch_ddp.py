"""The port's bucketed all-reduce (``ops/bucketed.py``) and DDP trainer
(``parallel/ddp.py``) against the JAX package, on the tiny BERT.

``impl="xla"``, the uncompressed ring and the ring with the default
``BFPConfig`` run against JAX's ``DDPTrainer`` itself, on the 8-device CPU
mesh, as ``tests/test_bert.py`` runs it.  The slice's configuration
(``BFPConfig(codec="pallas")``, ``fused_kernel=True``) is held against the
composition the JAX package defines for it, since JAX's fused route falls
back off the TPU and cannot run the pallas codec on the CPU (ROADMAP
C.4): per bucket ``ring_golden.ring_reduce_scatter`` in the sublane
layout, the all-gather quantizing each owned chunk once, the mean, then
``optim.apply``.  ``DPTrainer`` (ZeRO-1) on the tiny BERT is held against
its golden composition as the MLP's is (``tests/test_torch_train.py``).
In every case the ranks' replicas stay bit-identical.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import jax
import jax.numpy as jnp

from fpga_ai_nic_tpu import optim as jax_optim
from fpga_ai_nic_tpu.models import bert as jax_bert
from fpga_ai_nic_tpu.ops import bfp_golden as jax_bfp_golden
from fpga_ai_nic_tpu.ops import bucketed as jax_bucketed
from fpga_ai_nic_tpu.ops import ring_golden as jax_ring_golden
from fpga_ai_nic_tpu.parallel import DDPTrainer as JaxDDPTrainer
from fpga_ai_nic_tpu.parallel import make_mesh
from fpga_ai_nic_tpu.utils import config as jcfg
from fpga_ai_nic_tpu_torch.models import bert
from fpga_ai_nic_tpu_torch.ops import bucketed, fused_update
from fpga_ai_nic_tpu_torch.parallel import DDPTrainer
from fpga_ai_nic_tpu_torch.parallel.ddp import replicas_identical
from fpga_ai_nic_tpu_torch.parallel.mesh import VirtualRanks
from fpga_ai_nic_tpu_torch.parallel.train import DPTrainer
from fpga_ai_nic_tpu_torch.utils import config as tcfg

JAX_BERT = jax_bert.BertConfig.tiny()
BERT = bert.BertConfig.tiny()
N, BATCH, STEPS, LR = 8, 16, 3, 0.1


def _data(rng, n=BATCH, S=32):
    """``tests/test_bert.py``'s MLM batch: a padded tail, 15% of the valid
    positions masked, position 0 always."""
    toks = rng.integers(1, JAX_BERT.vocab, (n, S)).astype(np.int32)
    toks[:, S - 4:] = JAX_BERT.pad_id
    labels = np.full((n, S), -100, np.int32)
    m = (rng.random((n, S)) < 0.15) & (toks != JAX_BERT.pad_id)
    m[:, 0] = True
    labels[m] = toks[m]
    toks[m] = 3
    return toks, labels


def _jax_params(seed=0):
    p = jax_bert.init(jax.random.PRNGKey(seed), JAX_BERT)
    return p, jax.tree_util.tree_map(np.asarray, p)


def _coll(mod, kind, bucket_elems=4096):
    comp = {"xla": None, "ring": None, "ring_bfp": mod.BFPConfig(),
            "fused": mod.BFPConfig(codec="pallas")}[kind]
    return mod.CollectiveConfig(impl="xla" if kind == "xla" else "ring",
                                compression=comp,
                                fused_kernel=kind == "fused",
                                bucket_elems=bucket_elems)


def _train_cfg(mod, kind, n=N, opt="sgd", **coll_kw):
    o = (mod.OptimizerConfig(kind="sgd", learning_rate=LR) if opt == "sgd"
         else mod.OptimizerConfig(kind="adamw", learning_rate=1e-3,
                                  weight_decay=0.01))
    return mod.TrainConfig(global_batch=BATCH, mesh=mod.MeshConfig(dp=n),
                           collective=_coll(mod, kind, **coll_kw),
                           optimizer=o)


def _port_trainer(kind, n=N, opt="sgd", cls=DDPTrainer, **coll_kw):
    return cls(lambda p, b: bert.loss_fn(p, b, BERT, dp_size=n),
               VirtualRanks(n, torch.device("cpu")),
               _train_cfg(tcfg, kind, n, opt, **coll_kw))


def _port_batch(tr, toks, labels, n):
    return tr.shard_batch(bert.with_global_count(
        (torch.from_numpy(toks), torch.from_numpy(labels)), n))


def _grad_max(tr, state, batch):
    rows, _ = tr.grads(state, batch)
    return max(float(r.abs().max()) for r in rows)


def _flip_atol(n, gmax):
    """What one step may move a master when torch's and XLA's gradients
    differ in the last bits: a BFP value on a rounding boundary may flip
    one grid step (2^-6 of its block max) at each of the n - 1 hops of the
    reduce-scatter (partial sums at most n max|g|) and once in the
    all-gather of the sums; after the mean that is at most n 2^-6 max|g|,
    times the SGD learning rate."""
    return LR * n * 2.0 ** -6 * gmax


# -- bucket planning ---------------------------------------------------------

def _mixed_trees():
    """A bf16 / f32 tree as numpy (for JAX) and as torch tensors."""
    bf16 = jnp.bfloat16
    shapes = {"w": ((100, 7), bf16), "b": [((33,), bf16),
                                           ((5000,), np.float32)]}
    jtree = jax.tree_util.tree_map(lambda sd: np.zeros(*sd), shapes,
                                   is_leaf=lambda x: isinstance(x, tuple)
                                   and isinstance(x[0], tuple))
    return jtree, jax.tree_util.tree_map(
        lambda a: torch.zeros(a.shape, dtype=torch.bfloat16
                              if a.dtype == bf16 else torch.float32), jtree)


@pytest.mark.parametrize("tree", ["bert", "bf16"])
@pytest.mark.parametrize("kind,bucket_elems", [
    ("xla", 5000), ("ring_bfp", 5000), ("fused", 4096), ("fused", 1 << 22),
    ("ring", 64)])
def test_plan_buckets_equal_jax(tree, kind, bucket_elems):
    """Leaf order (reverse tree order), sizes, padding and the wire bytes
    of one all-reduce equal JAX's ``plan_buckets`` / ``bucket_wire_bytes``
    on the tiny BERT and on a mixed bf16/f32 tree, at n=8."""
    if tree == "bert":
        jtree = _jax_params()[1]
        ttree = bert.from_jax_params(jtree, "cpu")
    else:
        jtree, ttree = _mixed_trees()
    jc = _coll(jcfg, kind, bucket_elems)
    tc = _coll(tcfg, kind, bucket_elems)
    want = jax_bucketed.plan_buckets(jtree, jc, N)
    got = bucketed.plan_buckets(ttree, tc, N)
    assert [tuple(b) for b in got.buckets] == [
        (tuple(b.leaf_ids), tuple(b.sizes), b.padded_len)
        for b in want.buckets]
    assert got.shapes == want.shapes
    assert bucketed.bucket_wire_bytes(got, N, tc) == \
        jax_bucketed.bucket_wire_bytes(want, N, jc)


@pytest.mark.parametrize("kind", ["xla", "ring", "ring_bfp"])
def test_bucketed_all_reduce_is_the_mean(kind):
    """Every rank's row of the assembled result is the dp-mean of the
    leaves (exact for the sums; within the BFP error bound with the
    codec), in forward leaf order, f32 for bf16 leaves."""
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((40, 7)).astype(np.float32),
            "b": [rng.standard_normal((333,)).astype(np.float32),
                  rng.standard_normal((2, 3)).astype(np.float32)]}
    per_rank = [{k: (torch.from_numpy(v * (r + 1)) if k == "a" else
                     [torch.from_numpy(x * (r + 1)) for x in v])
                 for k, v in tree.items()} for r in range(N)]
    coll = _coll(tcfg, kind, 100)
    plan = bucketed.plan_buckets(per_rank[0], coll, N)
    rows = bucketed.bucket_rows(plan, N, "cpu")
    for r, t in enumerate(per_rank):
        bucketed.bucket_locals(fused_update.tree_leaves(t), plan,
                               [row[r] for row in rows])
    got = bucketed.all_reduce_bucketed_flat(rows, coll, plan)
    assert rows == [] and got.dtype == torch.float32
    want = _flat(tree) * np.mean(np.arange(1, N + 1))
    tol = 2e-2 if kind == "ring_bfp" else 1e-5
    for r in range(N):
        np.testing.assert_allclose(got[r].numpy(), want, rtol=tol,
                                   atol=tol * np.abs(want).max())
        assert torch.equal(got[r], got[0])


def test_bucket_locals_and_assemble_flat_invert():
    """``assemble_flat`` of the ranks' ``bucket_locals`` rows is the
    forward flat layout (leaves in tree order, padding dropped and zero in
    the rows), for every rank's row, and ``div`` divides in the same copy."""
    jtree = _jax_params()[1]
    tree = bert.from_jax_params(jtree, "cpu")
    plan = bucketed.plan_buckets(tree, _coll(tcfg, "fused"), N)
    leaves = fused_update.tree_leaves(tree)
    rows = bucketed.bucket_rows(plan, 2, "cpu")
    bucketed.bucket_locals(leaves, plan, [r[0] for r in rows])
    bucketed.bucket_locals([2 * t for t in leaves], plan,
                           [r[1] for r in rows])
    assert [r.shape for r in rows] == [(2, b.padded_len)
                                       for b in plan.buckets]
    for r, b in zip(rows, plan.buckets):
        assert not bool(r[:, sum(b.sizes):].any())
    both = bucketed.assemble_flat(rows, plan)
    np.testing.assert_array_equal(both[0].numpy(), _flat(jtree))
    np.testing.assert_array_equal(both[1].numpy(), 2 * _flat(jtree))
    halves = bucketed.assemble_flat(iter(rows), plan, div=2)
    np.testing.assert_array_equal(halves[1].numpy(), _flat(jtree))


def test_bucketed_flat_keeps_f32_for_bf16_leaves():
    """The dp-mean of bf16 leaves stays f32 (JAX's
    ``all_reduce_bucketed_flat`` contract)."""
    rng = np.random.default_rng(1)
    vals = rng.standard_normal((N, 133)).astype(np.float32)
    leaves = torch.from_numpy(vals).to(torch.bfloat16)
    tree = {"b": leaves[0, :33], "w": leaves[0, 33:]}
    coll = tcfg.CollectiveConfig(bucket_elems=64)
    plan = bucketed.plan_buckets(tree, coll, N)
    rows = bucketed.bucket_rows(plan, N, "cpu")
    for r in range(N):
        bucketed.bucket_locals([leaves[r, :33], leaves[r, 33:]], plan,
                               [row[r] for row in rows])
    got = bucketed.all_reduce_bucketed_flat(rows, coll, plan)[0]
    want = leaves.float().mean(0)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    assert bool((got != want.to(torch.bfloat16).float()).any())


# -- the DDP trainer ---------------------------------------------------------

@pytest.mark.parametrize("kind", ["xla", "ring", "ring_bfp"])
def test_ddp_matches_jax_trainer(kind):
    """Three steps of the port's DDPTrainer against JAX's DDPTrainer (8
    ranks, SGD lr 0.1, the same weights and batches): losses within rtol
    1e-5; masters within rtol 2e-4 / atol 2e-5 (``tests/test_bert.py``'s
    tolerance for XLA against a reference) uncompressed, within the BFP
    flip bound with the codec; replicas bit-identical every step."""
    jp, pn = _jax_params()
    jc = _train_cfg(jcfg, kind)
    jtr = JaxDDPTrainer(lambda p, b: jax_bert.loss_fn(p, b, JAX_BERT,
                                                      dp_axis="dp"),
                        make_mesh(jc.mesh), jc)
    jstate = jtr.init_state(jp)
    tr = _port_trainer(kind)
    state = tr.init_state(bert.from_jax_params(pn, "cpu"))
    rng = np.random.default_rng(0)
    atol = 2e-5
    for _ in range(STEPS):
        toks, labels = _data(rng)
        batch = _port_batch(tr, toks, labels, N)
        if kind == "ring_bfp":
            atol += _flip_atol(N, _grad_max(tr, state, batch))
        jstate, jloss = jtr.step(jstate, jtr.shard_batch(
            (jnp.asarray(toks), jnp.asarray(labels))))
        state, loss = tr.step(state, batch)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        np.testing.assert_allclose(state.w_master[0].numpy(),
                                   np.asarray(jstate.w_master), rtol=2e-4,
                                   atol=atol)
        assert replicas_identical(state)
    assert state.step == STEPS


def _jax_grads(params, toks, labels, n):
    """Each rank's JAX gradient of the dp-weighted loss (the local mean
    scaled by n * local_count / global_count) as a flat f32 row in forward
    leaf order, [n, L], and the largest gradient."""
    vg = jax.jit(jax.grad(lambda p, b: jax_bert.loss_fn(p, b, JAX_BERT)))
    total = int((labels >= 0).sum())
    per = toks.shape[0] // n
    flat = []
    for r in range(n):
        sl = slice(r * per, (r + 1) * per)
        count = int((labels[sl] >= 0).sum())
        g = vg(params, (jnp.asarray(toks[sl]), jnp.asarray(labels[sl])))
        flat.append(_flat(g) * np.float32(n * count / total))
    flat = np.stack(flat)
    return flat, float(np.abs(flat).max())


def _bucket(flat, plan):
    """[n, L] forward-order rows -> per-bucket [n, padded_len] rows."""
    sizes = [int(np.prod(s)) if s else 1 for s in plan.shapes]
    offs = np.cumsum([0] + sizes[:-1])
    rows = []
    for b in plan.buckets:
        row = np.zeros((flat.shape[0], b.padded_len), np.float32)
        row[:, :sum(b.sizes)] = np.concatenate(
            [flat[:, offs[i]:offs[i] + size]
             for i, size in zip(b.leaf_ids, b.sizes)], axis=1)
        rows.append(row)
    return rows


def _golden_mean(rows, plan):
    """The fused BFP all-reduce's spec per bucket (sublane layout): the
    golden reduce-scatter, each owned sum quantized once and gathered,
    divided by n; assembled in forward leaf order."""
    cfg = jcfg.BFPConfig()
    n = rows[0].shape[0]
    sizes = [int(np.prod(s)) if s else 1 for s in plan.shapes]
    offs = np.cumsum([0] + sizes[:-1])
    flat = np.zeros(sum(sizes), np.float32)
    for b, row in zip(plan.buckets, rows):
        g_sum = jax_ring_golden.ring_reduce_scatter(row, cfg, "sublane")
        q = np.concatenate([jax_bfp_golden.bfp_decode(
            *jax_bfp_golden.bfp_encode(c, layout="sublane"),
            layout="sublane") for c in g_sum])
        red = q / np.float32(n)
        off = 0
        for i, size in zip(b.leaf_ids, b.sizes):
            flat[offs[i]:offs[i] + size] = red[off:off + size]
            off += size
    return flat


def _jax_apply(opt, w, g, state, step):
    w2, st2 = jax_optim.apply(opt, jnp.asarray(w), jnp.asarray(g),
                              {k: jnp.asarray(v) for k, v in state.items()},
                              jnp.asarray(step, jnp.int32))
    return np.asarray(w2), {k: np.asarray(v) for k, v in st2.items()}


def _flat(tree):
    return np.concatenate([np.asarray(x, np.float32).reshape(-1)
                           for x in jax.tree_util.tree_leaves(tree)])


def _unflat(flat, like):
    leaves, treedef = jax.tree_util.tree_flatten(like)
    out, off = [], 0
    for leaf in leaves:
        out.append(jnp.asarray(flat[off:off + leaf.size].reshape(
            leaf.shape), leaf.dtype))
        off += leaf.size
    return jax.tree_util.tree_unflatten(treedef, out)


def test_ddp_fused_matches_golden_composition():
    """The slice's collective (BFP sublane, fused kernels' route; their
    plain versions on the CPU) over 4 ranks, SGD: three steps against
    JAX's gradients through the golden composition, masters within the
    BFP flip bound; replicas bit-identical."""
    n = 4
    jp, pn = _jax_params()
    tr = _port_trainer("fused", n)
    state = tr.init_state(bert.from_jax_params(pn, "cpu"))
    plan = jax_bucketed.plan_buckets(pn, _coll(jcfg, "fused"), n)
    opt = jax_optim.OptimizerConfig(kind="sgd", learning_rate=LR)
    w_ref, st_ref, p_ref = _flat(pn), {}, jp
    rng = np.random.default_rng(3)
    atol = 0.0
    for step in range(STEPS):
        toks, labels = _data(rng)
        flat_g, gmax = _jax_grads(p_ref, toks, labels, n)
        w_ref, st_ref = _jax_apply(opt, w_ref,
                                   _golden_mean(_bucket(flat_g, plan), plan),
                                   st_ref, step)
        p_ref = _unflat(w_ref, jp)
        state, _ = tr.step(state, _port_batch(tr, toks, labels, n))
        atol += _flip_atol(n, gmax)
        np.testing.assert_allclose(state.w_master[0].numpy(), w_ref, rtol=0,
                                   atol=atol)
        assert replicas_identical(state)


def test_ddp_fused_bitexact_given_jax_grads():
    """The same JAX gradient rows through the port's bucketed all-reduce
    give the golden mean bit for bit on every rank; the slice's AdamW on
    it gives JAX's ``optim.apply`` masters within 1e-7 (XLA may fuse the
    elementwise chain)."""
    n = 4
    jp, pn = _jax_params()
    tr = _port_trainer("fused", n, opt="adamw")
    state = tr.init_state(bert.from_jax_params(pn, "cpu"))
    plan = jax_bucketed.plan_buckets(pn, _coll(jcfg, "fused"), n)
    toks, labels = _data(np.random.default_rng(4))
    rows = _bucket(_jax_grads(jp, toks, labels, n)[0], plan)
    want = _golden_mean(rows, plan)
    got = tr.all_reduce([torch.from_numpy(r.copy()) for r in rows])
    for r in range(n):
        np.testing.assert_array_equal(got[r].numpy(), want)
    new = tr.update(state, got)
    opt = jax_optim.OptimizerConfig(kind="adamw", learning_rate=1e-3,
                                    weight_decay=0.01)
    w_ref, st_ref = _jax_apply(opt, _flat(pn), want, {
        k: np.zeros_like(_flat(pn)) for k in ("m", "v")}, 0)
    np.testing.assert_allclose(new.w_master[0].numpy(), w_ref, rtol=0,
                               atol=1e-7)
    for k in ("m", "v"):
        np.testing.assert_allclose(new.opt_state[k][0].numpy(), st_ref[k],
                                   rtol=1e-6, atol=1e-12)
    assert replicas_identical(new) and new.step == 1


def test_dp_trainer_on_bert_matches_golden_composition():
    """The ZeRO-1 DPTrainer (the codec eval's "dp" arm) on the tiny BERT
    with the fused BFP ring and the fused SGD, 4 ranks: three steps
    against JAX's gradients through the golden reduce-scatter, the fused
    update's twin and the quantize-once gather, masters within the flip
    bound; replicas equal."""
    n = 4
    jp, pn = _jax_params(1)
    cfg = dataclasses.replace(
        _train_cfg(tcfg, "fused", n), collective=tcfg.CollectiveConfig(
            impl="ring", compression=tcfg.BFPConfig(codec="pallas"),
            fused_kernel=True, fused_optimizer=True))
    tr = DPTrainer(lambda p, b: bert.loss_fn(p, b, BERT, dp_size=n),
                   VirtualRanks(n, torch.device("cpu")), cfg)
    state = tr.init_state(bert.from_jax_params(pn, "cpu"))
    L_pad = state.w_own.numel()
    w_ref = np.pad(_flat(pn), (0, L_pad - _flat(pn).size)).reshape(n, -1)
    hyper = np.asarray(jax_optim.fused_hyperparams(
        jax_optim.OptimizerConfig(kind="sgd", learning_rate=LR)))
    p_ref = jp
    rng = np.random.default_rng(5)
    atol = 0.0
    for _ in range(STEPS):
        toks, labels = _data(rng)
        g, gmax = _jax_grads(p_ref, toks, labels, n)
        flat_g = np.pad(g, ((0, 0), (0, L_pad - g.shape[1])))
        g_sum = jax_ring_golden.ring_reduce_scatter(flat_g, jcfg.BFPConfig(),
                                                    "sublane")
        w_ref = np.stack([jax_optim.golden_fused_apply(
            "sgd", w_ref[i], g_sum[i], {}, hyper, n)[0] for i in range(n)])
        q = np.concatenate([jax_bfp_golden.bfp_decode(
            *jax_bfp_golden.bfp_encode(w, layout="sublane"),
            layout="sublane") for w in w_ref])
        p_ref = _unflat(q, jp)
        state, _ = tr.step(state, _port_batch(tr, toks, labels, n))
        atol += LR * 2.0 ** -6 * gmax     # one flip in the reduce-scatter
        np.testing.assert_allclose(state.w_own.numpy(), w_ref, rtol=0,
                                   atol=atol)
        reps = state.replicas
        assert bool((reps == reps[0]).all())


def test_ddp_unported_options_raise():
    ranks = VirtualRanks(2, torch.device("cpu"))
    base = dict(global_batch=4, mesh=tcfg.MeshConfig(dp=2))
    with pytest.raises(ValueError, match="integrity_check"):
        DDPTrainer(lambda p, b: None, ranks, tcfg.TrainConfig(
            **base, collective=tcfg.CollectiveConfig(
                impl="ring", integrity_check=True)))
    with pytest.raises(NotImplementedError, match="A.9"):
        DDPTrainer(lambda p, b: None, ranks,
                   tcfg.TrainConfig(**base, obs_metrics=True))
    # accumulation is ported (tests/test_torch_accum.py)
    assert DDPTrainer(lambda p, b: None, ranks, tcfg.TrainConfig(
        **base, accum_steps=2)).cfg.accum_steps == 2
    # codec="auto" resolves (tests/test_torch_tune.py): bucket_elems is
    # the tuner's, and the plan is in the statics
    auto = DDPTrainer(lambda p, b: None, ranks, tcfg.TrainConfig(
        **base, collective=tcfg.CollectiveConfig(impl="ring", codec="auto")))
    auto.init_state(bert.init(torch.Generator().manual_seed(0), BERT, "cpu"))
    assert auto.cfg.collective.codec != "auto"
    assert auto.obs_static_metrics()["tune"]["bucket_elems"] == \
        auto.cfg.collective.bucket_elems
    tr = _port_trainer("xla", 2)
    with pytest.raises(RuntimeError, match="init_state"):
        tr.obs_static_metrics()
    tr.init_state(bert.init(torch.Generator().manual_seed(0), BERT, "cpu"))
    # restore_state is ported (tests/test_torch_checkpoint.py): a payload
    # of JAX's stored layout rebuilds every rank's row
    st = tr.restore_state({"w_master": np.zeros(tr._meta.padded_len,
                                                 np.float32),
                           "opt_state": {}, "step": np.int32(3)})
    assert st.step == 3 and not bool(st.w_master.any())
    assert tr.obs_static_metrics()["n_buckets"] == len(tr.plan.buckets)
