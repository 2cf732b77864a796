"""pp with tp on the port (Megatron's 3-D layout) against the JAX package,
on the CPU.

The port stacks every virtual rank on one device: the rows are JAX's
``P((tp, pp, ep, dp))`` (row ``((t n_pp + s) n_ep + e) n_dp + d``) and a
pp loss takes each stage's tp ranks' trees as a list.  JAX runs the ranks
as devices of its 8-device CPU mesh under ``shard_map``.  JAX's own pp x
tp trainer tests are red on ``shard_map``'s out_specs typing (ROADMAP
C.4), so the port is held, as the pp x sp x ep path is, against:

- (a) JAX's ``loss_fn_pp(tp_axis="tp")`` on the mesh ``(dp, pp, tp)``
  under ``shard_map(check_vma=False)``, pmean'd over dp and tp (its values
  are usable; rtol 1e-5): the loss of ``ShardedTrainer.grads`` under
  GPipe, 1F1B and interleaved 1F1B (v = 2), dense and MoE (4 experts,
  capacity factor 16: nothing drops), at dp x pp x tp = (1, 2, 2) and
  (2, 2, 2);
- (b) ``jax.grad`` of JAX's unsharded ``loss_fn``: the trainer's rows,
  the shard sums taken, the dp ranks averaged and the shards joined
  (rtol 3e-4 / atol 3e-5, the pipeline tests' tolerance); dense at M = 2,
  MoE at M = 1 (at M = 2 a MoE pipeline's aux is a mean of
  per-microbatch statistics, which no unsharded loss computes);
- (c) two unsharded JAX SGD steps (rtol 5e-4 / atol 5e-5);
- (d) the port's own pp=1 x tp=2 and pp=2 x tp=1 routes: the same two
  steps' masters within the same tolerance;
- a kv-replicated case (tp = 4 > n_kv = 2: ``wk``/``wv`` replicate and
  each rank slices its head), the one-dp-rank entry points with
  ``tp_axis``, ``train_llama`` at ``--mesh.tp=2 --mesh.pp=2`` under each
  schedule, and a fault control: one stage's tp ranks handed to the loss
  out of rank order, whose gradients miss the reference far above the
  tolerance.
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
from jax.sharding import Mesh, PartitionSpec as P

from fpga_ai_nic_tpu.models import llama as jax_llama
from fpga_ai_nic_tpu_torch import train_llama
from fpga_ai_nic_tpu_torch.models import llama
from fpga_ai_nic_tpu_torch.ops import fused_update
from fpga_ai_nic_tpu_torch.parallel import pipeline
from fpga_ai_nic_tpu_torch.parallel.mesh import make_ranks
from fpga_ai_nic_tpu_torch.parallel.sharded import (ShardedTrainer, join_ep,
                                                    split_ep)
from fpga_ai_nic_tpu_torch.utils.config import (
    BFPConfig, CollectiveConfig, MeshConfig, OptimizerConfig, TrainConfig)

DENSE = jax_llama.LlamaConfig.tiny(n_layers=4)
MOE = dataclasses.replace(
    jax_llama.LlamaConfig.tiny(n_layers=4, ffn_dim=64), moe_experts=4,
    moe_top_k=2, moe_capacity_factor=16.0)
B, S = 8, 32
LOSS_TOL = dict(rtol=1e-5)
GRAD_TOL = dict(rtol=3e-4, atol=3e-5)
TRAIN_TOL = dict(rtol=5e-4, atol=5e-5)
SCHEDULES = (("gpipe", 2), ("1f1b", 2), ("1f1b-interleaved", 2))
# (dp, pp, tp)
MESHES = ((1, 2, 2), (2, 2, 2))


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _cfgs(moe):
    jc = MOE if moe else DENSE
    return jc, llama.LlamaConfig(**jc.__dict__)


@functools.lru_cache(maxsize=None)
def _jparams(moe, seed=0):
    return jax.tree_util.tree_map(
        np.asarray, jax_llama.init(jax.random.PRNGKey(seed), _cfgs(moe)[0]))


@functools.lru_cache(maxsize=None)
def _batch(seed=0):
    """Tokens and shifted labels, -100 masked unequally over the rows."""
    toks = np.random.default_rng(seed).integers(
        0, DENSE.vocab, (B, S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, : S // 2 + 3] = -100
    labels[2, :: 3] = -100
    labels[5, S // 2:] = -100
    return toks[:, :-1], labels


# -- the JAX side ------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_loss_pp(moe, dp, pp, tp, M):
    """JAX's ``loss_fn_pp(tp_axis="tp")`` on every device of the mesh
    (check_vma=False), pmean'd over dp and tp."""
    jc, _ = _cfgs(moe)
    names = ("dp", "pp", "tp")
    mesh = Mesh(np.asarray(jax.devices()[:dp * pp * tp]).reshape(
        dp, pp, tp), names)
    dp_axis = "dp" if dp > 1 else None

    def f(p, b):
        loss = jax_llama.loss_fn_pp(p, b, jc, pp_axis="pp",
                                    num_microbatches=M, tp_axis="tp",
                                    dp_axis=dp_axis)
        return lax.pmean(loss, ("dp", "tp"))[None]

    bspec = P("dp" if dp > 1 else None)
    specs = jax_llama.stacked_param_specs(jc, pp_axis="pp", tp_axis="tp",
                                          tp_size=tp)
    fn = jax.jit(jax.shard_map(f, mesh=mesh, in_specs=(specs, (bspec, bspec)),
                               out_specs=P(names), check_vma=False))
    out = np.asarray(fn(jax_llama.stack_params(_jparams(moe)),
                        tuple(map(jnp.asarray, _batch()))))
    np.testing.assert_allclose(out, out[0], rtol=1e-6)
    return float(out[0])


@functools.lru_cache(maxsize=None)
def _jax_vg(moe):
    jc, _ = _cfgs(moe)
    return jax.jit(jax.value_and_grad(
        lambda p, b: jax_llama.loss_fn(p, b, jc)))


@functools.lru_cache(maxsize=None)
def _jax_reference(moe):
    """``(value, stacked gradient)`` of JAX's unsharded ``loss_fn``."""
    val, g = _jax_vg(moe)(_jparams(moe), tuple(map(jnp.asarray, _batch())))
    return float(val), jax.tree_util.tree_map(np.asarray,
                                              jax_llama.stack_params(g))


@functools.lru_cache(maxsize=None)
def _ref_steps(moe, steps=2, lr=0.1):
    vg = _jax_vg(moe)
    jb = tuple(map(jnp.asarray, _batch()))
    p = _jparams(moe)
    for _ in range(steps):
        _, g = vg(p, jb)
        p = jax.tree_util.tree_map(
            lambda w, gg: (w.astype(jnp.float32)
                           - lr * gg.astype(jnp.float32)).astype(w.dtype),
            p, g)
    return jax.tree_util.tree_map(np.asarray, jax_llama.stack_params(p))


# -- the port side -----------------------------------------------------------------

def _trainer(moe, dp, pp, tp, schedule, M, coll=None, lr=0.1, pc=None):
    pc = pc or _cfgs(moe)[1]
    cfg = TrainConfig(global_batch=B, mesh=MeshConfig(dp=dp, pp=pp, tp=tp),
                      collective=coll or CollectiveConfig(impl="xla"),
                      optimizer=OptimizerConfig(kind="sgd", learning_rate=lr))
    ranks = make_ranks(cfg.mesh, "cpu")
    tp_axis = "tp" if tp > 1 else None
    v = 2 if schedule == "1f1b-interleaved" else 1
    if pp == 1:
        def loss(p, b):
            # the rank's mean NLL reweighted to its share of the global
            # token count (the weighting loss_fn_pp's dp_size gives)
            valid = (b[1] >= 0).sum().to(torch.float32)
            return llama.loss_fn(p, b[:2], pc, tp_axis=tp_axis) * (
                dp * valid / b[2].to(torch.float32))
        return ShardedTrainer(loss, ranks, cfg, param_specs=llama.param_specs(
            pc, tp_axis, tp_size=tp))
    specs = llama.stacked_param_specs(pc, tp_axis=tp_axis, tp_size=tp)
    if moe:
        if schedule == "gpipe":
            return ShardedTrainer(
                llama.pp_dp_loss_fn(pc, dp, num_microbatches=M, remat=True),
                ranks, cfg, param_specs=specs)
        return ShardedTrainer(None, ranks, cfg, param_specs=specs,
                              loss_and_grads_fn=llama.pp_dp_loss_and_grads_fn(
                                  pc, dp, num_microbatches=M,
                                  virtual_stages=v, remat=True))
    kw = dict(num_microbatches=M, tp_axis=tp_axis, dp_size=dp, remat=True)
    if schedule == "gpipe":
        return ShardedTrainer(lambda p, b: llama.loss_fn_pp(p, b, pc, **kw),
                              ranks, cfg, param_specs=specs)
    return ShardedTrainer(
        None, ranks, cfg, param_specs=specs,
        loss_and_grads_fn=lambda p, b, out=None: llama.loss_and_grads_pp_1f1b(
            p, b, pc, virtual_stages=v, out=out, **kw))


def _params(moe, schedule, pp=2):
    tree = llama.params_from_jax(_jparams(moe), "cpu")
    if pp == 1:
        return tree
    tree = llama.stack_params(tree)
    if schedule == "1f1b-interleaved":
        tree["layers"] = pipeline.interleave_layers(tree["layers"], pp, 2)
    return tree


def _sharded_batch(tr):
    """Tokens and labels by ``shard_batch``; a dense model's dp ranks also
    carry the global label count (JAX's ``dp_axis`` weighting)."""
    toks, labels = map(torch.from_numpy, _batch())
    sb = tr.shard_batch((toks, labels))
    if getattr(tr.loss_and_grads_fn or tr.loss_fn, "joint_ranks", False):
        return sb
    return sb + ((labels >= 0).sum().expand(tr.n).contiguous(),)


def _joined_grads(tr, flat_g, schedule):
    g = flat_g.view(tr.n_shards, tr.n, -1).sum(1) / tr.n
    tree = join_ep([tr._grad_tree(row) for row in g], tr.param_specs,
                   tr._grid())
    if schedule == "1f1b-interleaved":
        tree["layers"] = pipeline.deinterleave_layers(tree["layers"], 2, 2)
    return tree


def _whole(tr, state, schedule, pp=2):
    tree = tr.global_params(state)
    if pp == 1:
        return llama.stack_params(tree)
    if schedule == "1f1b-interleaved":
        tree["layers"] = pipeline.deinterleave_layers(tree["layers"], pp, 2)
    return tree


def _assert_tree_close(got, want, tol):
    got_l = fused_update._leaves(got)
    want_l = jax.tree_util.tree_leaves(want)
    assert len(got_l) == len(want_l)
    for (path, g), w in zip(got_l, want_l):
        np.testing.assert_allclose(_np(g), np.asarray(w, np.float32), **tol,
                                   err_msg=str(path))


def _max_rel(got, want):
    """The largest relative error over the leaves (scale: each leaf's max)."""
    out = 0.0
    for (_, g), w in zip(fused_update._leaves(got),
                         jax.tree_util.tree_leaves(want)):
        w = np.asarray(w, np.float32)
        out = max(out, float(np.abs(_np(g) - w).max()
                             / max(np.abs(w).max(), 1e-12)))
    return out


@functools.lru_cache(maxsize=None)
def _port_grads(moe, dp, tp, schedule, M):
    tr = _trainer(moe, dp, 2, tp, schedule, M)
    state = tr.init_state(_params(moe, schedule))
    flat_g, loss = tr.grads(state, _sharded_batch(tr))
    return float(loss), _joined_grads(tr, flat_g, schedule)


# -- (a) / (b) losses and gradients ---------------------------------------------

@pytest.mark.parametrize("schedule,M", SCHEDULES)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_pp_tp_loss_and_grads_match_jax(moe, mesh, schedule, M):
    """(a) the trainer's loss against JAX's ``loss_fn_pp(tp_axis="tp")``;
    (b) its joined gradient against ``jax.grad`` of the unsharded loss
    (dense; MoE at M = 1, where the pipelined aux is the unsharded one),
    and the 1F1B schedules against GPipe, leaf for leaf."""
    dp, pp, tp = mesh
    if moe:
        M = 1 if schedule == "gpipe" else 2
    want_loss = _jax_loss_pp(moe, dp, pp, tp, M)
    loss, grads = _port_grads(moe, dp, tp, schedule, M)
    np.testing.assert_allclose(loss, want_loss, **LOSS_TOL)
    if not moe or M == 1:
        ref_val, ref_grads = _jax_reference(moe)
        np.testing.assert_allclose(ref_val, want_loss, **LOSS_TOL)
        _assert_tree_close(grads, ref_grads, GRAD_TOL)
    if schedule != "gpipe":
        _, gpipe = _port_grads(moe, dp, tp, "gpipe", M)
        for (path, a), (_, b) in zip(fused_update._leaves(grads),
                                     fused_update._leaves(gpipe)):
            np.testing.assert_allclose(_np(a), _np(b), **GRAD_TOL,
                                       err_msg=str(path))


# -- (c) / (d) the trainer ---------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _port_steps(moe, dp, pp, tp, schedule, M=2, steps=2):
    tr = _trainer(moe, dp, pp, tp, schedule, M)
    state = tr.init_state(_params(moe, schedule, pp))
    sb = _sharded_batch(tr)
    losses = []
    for _ in range(steps):
        state, loss = tr.step(state, sb)
        losses.append(float(loss))
    return tr, state, losses


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b", "1f1b-interleaved"])
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
def test_pp_tp_training_matches_jax_and_port_routes(mesh, schedule):
    """Two SGD steps (lr 0.1, M = 2, dense): (c) the joined masters
    against two unsharded JAX steps; (d) against the port's pp=1 x tp=2
    and pp=2 x tp=1 routes on the same batch; the replicas equal within
    each (tp, pp) group, a leaf's copies equal across the rows that hold
    it."""
    dp, pp, tp = mesh
    tr, state, losses = _port_steps(False, dp, pp, tp, schedule)
    assert np.isfinite(losses).all() and losses[1] < losses[0]
    got = _whole(tr, state, schedule)
    _assert_tree_close(got, _ref_steps(False), TRAIN_TOL)
    for other in ((dp, 1, tp, "gpipe"), (dp, pp, 1, schedule)):
        tr_o, st_o, _ = _port_steps(False, *other)
        _assert_tree_close(got, jax.tree_util.tree_map(
            _np, _whole(tr_o, st_o, other[3], other[1])), TRAIN_TOL)
    reps = state.replicas.view(tp * pp, dp, -1)
    assert (reps == reps[:, :1]).all()
    r3 = reps.view(tp, pp, dp, -1)
    for a, b, axes in tr._shard_spans:
        for ax in axes:
            dim = ("tp", "pp").index(ax)
            first = r3[:1] if dim == 0 else r3[:, :1]
            torch.testing.assert_close(r3[..., a:b], first[..., a:b].expand(
                r3[..., a:b].shape), rtol=0, atol=0)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_pp_tp_moe_training_matches_jax(schedule):
    """MoE (experts' hidden split over tp) at dp=1 x pp=2 x tp=2, M = 1:
    two SGD steps against two unsharded JAX steps."""
    tr, state, losses = _port_steps(True, 1, 2, 2, schedule, M=1)
    assert np.isfinite(losses).all()
    _assert_tree_close(_whole(tr, state, schedule), _ref_steps(True),
                       TRAIN_TOL)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_pp_tp_kv_replication(schedule):
    """tp = 4 > n_kv = 2 under pp = 2: ``wk``/``wv`` replicate over tp
    (spec ``"pp"``) and each rank slices its query group's kv head; the
    loss against JAX's ``loss_fn_pp`` on the (1, 2, 4) mesh, the
    gradient against ``jax.grad``, and the replicated ``wk`` rows summed
    over the stage's tp rows."""
    _, pc = _cfgs(False)
    specs = llama.stacked_param_specs(pc, tp_axis="tp", tp_size=4)
    assert specs["layers"]["wk"] == "pp"
    want_loss = _jax_loss_pp(False, 1, 2, 4, 2)
    tr = _trainer(False, 1, 2, 4, schedule, 2)
    state = tr.init_state(_params(False, schedule))
    flat_g, loss = tr.grads(state, _sharded_batch(tr))
    np.testing.assert_allclose(float(loss), want_loss, **LOSS_TOL)
    _assert_tree_close(_joined_grads(tr, flat_g, schedule),
                       _jax_reference(False)[1], GRAD_TOL)
    assert any("tp" in axes and "pp" not in axes
               for _, _, axes in tr._shard_spans)


def test_one_dp_rank_entry_points_with_tp():
    """``apply_pp``, ``loss_fn_pp`` and ``loss_and_grads_pp_1f1b`` on one
    dp rank's stages, each its tp ranks' trees: the logits against JAX's
    unsharded ``apply``, both losses against JAX's ``loss_fn_pp``, and the
    1F1B gradients (tp rank 0's embedding, zero in the other copies)
    against GPipe's through autograd, joined into the whole tree."""
    jc, pc = _cfgs(False)
    specs = llama.stacked_param_specs(pc, tp_axis="tp", tp_size=2)
    stacked = _params(False, "gpipe")
    leaves = [t.requires_grad_() for t in fused_update.tree_leaves(stacked)]
    rows = split_ep(stacked, specs, {"tp": 2, "pp": 2})
    stages = [[rows[0], rows[2]], [rows[1], rows[3]]]
    toks, labels = map(torch.from_numpy, _batch())
    kw = dict(num_microbatches=2, tp_axis="tp")
    want = np.asarray(jax.jit(lambda p, t: jax_llama.apply(p, t, jc))(
        _jparams(False), jnp.asarray(_batch()[0])))
    with torch.no_grad():
        got = llama.apply_pp(stages, toks, pc, **kw)
    np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="tp_axis"):
        llama.loss_fn_pp(stages, (toks, labels), pc, num_microbatches=2)
    loss = llama.loss_fn_pp(stages, (toks, labels), pc, remat=True, **kw)
    want_loss = _jax_loss_pp(False, 1, 2, 2, 2)
    np.testing.assert_allclose(float(loss.detach()), want_loss, **LOSS_TOL)
    g_gpipe = torch.autograd.grad(loss, leaves)
    loss_1f1b, g_rows = llama.loss_and_grads_pp_1f1b(
        stages, (toks, labels), pc, remat=True, **kw)
    np.testing.assert_allclose(float(loss_1f1b), want_loss, **LOSS_TOL)
    assert not g_rows[0][1]["tok_emb"].any()
    whole = [torch.zeros_like(t) for t in leaves]
    views = split_ep(fused_update.tree_from_leaves(
        tuple(p for p, _ in fused_update._leaves(stacked)), whole), specs,
        {"tp": 2, "pp": 2})
    by_row = [g_rows[0][0], g_rows[1][0], g_rows[0][1], g_rows[1][1]]
    for i, (v, g) in enumerate(zip(views, by_row)):
        s = i % 2
        for vv, gg, spec in zip(fused_update.tree_leaves(v),
                                fused_update.tree_leaves(g),
                                fused_update.tree_leaves(specs)):
            dims = llama.spec_dims(spec)
            # a leaf split over pp (and maybe tp) is its row's own; the
            # others summed once: the head's from any stage (the same in
            # each), the embedding and norms from stage 0
            if "pp" in dims or s == 0:
                vv.add_(gg)
    for a, b in zip(whole, g_gpipe):
        np.testing.assert_allclose(_np(a), _np(b), **GRAD_TOL)


def test_pp_tp_fault_control(monkeypatch):
    """A control the parity must catch: stage 1's tp ranks handed to the
    loss out of rank order (their heads concatenated backwards) moves
    the gradient far above the tolerance."""
    tr = _trainer(False, 1, 2, 2, "gpipe", 2)
    state = tr.init_state(_params(False, "gpipe"))
    good = tr._stage_units

    def swapped(trees, joint):
        out = good(trees, joint)
        return [out[0], out[1][::-1]]

    monkeypatch.setattr(tr, "_stage_units", swapped)
    flat_g, loss = tr.grads(state, _sharded_batch(tr))
    err = _max_rel(_joined_grads(tr, flat_g, "gpipe"),
                   _jax_reference(False)[1])
    assert err > 100 * GRAD_TOL["rtol"], err


def test_pp_tp_bfp_ring_replicas_and_layout():
    """dp=2 x pp=2 x tp=2 on the BFP ring kernels' route (their plain
    versions on the CPU): the rows in ``P((tp, pp, dp))`` order, every
    (tp, pp) group's replicas equal, and the norm tables weighting a
    leaf 1 / (its copies over tp x pp)."""
    coll = CollectiveConfig(impl="ring", compression=BFPConfig(
        codec="pallas"), fused_kernel=True)
    tr = _trainer(False, 2, 2, 2, "1f1b", 2, coll=coll)
    state = tr.init_state(_params(False, "1f1b"))
    assert tr._grid() == {"tp": 2, "pp": 2, "ep": 1}
    assert state.replicas.shape[0] == 8
    state, loss = tr.step(state, _sharded_batch(tr))
    assert np.isfinite(float(loss))
    reps = state.replicas.view(4, 2, -1)
    assert (reps == reps[:, :1]).all()
    _, values = tr.norm_weight_tables()
    assert set(np.unique(values).tolist()) >= {0.25, 0.5, 1.0}


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b", "1f1b-interleaved"])
def test_train_llama_driver_pp_tp(schedule):
    """``train_llama --mesh.tp=2 --mesh.pp=2`` under each schedule on the
    CPU: finite losses, the mesh and the pipeline cost in its line, the
    same first loss as the pp=2 x tp=1 driver on the same seed."""
    argv = ["--model=tiny", "--device=cpu", "--model.n_layers=4",
            "--seq=32", "--global_batch=4", "--mesh.pp=2",
            "--microbatches=2", f"--pp_schedule={schedule}", "--iters=1"]
    if schedule == "1f1b-interleaved":
        argv.append("--virtual_stages=2")
    out = train_llama.main(argv + ["--mesh.tp=2"])
    assert out["mesh"]["tp"] == 2 and out["mesh"]["pp"] == 2
    assert np.isfinite([out["loss_first"], out["loss_last"]]).all()
    assert out["tokens_per_sec"] > 0
    assert out["pipeline_cost"]["schedule"] == schedule
    ref = train_llama.main(argv)
    np.testing.assert_allclose(out["loss_first"], ref["loss_first"],
                               rtol=1e-5)
