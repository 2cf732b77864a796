"""The pipeline with every batch axis on the port against the JAX package,
on the CPU: pp together with sp, ep and MoE layers.

The port stacks every virtual rank on one device (batch ``[n_dp, n_ep,
n_sp, B, S_local]``, rows ``P((pp, ep, dp))``); JAX runs the ranks as
devices of an 8-device CPU mesh under ``shard_map``.  The same seeded
numpy inputs (JAX's ``init`` weights carried across with
``params_from_jax``; labels masked with -100, unequally across the dp,
ep and sp shards) go through both, on the tiny Llama at 4 layers, dense
or MoE (4 experts, top-2, ffn 64, capacity factor 16: nothing drops), at
the meshes ``("dp", "pp", "sp")`` (dense), ``("pp", "sp")``, ``("dp",
"pp", "ep")`` and ``("pp", "sp", "ep")`` (MoE), 2 a mesh axis:

- (a) the loss of ``ShardedTrainer.grads`` under GPipe, 1F1B (M = 1 and
  2) and interleaved 1F1B (v = 2; M = 2, since it needs M % pp == 0)
  against JAX's ``loss_fn_pp`` under ``jax.shard_map(...,
  check_vma=False)``, pmean'd over the non-pp axes (rtol 1e-5); so are
  the one-dp-rank entry points with ``sp_axis`` and ``ep_axis``
  (``apply_pp``'s logits against JAX's unsharded ``apply``,
  ``loss_fn_pp``, and ``loss_and_grads_pp_1f1b`` against GPipe);
- (b) the gradient the trainer's rows give (the shard sums taken, the dp
  ranks averaged, the shards joined) against JAX's unsharded
  ``jax.grad(loss_fn)`` where the pipelined loss equals it: dense at M
  = 2, MoE at M = 1 (rtol 3e-4 / atol 3e-5, JAX's own 1F1B tests').
  JAX's per-device gradients under ``check_vma=False`` are off by 1-2
  relative (ROADMAP C.4), so they are no oracle;
- (c) MoE at M = 2: the aux is a mean of per-microbatch statistics, so
  the reference is ``jax.grad`` of a JAX-side composition, the
  unsharded token-weighted cross-entropy plus the mean over m of JAX's
  aux on microbatch m (the m-th microbatch of every batch rank, taken
  together), whose value first equals (a)'s JAX value; and the 1F1B
  schedules against the port's GPipe, leaf for leaf;
- (d) ``ShardedTrainer`` two SGD steps against two JAX SGD steps of the
  same objective (rtol 5e-4 / atol 5e-5) at dp=2 x pp=2 x sp=2 (dense),
  dp=2 x pp=2 x ep=2 and dp=1 x pp=2 x ep=2 x sp=2 (MoE), GPipe and
  1F1B; the BFP ring at dp=2 x pp=2 x ep=2 against the numpy golden
  composition on JAX's (pp, ep, dp) layout;
- (e) the layouts: ``stacked_param_specs(ep_axis="ep")``, the batch
  under ``P((dp, ep), sp)`` on meshes with pp, the flat master rows
  (JAX's ``_waxes`` order and per-device shards) and
  ``norm_weight_tables`` against JAX's ``ShardedTrainer``;
- (f) ``train_llama`` with MoE at pp=2 x ep=2 x sp=2 under each
  schedule.
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
from fpga_ai_nic_tpu.ops import bfp_golden as jax_bfp_golden
from fpga_ai_nic_tpu.ops import ring_golden as jax_ring_golden
from fpga_ai_nic_tpu.parallel import ShardedTrainer as JaxShardedTrainer
from fpga_ai_nic_tpu.parallel import mesh as jax_mesh
from fpga_ai_nic_tpu.utils import config as jcfg
from fpga_ai_nic_tpu_torch import train_llama
from fpga_ai_nic_tpu_torch.models import llama
from fpga_ai_nic_tpu_torch.ops import fused_update
from fpga_ai_nic_tpu_torch.parallel import pipeline
from fpga_ai_nic_tpu_torch.parallel.mesh import VirtualRanks, make_ranks
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
# mesh name -> (dp, pp, sp, ep, MoE layers)
MESHES = {"dp_pp_sp": (2, 2, 2, 1, False), "pp_sp": (1, 2, 2, 1, True),
          "dp_pp_ep": (2, 2, 1, 2, True), "pp_sp_ep": (1, 2, 2, 2, True)}
CASES = [(mesh, sched, M) for mesh in MESHES
         for sched, M in (("gpipe", 1), ("gpipe", 2), ("1f1b", 1),
                          ("1f1b", 2), ("1f1b-interleaved", 2))]


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
    """Tokens and globally shifted labels, -100 masked unequally over the
    rows (the dp and ep ranks) and the sequence halves (the sp shards)."""
    toks = np.random.default_rng(seed).integers(
        0, DENSE.vocab, (B, S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, : S // 2 + 3] = -100
    labels[1, S - 5:] = -100
    labels[2, :: 3] = -100
    labels[5, S // 2:] = -100
    labels[6, :7] = -100
    return toks[:, :-1], labels


# -- the JAX side ------------------------------------------------------------------

def _axes(dp, pp, sp, ep):
    names = [a for a, k in (("dp", dp), ("pp", pp), ("sp", sp), ("ep", ep))
             if k > 1 or a == "pp"]
    sizes = {"dp": dp, "pp": pp, "sp": sp, "ep": ep}
    return tuple(names), tuple(sizes[a] for a in names)


def _bspec(dp, sp, ep):
    rows = tuple(a for a, k in (("dp", dp), ("ep", ep)) if k > 1)
    return P(rows if len(rows) > 1 else (rows[0] if rows else None),
             "sp" if sp > 1 else None)


@functools.lru_cache(maxsize=None)
def _jax_loss_pp(mesh_name, M):
    """JAX's ``loss_fn_pp`` on every device of the mesh (check_vma=False),
    pmean'd over the non-pp axes: every device's value."""
    dp, pp, sp, ep, moe = MESHES[mesh_name]
    jc, _ = _cfgs(moe)
    names, shape = _axes(dp, pp, sp, ep)
    mesh = Mesh(np.asarray(jax.devices()[:int(np.prod(shape))]).reshape(
        shape), names)
    kw = dict(dp_axis="dp" if dp > 1 else None,
              sp_axis="sp" if sp > 1 else None,
              ep_axis="ep" if ep > 1 else None)
    non_pp = tuple(a for a in names if a != "pp")

    def f(p, b):
        loss = jax_llama.loss_fn_pp(p, b, jc, pp_axis="pp",
                                    num_microbatches=M, **kw)
        return (lax.pmean(loss, non_pp) if non_pp else loss)[None]

    bspec = _bspec(dp, sp, ep)
    specs = jax_llama.stacked_param_specs(jc, pp_axis="pp", tp_axis=None,
                                          ep_axis=kw["ep_axis"])
    fn = jax.jit(jax.shard_map(f, mesh=mesh, in_specs=(specs, (bspec, bspec)),
                               out_specs=P(names), check_vma=False))
    out = np.asarray(fn(jax_llama.stack_params(_jparams(moe)),
                        tuple(map(jnp.asarray, _batch()))))
    np.testing.assert_allclose(out, out[0], rtol=1e-6)
    return float(out[0])


def _micro_rows(dp, ep, M):
    """The global rows of microbatch m: the m-th microbatch of every (dp,
    ep) rank's rows (``P((dp, ep))``: rank (d, e) holds rows (d ep + e)
    b onward)."""
    b = B // (dp * ep)
    mb = b // M
    return [np.concatenate([np.arange(r * b + m * mb, r * b + (m + 1) * mb)
                            for r in range(dp * ep)]) for m in range(M)]


def _objective(jc, dp, ep, M):
    """The loss the pipelined trainer computes, on one device: the
    unsharded token-weighted cross-entropy plus the mean over the
    microbatches of JAX's aux on microbatch m (all of it at M = 1: the
    unsharded ``loss_fn``)."""
    rows = _micro_rows(dp, ep, M)

    def loss(p, batch):
        toks, labels = batch
        if jc.moe is None or M == 1:
            return jax_llama.loss_fn(p, batch, jc)
        logits = jax_llama.apply(p, toks, jc)
        valid = labels >= 0
        logz = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
        nll = -jnp.take_along_axis(logz, jnp.where(valid, labels, 0)[..., None],
                                   axis=-1)[..., 0]
        ce = jnp.sum(jnp.where(valid, nll, 0.0)) / jnp.maximum(
            jnp.sum(valid), 1)
        aux = [jax_llama.apply(p, toks[r], jc, with_aux=True)[1]
               for r in rows]
        return ce + sum(aux) / M
    return loss


@functools.lru_cache(maxsize=None)
def _objective_vg(moe, dp, ep, M):
    """The jitted value and gradient of ``_objective`` (one for every
    layout when dense or at M = 1: the unsharded ``loss_fn``)."""
    if not moe or M == 1:
        dp, ep, M = 1, 1, 1
    return jax.jit(jax.value_and_grad(_objective(_cfgs(moe)[0], dp, ep, M)))


@functools.lru_cache(maxsize=None)
def _jax_reference(mesh_name, M):
    """``(value, stacked gradient)`` of ``_objective`` at the mesh's batch
    layout."""
    dp, _, _, ep, moe = MESHES[mesh_name]
    val, g = _objective_vg(moe, dp, ep, M)(
        _jparams(moe), tuple(map(jnp.asarray, _batch())))
    return float(val), jax.tree_util.tree_map(np.asarray,
                                              jax_llama.stack_params(g))


# -- the port side -----------------------------------------------------------------

def _trainer(mesh_name, schedule, M, coll=None, lr=0.1):
    dp, pp, sp, ep, moe = MESHES[mesh_name]
    _, pc = _cfgs(moe)
    cfg = TrainConfig(global_batch=B, mesh=MeshConfig(dp=dp, pp=pp, sp=sp,
                                                      ep=ep),
                      collective=coll or CollectiveConfig(impl="xla"),
                      optimizer=OptimizerConfig(kind="sgd", learning_rate=lr))
    ranks = make_ranks(cfg.mesh, "cpu")
    v = 2 if schedule == "1f1b-interleaved" else 1
    specs = llama.stacked_param_specs(pc, ep_axis="ep" if ep > 1 else None)
    if moe:
        if schedule == "gpipe":
            return ShardedTrainer(
                llama.pp_dp_loss_fn(pc, dp, ep, n_sp=sp, num_microbatches=M,
                                    remat=True), ranks, cfg,
                param_specs=specs)
        return ShardedTrainer(None, ranks, cfg, param_specs=specs,
                              loss_and_grads_fn=llama.pp_dp_loss_and_grads_fn(
                                  pc, dp, ep, n_sp=sp, num_microbatches=M,
                                  virtual_stages=v, remat=True))
    # a dense model, one dp rank at a time: the global count rides the
    # batch (JAX's dp_axis weighting)
    kw = dict(num_microbatches=M, sp_axis="sp" if sp > 1 else None,
              dp_size=dp, remat=True)
    if schedule == "gpipe":
        return ShardedTrainer(lambda p, b: llama.loss_fn_pp(p, b, pc, **kw),
                              ranks, cfg, param_specs=specs)
    return ShardedTrainer(
        None, ranks, cfg, param_specs=specs,
        loss_and_grads_fn=lambda p, b, out=None: llama.loss_and_grads_pp_1f1b(
            p, b, pc, virtual_stages=v, out=out, **kw))


def _stacked(moe, schedule, pp=2):
    tree = llama.stack_params(llama.params_from_jax(_jparams(moe), "cpu"))
    if schedule == "1f1b-interleaved":
        tree["layers"] = pipeline.interleave_layers(tree["layers"], pp, 2)
    return tree


def _sharded_batch(tr):
    """The trainer's batch: tokens and labels by ``shard_batch``; a dense
    model's dp ranks also carry the global label count (one a rank)."""
    toks, labels = map(torch.from_numpy, _batch())
    sb = tr.shard_batch((toks, labels))
    if getattr(tr.loss_and_grads_fn or tr.loss_fn, "joint_ranks", False):
        return sb
    return sb + ((labels >= 0).sum().expand(tr.n).contiguous(),)


def _joined_grads(tr, flat_g, schedule):
    """The trainer's rows as one stacked gradient tree: the dp ranks
    averaged (the trainer's reduce / n_dp), the pp x ep shards joined,
    the layers back in model order."""
    g = flat_g.view(tr.n_shards, tr.n, -1).sum(1) / tr.n
    tree = join_ep([tr._grad_tree(row) for row in g], tr.param_specs,
                   tr._grid())
    if schedule == "1f1b-interleaved":
        tree["layers"] = pipeline.deinterleave_layers(tree["layers"], 2, 2)
    return tree


@functools.lru_cache(maxsize=None)
def _port_grads(mesh_name, schedule, M):
    tr = _trainer(mesh_name, schedule, M)
    state = tr.init_state(_stacked(MESHES[mesh_name][4], schedule))
    flat_g, loss = tr.grads(state, _sharded_batch(tr))
    return float(loss), _joined_grads(tr, flat_g, schedule)


def _assert_tree_close(got, want, tol):
    got_l = fused_update._leaves(got)
    want_l = jax.tree_util.tree_leaves(want)
    assert len(got_l) == len(want_l)
    for (path, g), w in zip(got_l, want_l):
        np.testing.assert_allclose(_np(g), np.asarray(w, np.float32), **tol,
                                   err_msg=str(path))


# -- (a)-(c) losses and gradients ------------------------------------------------

@pytest.mark.parametrize("mesh_name,schedule,M", CASES)
def test_pp_axes_loss_and_grads_match_jax(mesh_name, schedule, M):
    """(a) the loss against JAX's ``loss_fn_pp``; (b) / (c) the gradient
    against ``jax.grad`` of the objective (unsharded where it equals the
    pipelined loss, the per-microbatch-aux composition for MoE at M = 2,
    whose value equals JAX's pipelined one), and 1F1B against GPipe."""
    moe = MESHES[mesh_name][4]
    want_loss = _jax_loss_pp(mesh_name, M)
    ref_val, ref_grads = _jax_reference(mesh_name, M)
    np.testing.assert_allclose(ref_val, want_loss, **LOSS_TOL)
    loss, grads = _port_grads(mesh_name, schedule, M)
    np.testing.assert_allclose(loss, want_loss, **LOSS_TOL)
    _assert_tree_close(grads, ref_grads, GRAD_TOL)
    if moe and M > 1:
        assert abs(ref_val - _jax_reference(mesh_name, 1)[0]) > 1e-7
    if schedule != "gpipe":
        _, gpipe = _port_grads(mesh_name, "gpipe", M)
        for (path, a), (_, b) in zip(fused_update._leaves(grads),
                                     fused_update._leaves(gpipe)):
            np.testing.assert_allclose(_np(a), _np(b), **GRAD_TOL,
                                       err_msg=str(path))


@pytest.mark.parametrize("M", [1, 2])
def test_one_dp_rank_entry_points_with_sp_and_ep(M):
    """``apply_pp``, ``loss_fn_pp`` and ``loss_and_grads_pp_1f1b`` on one
    dp rank's ep ranks and sp shards at pp=2 x ep=2 x sp=2 (``params[s]``
    the ep ranks' trees of stage s, tokens ``[n_ep, n_sp, B, S_local]``):
    the logits against JAX's unsharded ``apply``, both losses against
    JAX's ``loss_fn_pp`` on the mesh ``("pp", "sp", "ep")``, and the 1F1B
    gradients, joined into the whole tree, against GPipe's through
    autograd."""
    jc, pc = _cfgs(True)
    specs = llama.stacked_param_specs(pc, ep_axis="ep")
    stacked = _stacked(True, "gpipe")
    leaves = [t.requires_grad_() for t in fused_update.tree_leaves(stacked)]
    rows = split_ep(stacked, specs, {"pp": 2, "ep": 2})
    stages = [rows[:2], rows[2:]]
    toks, labels = (x[0] for x in VirtualRanks(
        1, torch.device("cpu"), 2, 2, 2).shard_batch(
            tuple(map(torch.from_numpy, _batch()))))
    kw = dict(num_microbatches=M, sp_axis="sp", ep_axis="ep")
    want = np.asarray(jax.jit(lambda p, t: jax_llama.apply(p, t, jc))(
        _jparams(True), jnp.asarray(_batch()[0])))
    want = want.reshape(2, B // 2, 2, S // 2, -1).transpose(0, 2, 1, 3, 4)
    with torch.no_grad():
        got = llama.apply_pp(stages, toks, pc, **kw)
    np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=1e-5)
    loss = llama.loss_fn_pp(stages, (toks, labels), pc, remat=True, **kw)
    want_loss = _jax_loss_pp("pp_sp_ep", M)
    np.testing.assert_allclose(float(loss.detach()), want_loss, **LOSS_TOL)
    g_gpipe = torch.autograd.grad(loss, leaves)
    loss_1f1b, g_rows = llama.loss_and_grads_pp_1f1b(
        stages, (toks, labels), pc, remat=True, **kw)
    np.testing.assert_allclose(float(loss_1f1b), want_loss, **LOSS_TOL)
    whole = [torch.zeros_like(t) for t in leaves]
    views = split_ep(fused_update.tree_from_leaves(
        tuple(p for p, _ in fused_update._leaves(stacked)), whole), specs,
        {"pp": 2, "ep": 2})
    for i, (v, g) in enumerate(zip(views, [t for st in g_rows for t in st])):
        for vv, gg, spec in zip(fused_update.tree_leaves(v),
                                fused_update.tree_leaves(g),
                                fused_update.tree_leaves(specs)):
            if spec is not None or i < 2:   # the stage sums: stage 0's
                vv.add_(gg)
    for a, b in zip(whole, g_gpipe):
        np.testing.assert_allclose(_np(a), _np(b), **GRAD_TOL)


def test_pp_moe_layers_route_each_microbatch_over_every_rank(monkeypatch):
    """A stage's MoE layer routes microbatch m of every (dp, ep, sp)
    device at once: one pooled statistics set a (microbatch, layer, unit
    run), over all of the microbatch's tokens, nothing dropped."""
    from fpga_ai_nic_tpu_torch.ops import moe as moe_ops
    seen = []
    ranks = moe_ops.moe_ranks

    def spy(*a):
        y, parts = ranks(*a)
        seen.append(parts)
        return y, parts

    monkeypatch.setattr(moe_ops, "moe_ranks", spy)
    tr = _trainer("pp_sp_ep", "gpipe", 2)
    state = tr.init_state(_stacked(True, "gpipe"))
    tr.grads(state, _sharded_batch(tr))
    # one call a (layer, microbatch) in the forward: 4 x 2 (remat's
    # recomputation of the last layer stops early, JAX's order)
    assert len(seen) >= 4 * 2
    for p in seen:
        assert p.n_tok == B // 2 * S and p.n_ranks == 4
        assert float(moe_ops._stats_from_routing(p, 2)["drop_frac"]) == 0.0


# -- (d) the trainer -------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ref_steps(mesh_name, M, steps=2, lr=0.1):
    dp, _, _, ep, moe = MESHES[mesh_name]
    vg = _objective_vg(moe, dp, ep, M)
    jb = tuple(map(jnp.asarray, _batch()))
    p = _jparams(moe)
    for _ in range(steps):
        _, g = vg(p, jb)
        p = jax.tree_util.tree_map(
            lambda w, gg: (w.astype(jnp.float32)
                           - lr * gg.astype(jnp.float32)).astype(w.dtype),
            p, g)
    return jax.tree_util.tree_map(np.asarray, jax_llama.stack_params(p))


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
@pytest.mark.parametrize("mesh_name", ["dp_pp_sp", "dp_pp_ep", "pp_sp_ep"])
def test_pp_axes_training_matches_jax_steps(mesh_name, schedule):
    """Two SGD steps (lr 0.1, M = 2) against two JAX steps of the same
    objective: every leaf of the joined masters, the replicas equal
    within each (pp, ep) group, the replicated leaves equal across the
    groups."""
    dp, pp, _, ep, moe = MESHES[mesh_name]
    tr = _trainer(mesh_name, schedule, 2)
    state = tr.init_state(_stacked(moe, schedule))
    sb = _sharded_batch(tr)
    losses = []
    for _ in range(2):
        state, loss = tr.step(state, sb)
        losses.append(float(loss))
    assert np.isfinite(losses).all() and losses[1] < losses[0]
    want = _ref_steps(mesh_name, 2)
    _assert_tree_close(tr.global_params(state), want, TRAIN_TOL)
    assert state.replicas.shape[0] == pp * ep * dp
    reps = state.replicas.view(pp * ep, dp, -1)
    assert (reps == reps[:, :1]).all()
    for a, b in tr._rep_spans:
        assert (reps[:, :, a:b] == reps[:1, :, a:b]).all()
    r4 = reps.view(pp, ep, dp, -1)
    for a, b in tr._ep_rep_spans:
        assert (r4[:, :, :, a:b] == r4[:, :1, :, a:b]).all()


def test_pp_ep_bfp_ring_matches_golden():
    """dp=2 x pp=2 x ep=2, MoE, the BFP sublane codec on the fused ring
    kernels' route (their plain versions on the CPU): given the
    trainer's gradients (the replicated leaves summed, equal across the
    rows that hold them), the masters equal bit for bit the numpy golden
    composition on JAX's (pp, ep, dp) layout: per (pp, ep) group
    ``ring_golden``'s reduce-scatter, the division by n_dp, SGD, and
    ``bfp_golden``'s quantize-once gather for the replicas."""
    dp, pp, ep = 2, 2, 2
    coll = CollectiveConfig(impl="ring", compression=BFPConfig(
        codec="pallas"), fused_kernel=True)
    tr = _trainer("dp_pp_ep", "1f1b", 2, coll)
    state = tr.init_state(_stacked(True, "1f1b"))
    sb = _sharded_batch(tr)
    for _ in range(2):
        flat_g, _ = tr.grads(state, sb)
        g = flat_g.numpy().reshape(pp, ep, dp, -1)
        for a, b in tr._rep_spans:
            assert (g[:, :, :, a:b] == g[:1, :1, :, a:b]).all()
        for a, b in tr._ep_rep_spans:
            assert (g[:, :, :, a:b] == g[:, :1, :, a:b]).all()
        w_old = state.w_own.numpy().reshape(pp * ep, dp, -1)
        state = tr.apply_grads(state, flat_g)
        for k, gk in enumerate(g.reshape(pp * ep, dp, -1)):
            g_sum = jax_ring_golden.ring_reduce_scatter(
                gk, jcfg.BFPConfig(), "sublane")
            w_ref = w_old[k] - np.float32(0.1) * (g_sum / np.float32(dp))
            np.testing.assert_array_equal(
                state.w_own.numpy().reshape(pp * ep, dp, -1)[k], w_ref)
            q = np.concatenate([jax_bfp_golden.bfp_decode(
                *jax_bfp_golden.bfp_encode(w, layout="sublane"),
                layout="sublane") for w in w_ref])
            for d in range(dp):
                np.testing.assert_array_equal(
                    state.replicas[k * dp + d].numpy(), q)


# -- (e) the layouts -----------------------------------------------------------------

def _jspec(spec):
    """A JAX PartitionSpec as the port's spec string (None when it names
    no axis)."""
    names = [e for e in tuple(spec) if e is not None]
    assert all(isinstance(e, str) for e in names)
    return ",".join(names) if names else None


@pytest.mark.parametrize("moe,ep_axis", [(False, None), (True, None),
                                         (True, "ep")])
def test_stacked_param_specs_match_jax(moe, ep_axis):
    jc, pc = _cfgs(moe)
    want = jax_llama.stacked_param_specs(jc, pp_axis="pp", tp_axis=None,
                                         ep_axis=ep_axis)
    got = llama.stacked_param_specs(pc, ep_axis=ep_axis)
    want_l = jax.tree_util.tree_leaves(want, is_leaf=lambda x: isinstance(
        x, P))
    assert [_jspec(s) for s in want_l] == fused_update.tree_leaves(got)


@pytest.mark.parametrize("dp,pp,sp,ep", [(2, 2, 1, 2), (1, 2, 2, 2),
                                         (2, 2, 2, 1)])
def test_batch_layout_with_pp_matches_jax(dp, pp, sp, ep):
    """pp never splits the batch: device (d, s, j, e) of a mesh with pp
    holds ``P((dp, ep), sp)``'s rows and columns of rank (d, e), shard j,
    whatever its stage."""
    x = np.arange(B * S, dtype=np.int32).reshape(B, S)
    names, shape = _axes(dp, pp, sp, ep)
    mesh = Mesh(np.asarray(jax.devices()[:int(np.prod(shape))]).reshape(
        shape), names)
    placed = jax_mesh.shard_host_batch(x, mesh, _bspec(dp, sp, ep))
    got = VirtualRanks(dp, torch.device("cpu"), sp, ep, pp).shard(
        torch.from_numpy(x))
    for shard in placed.addressable_shards:
        at = dict(zip(names, (int(i) for i in np.argwhere(
            mesh.devices == shard.device)[0])))
        idx = (at.get("dp", 0),) + ((at["ep"],) if ep > 1 else ()) + (
            (at["sp"],) if sp > 1 else ())
        np.testing.assert_array_equal(got[idx].numpy(),
                                      np.asarray(shard.data))


@functools.lru_cache(maxsize=None)
def _jax_trainer_pp_ep():
    jc, _ = _cfgs(True)
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(2, 1, 1, 2, 2),
                ("dp", "tp", "sp", "pp", "ep"))
    jtr = JaxShardedTrainer(
        None, mesh, jcfg.TrainConfig(
            global_batch=B, mesh=jcfg.MeshConfig(dp=2, pp=2, ep=2),
            collective=jcfg.CollectiveConfig(impl="xla"),
            optimizer=jcfg.OptimizerConfig(kind="sgd", clip_norm=1.0)),
        jax_llama.stacked_param_specs(jc, pp_axis="pp", tp_axis=None,
                                      ep_axis="ep"),
        pp_axis="pp", ep_axis="ep")
    params = jax_llama.stack_params(jax_llama.init(jax.random.PRNGKey(0),
                                                   jc))
    return jtr, jtr.init_state(params)


def test_master_rows_match_jax_waxes():
    """One flat f32 master row a (pp, ep, dp) device in JAX's ``_waxes``
    order: the port's rows ``(s n_ep + e) n_dp + d`` equal JAX's master
    shards, and the norm tables equal JAX's ``_norm_weight_tables``."""
    jtr, jstate = _jax_trainer_pp_ep()
    assert jtr._waxes == ("tp", "pp", "ep", "dp")
    cfg = TrainConfig(global_batch=B, mesh=MeshConfig(dp=2, pp=2, ep=2),
                      collective=CollectiveConfig(impl="xla"),
                      optimizer=OptimizerConfig(kind="sgd", clip_norm=1.0))
    _, pc = _cfgs(True)
    tr = ShardedTrainer(
        llama.pp_dp_loss_fn(pc, 2, 2, num_microbatches=1),
        make_ranks(cfg.mesh, "cpu"), cfg,
        param_specs=llama.stacked_param_specs(pc, ep_axis="ep"))
    state = tr.init_state(_stacked(True, "gpipe"))
    want = np.asarray(jstate.w_own).reshape(8, -1)
    np.testing.assert_array_equal(state.w_own.numpy(), want)
    want_b, want_v = jtr._norm_weight_tables()
    got_b, got_v = tr.norm_weight_tables()
    np.testing.assert_array_equal(got_b, want_b)
    np.testing.assert_array_equal(got_v, want_v)
    assert set(np.unique(got_v).tolist()) >= {0.25, 0.5, 1.0}


# -- (f) the driver ----------------------------------------------------------------

@pytest.mark.parametrize("schedule", ["gpipe", "1f1b", "1f1b-interleaved"])
def test_train_llama_pp_sp_ep_moe_on_cpu(schedule):
    argv = ["--model=tiny", "--device=cpu", "--model.moe_experts=4",
            "--model.n_layers=4", "--model.attn_block=128", "--seq=256",
            "--global_batch=4", "--mesh.pp=2", "--mesh.ep=2", "--mesh.sp=2",
            "--microbatches=2", f"--pp_schedule={schedule}", "--iters=3",
            "--optimizer.kind=sgd", "--optimizer.learning_rate=1.0"]
    out = train_llama.main(argv)
    assert out["mesh"] == {"dp": 1, "tp": 1, "sp": 2, "pp": 2, "ep": 2}
    assert np.isfinite([out["loss_first"], out["loss_last"]]).all()
    assert out["loss_last"] < out["loss_first"]
    v = 2 if schedule == "1f1b-interleaved" else 1
    assert out["pipeline_cost"] == pipeline.cost_model(2, 2, schedule, v)
    with pytest.raises(ValueError, match="does not split"):
        train_llama.parse(argv + ["--microbatches=3"])
