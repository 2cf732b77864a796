"""Pipeline parallelism on the port against the JAX package, on the CPU.

The port runs the pp stages as virtual ranks (a list of stage trees); JAX
runs them as devices of a CPU mesh under ``shard_map``.  The same seeded
numpy inputs go through both:

- (a) the schedules on a toy stage (``tanh(x @ w + b)`` layers, f32,
  rtol 1e-5): ``pipeline_apply(_aux)`` (and its gradients),
  ``pipeline_train_1f1b`` (plain, and with a per-stage loss and a report
  channel) and ``pipeline_train_1f1b_interleaved`` against JAX's, at the
  (pp, M) and (pp, v, M) cases of JAX's own tests: outputs, loss,
  d_stage, d_head, d_x;
- (b) the pure-Python parts equal to JAX's: ``_interleaved_tables`` over
  JAX's property-sweep range, ``_alloc_slots``, ``cost_model`` of the
  three schedules, the interleave permutations, ``stack_layers``;
- (c) memory: 1F1B's saved inputs at most ``pp - s`` on stage s and the
  same at M = 4 and 16; GPipe's saved activations grow with M;
- (d) the tiny Llama: ``loss_fn_pp`` and ``loss_and_grads_pp_1f1b``
  (plain and interleaved) against JAX's unsharded ``loss_fn`` and its
  gradients (JAX's own ``loss_fn_pp`` test is red on this JAX: ROADMAP
  C.4); ``params_from_jax`` of the stacked tree; ``ShardedTrainer`` over
  dp x pp after two SGD steps against two unsharded JAX steps (rtol
  5e-4, atol 5e-5) at JAX's three (dp, pp, remat, masked) cases, under
  GPipe and 1F1B; the GPipe, 1F1B and interleaved trainers' three AdamW
  losses against JAX's ``ShardedTrainer`` GPipe run (rtol 1e-4, JAX's
  passing trainer tests' setup, run once for the module);
  ``norm_weight_tables`` against JAX's over a pp mesh;
- (e) the refusals: pp with tp or JAX's ``dp_axis``, a MoE loss of one
  dp rank with ``dp_size``; ``--virtual_stages`` without the interleaved
  schedule; ``loss_and_grads_fn`` with ``accum_steps=2``;
- (f) ``train_llama`` under each schedule on the CPU, its
  ``pipeline_cost`` equal to JAX's ``cost_model``.
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
from fpga_ai_nic_tpu.parallel import ShardedTrainer as JaxShardedTrainer
from fpga_ai_nic_tpu.parallel import pipeline as jpl
from fpga_ai_nic_tpu.utils import config as jcfg
from fpga_ai_nic_tpu_torch import train_llama
from fpga_ai_nic_tpu_torch.models import bert, llama
from fpga_ai_nic_tpu_torch.ops import fused_update
from fpga_ai_nic_tpu_torch.parallel import pipeline
from fpga_ai_nic_tpu_torch.parallel.mesh import make_ranks
from fpga_ai_nic_tpu_torch.parallel.sharded import ShardedTrainer
from fpga_ai_nic_tpu_torch.utils.config import (
    CollectiveConfig, MeshConfig, OptimizerConfig, TrainConfig)

TOY_TOL = dict(rtol=1e-5, atol=1e-5)
TRAIN_TOL = dict(rtol=5e-4, atol=5e-5)
JC = jax_llama.LlamaConfig.tiny()
B, S = 4, 32


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _pp_mesh(pp):
    return Mesh(np.array(jax.devices()[:pp]), ("pp",))


# -- (a) the schedules on a toy stage ---------------------------------------------

def _toy(seed, n_layers=8, d=16, rows=8):
    rng = np.random.default_rng(seed)
    layers = [{"w": (rng.standard_normal((d, d)) * 0.3).astype(np.float32),
               "b": (rng.standard_normal((d,)) * 0.1).astype(np.float32)}
              for _ in range(n_layers)]
    x = rng.standard_normal((rows, d)).astype(np.float32)
    return layers, x, rng


def _jstack(layers):
    return jpl.stack_layers([jax.tree_util.tree_map(jnp.asarray, lyr)
                             for lyr in layers])


def _tstack(layers):
    return pipeline.stack_layers([{k: torch.from_numpy(v)
                                   for k, v in lyr.items()}
                                  for lyr in layers])


def _stages(stacked, pp, v=1):
    """The pp stages' slices of a stacked tree (views); with v > 1 each
    leaf [v, L / (pp v), ...]."""
    return [{k: t.chunk(pp)[s].reshape(v, -1, *t.shape[1:]) if v > 1
             else t.chunk(pp)[s] for k, t in stacked.items()}
            for s in range(pp)]


def _unstage(d_stages):
    """Per-stage gradients back to one stacked tree (chunk axis folded)."""
    return {k: torch.cat([d[k].reshape(-1, *d[k].shape[-2 + (k == "b"):])
                          for d in d_stages]) for k in d_stages[0]}


def _jtoy_block(lyr, x):
    return jnp.tanh(x @ lyr["w"] + lyr["b"])


def _toy_block(lyr, x):
    return torch.tanh(x @ lyr["w"] + lyr["b"])


SPEC = {"w": P("pp", None, None), "b": P("pp", None)}


@pytest.mark.parametrize("pp,n_mb", [(4, 2), (4, 4), (2, 8), (8, 1)])
def test_pipeline_apply_matches_jax(pp, n_mb):
    """GPipe's output and aux (``scan_layers_aux``'s sum over a stage's
    layers, summed over the stages, averaged over the microbatches)
    against JAX's ``pipeline_apply_aux`` (the last stage's output)."""
    layers, x, _ = _toy(0)

    def jrun(st, xx):
        def stage(sp_, h):
            return jpl.scan_layers_aux(
                lambda lyr, x: (_jtoy_block(lyr, x),
                                jnp.mean(_jtoy_block(lyr, x) ** 2)), sp_, h)
        y, aux = jpl.pipeline_apply_aux(stage, st, xx, n_mb, "pp")
        return jpl.from_last_stage(y, "pp"), aux

    want_y, want_aux = jax.jit(jax.shard_map(
        jrun, mesh=_pp_mesh(pp), in_specs=(SPEC, P()),
        out_specs=(P(), P())))(_jstack(layers), jnp.asarray(x))

    def stage(p, h):          # a per-layer aux, summed over the slice
        return pipeline.scan_layers_aux(
            lambda lyr, x: (_toy_block(lyr, x),
                            (_toy_block(lyr, x) ** 2).mean()), p, h)
    stages = _stages(_tstack(layers), pp)
    y, aux = pipeline.pipeline_apply_aux(stage, stages, torch.from_numpy(x),
                                         n_mb)
    np.testing.assert_allclose(_np(y), np.asarray(want_y), **TOY_TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOY_TOL)
    y2 = pipeline.pipeline_apply(
        lambda p, h: pipeline.scan_layers(_toy_block, p, h), stages,
        torch.from_numpy(x), n_mb)
    assert torch.equal(y2, y)


@pytest.mark.parametrize("remat", [False, True])
def test_pipeline_grads_match_jax(remat):
    """autograd through GPipe against ``jax.grad`` through JAX's (pp=4,
    M=2, loss sum(y^2)); ``remat`` checkpoints each layer."""
    layers, x, _ = _toy(1)
    mesh = _pp_mesh(4)

    def jloss(st, xx):
        def inner(sp_, x2):
            y = jpl.pipeline_apply(
                lambda s, h: jpl.scan_layers(_jtoy_block, s, h), sp_, x2, 2,
                "pp")
            return jpl.from_last_stage(jnp.sum(y * y), "pp")
        return jax.shard_map(inner, mesh=mesh, in_specs=(SPEC, P()),
                             out_specs=P())(st, xx)

    want_sp, want_x = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        _jstack(layers), jnp.asarray(x))
    stacked = {k: t.requires_grad_() for k, t in _tstack(layers).items()}
    xt = torch.from_numpy(x).requires_grad_()
    y = pipeline.pipeline_apply(
        lambda p, h: pipeline.scan_layers(_toy_block, p, h, remat=remat),
        _stages(stacked, 4), xt, 2)
    (y * y).sum().backward()
    for k in ("b", "w"):
        np.testing.assert_allclose(_np(stacked[k].grad),
                                   np.asarray(want_sp[k]), **TOY_TOL)
    np.testing.assert_allclose(_np(xt.grad), np.asarray(want_x), **TOY_TOL)


def _jhead(hp, h, t):
    return jnp.mean(((h * hp["v"]).sum(-1) - t) ** 2)


def _head(hp, h, t):
    return (((h * hp["v"]).sum(-1) - t) ** 2).mean()


def _jstage(report):
    def stage(sp_, hp_, h, c):
        out = jpl.scan_layers(_jtoy_block, sp_, h)
        if not report:
            return out, jnp.sum(out) * 0.0
        return (out, 0.01 * jnp.mean(out * out),
                jnp.stack([jnp.sum(out), jnp.mean(out)]))
    return stage


def _tstage(report):
    def stage(sp_, hp_, h, c):
        out = pipeline.scan_layers(_toy_block, sp_, h)
        if not report:
            return out, out.sum() * 0.0
        return (out, 0.01 * (out * out).mean(),
                torch.stack([out.sum(), out.mean()]))
    return stage


def _jreport_head(hp, h, t):
    loss = _jhead(hp, h, t)
    return loss, jnp.stack([loss, loss * 0.0])


def _report_head(hp, h, t):
    loss = _head(hp, h, t)
    return loss, torch.stack([loss, loss * 0.0])


@pytest.mark.parametrize("pp,n_mb,report", [
    (4, 4, False), (4, 2, False), (2, 8, False), (8, 1, False),
    (8, 2, False), (4, 4, True), (2, 2, True)])
def test_1f1b_matches_jax(pp, n_mb, report):
    """``pipeline_train_1f1b`` against JAX's under ``shard_map`` (JAX's
    ``test_1f1b_matches_sequential_grads`` setup): loss, d_stage, d_head,
    d_x; with ``report``, a per-stage loss channel and the report vector
    too."""
    layers, x, rng = _toy(2)
    v_head = (rng.standard_normal((16,)) * 0.3).astype(np.float32)
    tgt = rng.standard_normal((8,)).astype(np.float32)
    R = 2 if report else 0

    def jrun(st, hp, xx, tt):
        return jpl.pipeline_train_1f1b(
            _jstage(report), _jreport_head if report else _jhead, st, hp,
            xx, tt, n_mb, "pp", report_len=R)

    outs = (P(), SPEC, P(), P()) + ((P(),) if report else ())
    want = jax.jit(jax.shard_map(
        jrun, mesh=_pp_mesh(pp), in_specs=(SPEC, P(), P(), P()),
        out_specs=outs))(_jstack(layers), {"v": jnp.asarray(v_head)},
                         jnp.asarray(x), jnp.asarray(tgt))
    stats = {}
    got = pipeline.pipeline_train_1f1b(
        _tstage(report), _report_head if report else _head,
        _stages(_tstack(layers), pp), {"v": torch.from_numpy(v_head)},
        torch.from_numpy(x), torch.from_numpy(tgt), n_mb, report_len=R,
        stats=stats)
    np.testing.assert_allclose(float(got[0]), float(want[0]), **TOY_TOL)
    d_sp = _unstage(got[1])
    for k in ("b", "w"):
        np.testing.assert_allclose(_np(d_sp[k]), np.asarray(want[1][k]),
                                   **TOY_TOL)
    np.testing.assert_allclose(_np(got[2]["v"]), np.asarray(want[2]["v"]),
                               **TOY_TOL)
    np.testing.assert_allclose(_np(got[3]), np.asarray(want[3]), **TOY_TOL)
    if report:
        np.testing.assert_allclose(_np(got[4]), np.asarray(want[4]),
                                   **TOY_TOL)
    assert stats["max_live"] == [min(n_mb, pp - s) for s in range(pp)]


@pytest.mark.parametrize("pp,v,n_mb", [(2, 2, 4), (2, 4, 4), (4, 2, 8)])
def test_interleaved_1f1b_matches_jax(pp, v, n_mb):
    """``pipeline_train_1f1b_interleaved`` against JAX's (JAX's
    ``test_interleaved_1f1b_matches_sequential_grads`` setup): loss, the
    chunked stage gradients in the interleaved order, d_x; and in model
    order against the sequential ``jax.grad``."""
    L = pp * v
    layers, x, rng = _toy(3, n_layers=L)
    tgt = rng.standard_normal(x.shape).astype(np.float32)

    def jstage(sp, hp, xx, cc):
        h = jpl.scan_layers(_jtoy_block, sp, xx)
        return h, jnp.sum(h) * 0.0

    def jrun(sp, xx, tt):
        spc = jax.tree_util.tree_map(
            lambda a: a.reshape((v, a.shape[0] // v) + a.shape[1:]), sp)
        loss, d_sp, _, d_x = jpl.pipeline_train_1f1b_interleaved(
            jstage, lambda hp, h, cc: jnp.sum((h - cc) ** 2), spc, {}, xx,
            tt, n_mb, "pp", v)
        return loss, jax.tree_util.tree_map(
            lambda a: a.reshape((-1,) + a.shape[2:]), d_sp), d_x

    jilv = jpl.interleave_layers(_jstack(layers), pp, v)
    want = jax.jit(jax.shard_map(
        jrun, mesh=_pp_mesh(pp), in_specs=(P("pp"), P(), P()),
        out_specs=(P(), P("pp"), P())))(jilv, jnp.asarray(x),
                                         jnp.asarray(tgt))

    def stage(sp, hp, xx, cc):
        h = pipeline.scan_layers(_toy_block, sp, xx)
        return h, h.sum() * 0.0

    ilv = pipeline.interleave_layers(_tstack(layers), pp, v)
    stats = {}
    loss, d_sp, d_hp, d_x = pipeline.pipeline_train_1f1b_interleaved(
        stage, lambda hp, h, cc: ((h - cc) ** 2).sum(), _stages(ilv, pp, v),
        {}, torch.from_numpy(x), torch.from_numpy(tgt), n_mb, v,
        stats=stats)
    assert d_hp == {}
    np.testing.assert_allclose(float(loss), float(want[0]), **TOY_TOL)
    got = _unstage(d_sp)
    for k in ("b", "w"):
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[1][k]),
                                   **TOY_TOL)
    np.testing.assert_allclose(_np(d_x), np.asarray(want[2]), **TOY_TOL)
    # model order against the sequential gradient
    seq = jax.grad(lambda ls: jnp.sum((_seq_j(ls, jnp.asarray(x))
                                       - jnp.asarray(tgt)) ** 2) / n_mb)(
        [jax.tree_util.tree_map(jnp.asarray, lyr) for lyr in layers])
    model = pipeline.deinterleave_layers(got, pp, v)
    for k in ("b", "w"):
        np.testing.assert_allclose(
            _np(model[k]), np.stack([np.asarray(g[k]) for g in seq]),
            rtol=2e-4, atol=2e-5)
    n_as = pipeline._interleaved_tables(pp, v, n_mb)["n_aslots"]
    assert max(stats["max_live"]) <= n_as


def _seq_j(layers, x):
    for lyr in layers:
        x = _jtoy_block(lyr, x)
    return x


# -- (b) the tables, the cost model, the permutations -----------------------------

def test_interleaved_tables_equal_jax():
    """Every table of every (pp, v, M) in JAX's property sweep, equal."""
    for pp in (2, 3, 4, 6, 8):
        for v in (1, 2, 3, 4):
            for mult in (1, 2, 4):
                got = pipeline._interleaved_tables(pp, v, pp * mult)
                want = jpl._interleaved_tables(pp, v, pp * mult)
                assert got.keys() == want.keys()
                for k in want:
                    np.testing.assert_array_equal(got[k], want[k],
                                                  err_msg=f"{k} {pp} {v}")
    with pytest.raises(ValueError, match="% pp"):
        pipeline._interleaved_tables(4, 2, 6)


def test_alloc_slots_equal_jax():
    rng = np.random.default_rng(4)
    for _ in range(50):
        starts = rng.integers(0, 40, 30)
        ivs = [(int(s), int(s + rng.integers(0, 12)), i)
               for i, s in enumerate(starts)]
        assert pipeline._alloc_slots(ivs) == jpl._alloc_slots(ivs)


def test_cost_model_equals_jax():
    for sched, vs in (("gpipe", (1,)), ("1f1b", (1,)),
                      ("1f1b-interleaved", (1, 2, 3))):
        for pp in (1, 2, 4, 8):
            for M in (1, 2, 4, 8, 16):
                for v in vs:
                    if sched == "1f1b-interleaved" and M % pp:
                        continue
                    assert pipeline.cost_model(M, pp, sched, v) == \
                        jpl.cost_model(M, pp, sched, v), (sched, pp, M, v)
    for bad in ((0, 2, "gpipe"), (4, 2, "nope")):
        with pytest.raises(ValueError):
            pipeline.cost_model(*bad)


@pytest.mark.parametrize("L,pp,v", [(8, 2, 2), (8, 2, 4), (16, 4, 2),
                                    (12, 3, 2)])
def test_interleave_permutations_equal_jax(L, pp, v):
    a = np.arange(L * 3, dtype=np.float32).reshape(L, 3)
    want = np.asarray(jpl.interleave_layers({"a": jnp.asarray(a)}, pp,
                                            v)["a"])
    got = pipeline.interleave_layers({"a": torch.from_numpy(a)}, pp, v)
    np.testing.assert_array_equal(got["a"].numpy(), want)
    back = pipeline.deinterleave_layers(got, pp, v)
    np.testing.assert_array_equal(back["a"].numpy(), a)
    np.testing.assert_array_equal(
        np.asarray(jpl.deinterleave_layers({"a": jnp.asarray(want)}, pp,
                                           v)["a"]), a)


def test_stack_layers_round_trip():
    layers, _, _ = _toy(5, n_layers=3)
    st = _tstack(layers)
    want = _jstack(layers)
    for k in ("b", "w"):
        np.testing.assert_array_equal(st[k].numpy(), np.asarray(want[k]))
    for got, lyr in zip(pipeline.unstack_layers(st), layers):
        for k in ("b", "w"):
            np.testing.assert_array_equal(got[k].numpy(), lyr[k])


# -- (c) memory -------------------------------------------------------------------

def _mem_case(M, mb=4, pp=4, d=32):
    rng = np.random.default_rng(6)
    layers = [{"w": torch.from_numpy((rng.standard_normal((d, d)) * 0.2)
                                     .astype(np.float32)),
               "b": torch.zeros(d)} for _ in range(pp)]
    x = torch.from_numpy(rng.standard_normal((M * mb, d)).astype(
        np.float32))
    return _stages(pipeline.stack_layers(layers), pp), x


@pytest.mark.parametrize("pp", [2, 4])
def test_1f1b_memory_independent_of_microbatches(pp):
    """1F1B holds at most pp - s saved inputs on stage s, the same at M=4
    and M=16; GPipe's saved activations (autograd's saved tensors,
    counted by a hook) grow with M at a fixed microbatch size."""
    live = {}
    for M in (4, 16):
        stages, x = _mem_case(M, pp=pp)
        stats = {}
        pipeline.pipeline_train_1f1b(
            lambda sp, hp, h, c: (pipeline.scan_layers(_toy_block, sp, h),
                                  torch.zeros(())),
            lambda hp, h, c: h.pow(2).mean(), stages, {}, x, {}, M,
            stats=stats)
        live[M] = stats["max_live"]
    assert live[4] == live[16] == [pp - s for s in range(pp)]
    saved = {}
    for M in (4, 16):
        stages, x = _mem_case(M, pp=pp)
        stages = [{k: t.requires_grad_() for k, t in st.items()}
                  for st in stages]
        total = [0]

        def pack(t):
            total[0] += t.numel() * t.element_size()
            return t
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            y = pipeline.pipeline_apply(
                lambda p, h: pipeline.scan_layers(_toy_block, p, h), stages,
                x, M)
        saved[M] = total[0]
        del y
    assert saved[16] >= 3.5 * saved[4], saved


# -- (d) the tiny Llama -------------------------------------------------------------

def _jparams(cfg, seed=0):
    return jax.tree_util.tree_map(
        np.asarray, jax_llama.init(jax.random.PRNGKey(seed), cfg))


def _batch(seed=0, b=B, s=S, vocab=JC.vocab):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s + 1)
                                                ).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def _port_stages(jparams, cfg_p, pp, v=1):
    stacked = llama.stack_params(llama.params_from_jax(jparams, "cpu"))
    if v > 1:
        stacked["layers"] = pipeline.interleave_layers(stacked["layers"],
                                                       pp, v)
    from fpga_ai_nic_tpu_torch.parallel.sharded import split_ep
    return stacked, split_ep(stacked, llama.stacked_param_specs(cfg_p), pp)


@pytest.mark.parametrize("pp,v,n_mb", [(2, 1, 2), (4, 1, 2), (2, 2, 2)])
def test_llama_pp_loss_and_grads_match_jax_unsharded(pp, v, n_mb):
    """``apply_pp``'s logits against JAX's unsharded ``apply``;
    ``loss_fn_pp`` (GPipe: autograd over the stages) and
    ``loss_and_grads_pp_1f1b`` (the 1F1B schedules) against JAX's
    unsharded ``loss_fn`` and ``jax.grad``: the loss, each stage's layer
    slice and the replicated leaves (every stage's copy of their
    gradient summed over the stages: embedding from stage 0, head from
    the last)."""
    jc = jax_llama.LlamaConfig.tiny(n_layers=4)
    pc = llama.LlamaConfig(**jc.__dict__)
    jp = _jparams(jc, 1)
    toks, labels = _batch(1)
    labels = labels.copy()
    labels[0, :5] = -100
    jb = (jnp.asarray(toks), jnp.asarray(labels))
    want_loss, want_g = jax.jit(jax.value_and_grad(
        lambda p: jax_llama.loss_fn(p, jb, jc)))(jp)
    want = jax.tree_util.tree_map(np.asarray, jax_llama.stack_params(want_g))
    if v > 1:
        want["layers"] = jax.tree_util.tree_map(
            np.asarray, jpl.interleave_layers(want["layers"], pp, v))
    tb = (torch.from_numpy(toks), torch.from_numpy(labels))
    _, stages = _port_stages(jp, pc, pp, v)
    if v == 1:          # the pipelined forward's logits
        want_logits = jax.jit(lambda p, t: jax_llama.apply(p, t, jc))(
            jp, jnp.asarray(toks))
        np.testing.assert_allclose(
            _np(llama.apply_pp(stages, tb[0], pc, num_microbatches=n_mb)),
            np.asarray(want_logits), rtol=1e-5, atol=1e-5)

    def check(loss, grads):
        np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                                   rtol=1e-5)
        for k in ("tok_emb", "final_norm", "lm_head"):
            np.testing.assert_allclose(_np(sum(g[k] for g in grads)),
                                       want[k], rtol=1e-4, atol=1e-6)
        for k, w in want["layers"].items():
            got = torch.cat([g["layers"][k] for g in grads])
            np.testing.assert_allclose(_np(got), w, rtol=1e-4, atol=1e-6,
                                       err_msg=k)

    if v == 1:          # GPipe through autograd
        # each stage its own copy of the replicated leaves, as the
        # trainer's rows hold them
        leaves = [[t.clone().requires_grad_()
                   for t in fused_update.tree_leaves(st)] for st in stages]
        trees = [fused_update.tree_from_leaves(
            tuple(p for p, _ in fused_update._leaves(stages[0])), ls)
            for ls in leaves]
        loss = llama.loss_fn_pp(trees, tb, pc, num_microbatches=n_mb,
                                remat=True)
        gs = torch.autograd.grad(loss, [t for ls in leaves for t in ls],
                                 allow_unused=True)
        k = len(leaves[0])
        paths = tuple(p for p, _ in fused_update._leaves(stages[0]))
        check(loss, [fused_update.tree_from_leaves(paths, [
            torch.zeros_like(t) if g is None else g
            for t, g in zip(leaves[s], gs[s * k:(s + 1) * k])])
            for s in range(pp)])
    loss, grads = llama.loss_and_grads_pp_1f1b(
        stages, tb, pc, num_microbatches=n_mb, virtual_stages=v, remat=True)
    # the 1F1B contract: every stage holds the summed replicated gradient
    for g in grads[1:]:
        for k in ("tok_emb", "final_norm", "lm_head"):
            assert torch.equal(g[k], grads[0][k])
    check(loss, [grads[0]] + [
        {**g, "tok_emb": torch.zeros_like(g["tok_emb"]),
         "final_norm": torch.zeros_like(g["final_norm"]),
         "lm_head": torch.zeros_like(g["lm_head"])} for g in grads[1:]])


def test_params_from_jax_takes_the_stacked_tree():
    jc = jax_llama.LlamaConfig.tiny(n_layers=4)
    jp = jax_llama.init(jax.random.PRNGKey(2), jc)
    js = jax_llama.stack_params(jp)
    for v in (1, 2):
        tree = js if v == 1 else dict(
            js, layers=jpl.interleave_layers(js["layers"], 2, v))
        got = llama.params_from_jax(jax.tree_util.tree_map(np.asarray, tree),
                                    "cpu")
        want = llama.stack_params(llama.params_from_jax(
            jax.tree_util.tree_map(np.asarray, jp), "cpu"))
        if v > 1:
            want["layers"] = pipeline.interleave_layers(want["layers"], 2, v)
        assert [p for p, _ in fused_update._leaves(got)] == \
            [p for p, _ in fused_update._leaves(want)]
        for a, b in zip(fused_update.tree_leaves(got),
                        fused_update.tree_leaves(want)):
            assert torch.equal(a, b)


def _pp_trainer(cfg_p, dp, pp, n_mb, schedule, opt, remat=True,
                count=False, v=1):
    cfg = TrainConfig(global_batch=B, mesh=MeshConfig(dp=dp, pp=pp),
                      collective=CollectiveConfig(impl="xla"), optimizer=opt)
    dp_size = dp if count else None
    specs = llama.stacked_param_specs(cfg_p)
    if schedule == "gpipe":
        return ShardedTrainer(
            lambda p, b: llama.loss_fn_pp(p, b, cfg_p, num_microbatches=n_mb,
                                          remat=remat, dp_size=dp_size),
            make_ranks(cfg.mesh, "cpu"), cfg, param_specs=specs)
    return ShardedTrainer(
        None, make_ranks(cfg.mesh, "cpu"), cfg, param_specs=specs,
        loss_and_grads_fn=lambda p, b, out=None: llama.loss_and_grads_pp_1f1b(
            p, b, cfg_p, num_microbatches=n_mb, virtual_stages=v,
            remat=remat, dp_size=dp_size, out=out))


def _train(tr, stacked, batch, steps):
    state = tr.init_state(stacked)
    sb = tr.shard_batch(tuple(map(torch.from_numpy, batch)))
    losses = []
    for _ in range(steps):
        state, loss = tr.step(state, sb)
        losses.append(float(loss))
    return state, losses


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
@pytest.mark.parametrize("dp,pp,remat,masked", [
    (2, 2, False, True), (1, 4, True, False), (4, 2, False, False)])
def test_pp_training_matches_unsharded(dp, pp, remat, masked, schedule):
    """dp x pp ZeRO-1 training against two unsharded JAX SGD steps (JAX's
    ``test_pp_training_matches_unsharded``): with masked labels spread
    unevenly over the dp shards, the global label count rides the batch
    (JAX's ``dp_axis`` weighting)."""
    n_mb = min(2, B // dp)
    jc = jax_llama.LlamaConfig.tiny(n_layers=4) if pp > 2 else JC
    pc = llama.LlamaConfig(**jc.__dict__)
    toks, labels = _batch(0)
    if masked:
        labels = labels.copy()
        labels[: B // 2, : (3 * S) // 4] = -100
    jp = _jparams(jc)
    jb = (jnp.asarray(toks), jnp.asarray(labels))

    def ref_step(params):
        g = jax.grad(lambda p: jax_llama.loss_fn(p, jb, jc))(params)
        return jax.tree_util.tree_map(
            lambda w, gg: (w.astype(jnp.float32)
                           - 0.1 * gg.astype(jnp.float32)).astype(w.dtype),
            params, g)

    want = jax_llama.stack_params(ref_step(ref_step(jp)))
    tr = _pp_trainer(pc, dp, pp, n_mb, schedule,
                     OptimizerConfig(kind="sgd", learning_rate=0.1), remat,
                     count=masked)
    batch = (toks, labels)
    if masked:
        batch = tuple(t.numpy() for t in bert.with_global_count(
            tuple(map(torch.from_numpy, batch)), dp))
    stacked, _ = _port_stages(jp, pc, pp)
    state, losses = _train(tr, stacked, batch, 2)
    assert np.isfinite(losses).all()
    assert state.replicas.shape[0] == dp * pp
    for (path, g), w in zip(fused_update._leaves(tr.global_params(state)),
                            jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(_np(g), np.asarray(w, np.float32),
                                   **TRAIN_TOL, err_msg=str(path))
    reps = state.replicas.view(pp, dp, -1)
    assert (reps == reps[:, :1]).all()
    for a, b in tr._rep_spans:        # the replicated leaves, every stage
        assert (reps[:, :, a:b] == reps[:1, :, a:b]).all()


ADAMW_STEPS = 3


@pytest.fixture(scope="module")
def jax_gpipe_adamw():
    """JAX's ``ShardedTrainer`` GPipe run of its passing
    ``test_sharded_trainer_1f1b_matches_gpipe_training`` (dp=2 x pp=2,
    tiny Llama at 4 layers, AdamW lr 1e-3, 3 steps): the losses and the
    stacked initial weights."""
    jc = dataclasses.replace(JC, n_layers=4)
    toks, labels = _batch(7)
    params = jax_llama.stack_params(jax_llama.init(jax.random.PRNGKey(0),
                                                   jc))
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 1, 1, 2),
                ("dp", "tp", "sp", "pp"))
    tcfg = jcfg.TrainConfig(
        iters=ADAMW_STEPS, global_batch=B, mesh=jcfg.MeshConfig(dp=2, pp=2),
        collective=jcfg.CollectiveConfig(impl="xla"),
        optimizer=jcfg.OptimizerConfig(kind="adamw", learning_rate=1e-3))
    tr = JaxShardedTrainer(
        lambda p, b: jax_llama.loss_fn_pp(p, b, jc, pp_axis="pp",
                                          num_microbatches=2, dp_axis="dp",
                                          sp_axis="sp"),
        mesh, tcfg, jax_llama.stacked_param_specs(jc, pp_axis="pp",
                                                  tp_axis=None),
        pp_axis="pp")
    st = tr.init_state(jax.tree_util.tree_map(jnp.copy, params))
    losses = []
    for _ in range(ADAMW_STEPS):
        st, loss = tr.step(st, tr.shard_batch((jnp.asarray(toks),
                                               jnp.asarray(labels))))
        losses.append(float(loss))
    return {"losses": losses, "params": jax.tree_util.tree_map(
        np.asarray, params), "batch": (toks, labels), "cfg": jc}


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b", "1f1b-interleaved"])
def test_trainer_schedules_match_jax_gpipe_adamw(jax_gpipe_adamw, schedule):
    """The port's GPipe, 1F1B and interleaved (v=2) trainers' AdamW loss
    trajectories against JAX's GPipe trainer on the same stacked weights
    (rtol 1e-4; the interleaved trainer's layers in
    ``interleave_layers`` order for the whole run)."""
    ref = jax_gpipe_adamw
    pc = llama.LlamaConfig(**ref["cfg"].__dict__)
    v = 2 if schedule == "1f1b-interleaved" else 1
    tr = _pp_trainer(pc, 2, 2, 2, schedule,
                     OptimizerConfig(kind="adamw", learning_rate=1e-3),
                     remat=False, count=True, v=v)
    stacked = llama.params_from_jax(ref["params"], "cpu")
    if v > 1:
        stacked["layers"] = pipeline.interleave_layers(stacked["layers"], 2,
                                                       v)
    batch = tuple(t.numpy() for t in bert.with_global_count(
        tuple(map(torch.from_numpy, ref["batch"])), 2))
    _, losses = _train(tr, stacked, batch, ADAMW_STEPS)
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-4)
    assert losses[-1] < losses[0]


def test_norm_weight_tables_match_jax_pp():
    """The clip's norm weights over a stage row (a replicated leaf 1/pp a
    copy) equal JAX's ``_norm_weight_tables`` over its pp mesh."""
    jc = jax_llama.LlamaConfig.tiny(n_layers=4)
    params = jax_llama.stack_params(jax_llama.init(jax.random.PRNGKey(0),
                                                   jc))
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 1, 1, 2),
                ("dp", "tp", "sp", "pp"))
    jtr = JaxShardedTrainer(
        None, mesh, jcfg.TrainConfig(
            global_batch=B, mesh=jcfg.MeshConfig(dp=2, pp=2),
            collective=jcfg.CollectiveConfig(impl="xla"),
            optimizer=jcfg.OptimizerConfig(clip_norm=1.0)),
        jax_llama.stacked_param_specs(jc, pp_axis="pp", tp_axis=None),
        pp_axis="pp")
    jtr._ensure_meta(params)
    want_b, want_v = jtr._norm_weight_tables()
    pc = llama.LlamaConfig(**jc.__dict__)
    tr = _pp_trainer(pc, 2, 2, 2, "gpipe",
                     OptimizerConfig(kind="sgd", clip_norm=1.0))
    tr.init_state(llama.params_from_jax(jax.tree_util.tree_map(
        np.asarray, params), "cpu"))
    got_b, got_v = tr.norm_weight_tables()
    np.testing.assert_array_equal(got_b, want_b)
    np.testing.assert_array_equal(got_v, want_v)
    assert set(np.unique(got_v).tolist()) >= {0.5, 1.0}


# -- (e) the refusals -------------------------------------------------------------

def test_pp_refusals():
    """What the pp path still refuses: JAX's ``dp_axis`` (the port's dp
    ranks carry the global count in the batch); a MoE model's loss of one
    dp rank with ``dp_size`` (its dp ranks share the aux); a stage given
    as a dict with ``tp_axis`` (it takes the list of the tp ranks'
    trees).  pp with sp, ep and MoE layers runs
    (``tests/test_torch_pp_axes.py``), and with tp
    (``tests/test_torch_pp_tp.py``)."""
    moe = dataclasses.replace(llama.LlamaConfig.tiny(n_layers=2),
                              moe_experts=4)
    assert make_ranks(MeshConfig(tp=2, pp=2), "cpu").tp == 2
    pc = llama.LlamaConfig.tiny()
    toks = torch.zeros((2, 8), dtype=torch.int32)
    stage = llama.stack_params(llama.init(torch.Generator().manual_seed(0),
                                          pc, "cpu"))
    for fn in (llama.loss_fn_pp, llama.loss_and_grads_pp_1f1b):
        with pytest.raises(ValueError, match="tp ranks' trees"):
            fn([stage], (toks, toks), pc, num_microbatches=1, tp_axis="tp")
        with pytest.raises(NotImplementedError, match="with_global_count"):
            fn([], (toks, toks), pc, num_microbatches=1, dp_axis="dp")
        with pytest.raises(NotImplementedError, match="pp_dp_loss_fn"):
            fn([], (toks, toks, torch.ones(1)), moe, num_microbatches=1,
               dp_size=2)
    base = ["--model=tiny", "--device=cpu", "--mesh.dp=2", "--mesh.pp=2",
            "--global_batch=4"]
    with pytest.raises(ValueError, match="virtual_stages only applies"):
        train_llama.pipeline_flags(["--pp_schedule=1f1b",
                                    "--virtual_stages=2"])
    with pytest.raises(ValueError, match="--pp_schedule must be"):
        train_llama.pipeline_flags(["--pp_schedule=zb"])
    with pytest.raises(ValueError, match="does not split"):
        train_llama.parse(base + ["--microbatches=3"])
    tcfg = TrainConfig(global_batch=8, mesh=MeshConfig(dp=2, pp=2),
                       accum_steps=2, collective=CollectiveConfig(impl="xla"),
                       optimizer=OptimizerConfig(kind="sgd",
                                                 learning_rate=0.1))
    with pytest.raises(ValueError, match="loss_and_grads_fn"):
        ShardedTrainer(None, make_ranks(tcfg.mesh, "cpu"), tcfg,
                       loss_and_grads_fn=lambda p, b: None)
    dp_cfg = TrainConfig(global_batch=8, mesh=MeshConfig(dp=2),
                         collective=CollectiveConfig(impl="xla"))
    # without pp it is JAX's explicit-gradient hook
    # (tests/test_torch_explicit_grads.py): the trainer builds
    assert ShardedTrainer(None, make_ranks(dp_cfg.mesh, "cpu"), dp_cfg,
                          loss_and_grads_fn=lambda p, b: None
                          ).loss_and_grads_fn is not None
    pp_cfg = dataclasses.replace(dp_cfg, mesh=MeshConfig(dp=2, pp=2))
    with pytest.raises(ValueError, match="param_specs"):
        ShardedTrainer(lambda p, b: None, make_ranks(pp_cfg.mesh, "cpu"),
                       pp_cfg)


# -- (f) the driver ----------------------------------------------------------------

@pytest.mark.parametrize("schedule", ["gpipe", "1f1b", "1f1b-interleaved"])
def test_train_llama_pp_on_cpu(schedule):
    out = train_llama.main([
        "--model=tiny", "--device=cpu", "--model.n_layers=4", "--seq=32",
        "--global_batch=8", "--mesh.dp=2", "--mesh.pp=2", "--microbatches=2",
        f"--pp_schedule={schedule}", "--iters=2"])
    v = 2 if schedule == "1f1b-interleaved" else 1
    assert out["pipeline_cost"] == jpl.cost_model(2, 2, schedule=schedule,
                                                  virtual_stages=v)
    assert out["mesh"]["pp"] == 2 and out["remat"]
    assert np.isfinite([out["loss_first"], out["loss_last"]]).all()
    # the three schedules compute the same first step
    ref = train_llama.main([
        "--model=tiny", "--device=cpu", "--model.n_layers=4", "--seq=32",
        "--global_batch=8", "--mesh.dp=2", "--iters=1"])
    np.testing.assert_allclose(out["loss_first"], ref["loss_first"],
                               rtol=1e-5)
