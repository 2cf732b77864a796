"""Tensor-parallel decoding and serving ticks on the port against the JAX
package, on the CPU.

JAX runs ``llama_decode`` under ``shard_map`` over a ``"tp"`` mesh
(``tests/test_llama_decode.py``'s tp cases, green in the suite), each rank
its heads and its slice of the cache; the port runs the tp ranks' trees
at once (``tp_axis="tp"``), the cache and pool holding every rank's kv
heads.  On the tiny f32 Llama (4 heads, 2 kv heads; tp = 4 replicates the
kv heads) and a tiny MoE Llama (experts' hidden split over tp):

- ``generate`` at tp = 2 and 4 token-exact against JAX's
  ``generate(tp_axis="tp")`` under ``shard_map``, and ``forward`` one
  token at a time within 3e-4 of JAX's (its tolerance there);
- ``forward_paged`` under tp bit-equal to ``forward`` over the contiguous
  cache (both attend routes; the kernel's plain version on the CPU);
- the tp engine (``tp_mesh`` a ``VirtualRanks`` or ``MeshConfig(tp=)``)
  serving the streams of the tp = 1 engine and of JAX's engine, evictions
  included (JAX's own tp engine test is red: ROADMAP C.4);
- the refusals: ``page_integrity`` with tp (JAX's ``ValueError``), a
  tp_mesh with other axes, pp with tp; and the roles with tp (a prefill
  replica's pages handed to a decode replica give the tp = 1 stream).
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
from fpga_ai_nic_tpu.serve import ServeConfig as JaxServeConfig
from fpga_ai_nic_tpu.serve import ServeEngine as JaxServeEngine
from fpga_ai_nic_tpu_torch.models import llama, llama_decode as dec
from fpga_ai_nic_tpu_torch.parallel.mesh import VirtualRanks
from fpga_ai_nic_tpu_torch.serve import (ServeConfig, ServeEngine, handoff,
                                         init_pool, pool_bytes)
from fpga_ai_nic_tpu_torch.utils.config import MeshConfig

JC = jax_llama.LlamaConfig.tiny()
JC_MOE = dataclasses.replace(jax_llama.LlamaConfig.tiny(ffn_dim=64),
                             moe_experts=4)
MAX_NEW = 5
SHAPE = dict(max_reqs=4, page_size=4, max_pages_per_seq=6, prefill_chunk=6)
PS, NP, PW = 4, 16, 4                  # page size, pool pages, P


def _pc(jc):
    return llama.LlamaConfig(**jc.__dict__)


def _params(jc, seed=0):
    return jax.tree_util.tree_map(
        np.asarray, jax_llama.init(jax.random.PRNGKey(seed), jc))


def _shards(jc, params, tp):
    return llama.params_from_jax(params, "cpu", specs=llama.param_specs(
        _pc(jc), "tp", None, tp), grid={"tp": tp})


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _jax_tp(fn, jc, tp, *args):
    """``fn(params, *args)`` under ``shard_map`` over a tp mesh, the params
    at JAX's ``param_specs(tp_size=tp)``, everything else replicated."""
    mesh = Mesh(np.asarray(jax.devices()[:tp]), ("tp",))
    specs = jax_llama.param_specs(jc, tp_axis="tp", tp_size=tp)
    return np.asarray(jax.jit(jax.shard_map(
        fn, mesh=mesh, in_specs=(specs,) + (P(),) * (len(args) - 1),
        out_specs=P(), check_vma=False))(*args))


@pytest.mark.parametrize("jc,tp", [(JC, 2), (JC, 4), (JC_MOE, 2)])
def test_generate_under_tp_matches_jax(jc, tp):
    params = _params(jc, 1)
    prompt = np.random.default_rng(tp).integers(
        0, jc.vocab, (2, 8)).astype(np.int32)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    want = np.asarray(jax_dec.generate(jp, jnp.asarray(prompt), MAX_NEW, jc))
    want_tp = _jax_tp(lambda p, t: jax_dec.generate(
        p, t, MAX_NEW, jc, tp_axis="tp"), jc, tp, jp, jnp.asarray(prompt))
    np.testing.assert_array_equal(want_tp, want)
    got = dec.generate(_shards(jc, params, tp), torch.from_numpy(prompt),
                       MAX_NEW, _pc(jc), tp_axis="tp")
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("tp", [2, 4])
def test_incremental_forward_under_tp_matches_jax(tp):
    """One token at a time through the tp cache (every rank's kv heads;
    under replication tp one-head blocks): the logits at every position
    against JAX's per-rank caches under ``shard_map`` (rtol = atol =
    3e-4, JAX's test) and the unsharded training forward."""
    params = _params(JC, 2)
    S = 8
    toks = np.random.default_rng(7).integers(0, JC.vocab, (2, S)).astype(
        np.int32)

    def jfn(p, t):
        cache = jax_dec.init_cache(JC, 2, S, tp_size=tp)
        outs = []
        for i in range(S):
            lg, cache = jax_dec.forward(p, t[:, i:i + 1], cache,
                                        jnp.int32(i), JC, tp_axis="tp")
            outs.append(lg[:, 0])
        return jnp.stack(outs, axis=1)

    jp = jax.tree_util.tree_map(jnp.asarray, params)
    want = _jax_tp(jfn, JC, tp, jp, jnp.asarray(toks))
    shards = _shards(JC, params, tp)
    pc = _pc(JC)
    cache = dec.init_cache(pc, 2, S, device="cpu", tp_size=tp)
    assert cache[0]["k"].shape[1] == dec.kv_local_heads(pc, tp) * tp
    outs = []
    for i in range(S):
        lg, cache = dec.forward(shards, torch.from_numpy(toks[:, i:i + 1]),
                                cache, i, pc, tp_axis="tp")
        outs.append(lg[:, 0])
    got = _np(torch.stack(outs, dim=1))
    np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-4)
    full = np.asarray(jax_llama.apply(jp, jnp.asarray(toks), JC))
    np.testing.assert_allclose(got, full, rtol=3e-4, atol=3e-4)


def _dirty_pool(pc, tp, seed):
    rng = np.random.default_rng(seed)
    kv = dec.kv_local_heads(pc, tp) * tp
    return [{k: torch.from_numpy(rng.standard_normal(
        (NP, kv, PS, pc.head_dim)).astype(np.float32)) for k in ("k", "v")}
        for _ in range(pc.n_layers)]


@pytest.mark.parametrize("jc,tp", [(JC, 2), (JC, 4), (JC_MOE, 2)])
def test_forward_paged_under_tp_bitequal_to_contiguous(jc, tp):
    """JAX's paged == contiguous bitwise contract under tp (its kv
    replication case is ``test_paged_decode_under_kv_replication_
    bitwise``): a dirty pool, a permuted table, chunked prefill then
    decode, both attend routes."""
    pc = _pc(jc)
    shards = _shards(jc, _params(jc, 3), tp)
    rng = np.random.default_rng(11)
    Bn = 3
    toks = rng.integers(0, pc.vocab, (Bn, 10)).astype(np.int32)
    table = rng.permutation(np.arange(1, NP))[:Bn * PW].reshape(
        Bn, PW).astype(np.int32)
    cache = dec.init_cache(pc, Bn, PW * PS, device="cpu", tp_size=tp)
    pool = _dirty_pool(pc, tp, 12)
    steps = [(toks[:, 0:4], 0), (toks[:, 4:8], 4)] + [
        (toks[:, s:s + 1], s) for s in range(8, 10)]
    for chunk, p0 in steps:
        want, cache = dec.forward(shards, torch.from_numpy(chunk), cache,
                                  p0, pc, tp_axis="tp")
        for impl in ("reference", "kernel"):
            got, _ = dec.forward_paged(
                shards, torch.from_numpy(chunk),
                [{k: v.clone() for k, v in lyr.items()} for lyr in pool],
                torch.from_numpy(table), torch.full((Bn,), p0), pc,
                page_size=PS, tp_axis="tp", attend_impl=impl)
            assert torch.equal(got, want), (impl, p0)
        dec.forward_paged(shards, torch.from_numpy(chunk), pool,
                          torch.from_numpy(table), torch.full((Bn,), p0),
                          pc, page_size=PS, tp_axis="tp",
                          attend_impl="reference")


@pytest.fixture(scope="module")
def world():
    jparams = jax_llama.init(jax.random.PRNGKey(0), JC)
    params = llama.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, JC.vocab, int(n)).astype(np.int32)
               for n in rng.integers(4, 14, 6)]
    return jparams, params, prompts


def _serve(engine, prompts):
    reqs = [engine.submit(p, max_new=MAX_NEW) for p in prompts]
    return reqs, engine.run()


@pytest.mark.parametrize("mesh,n_pages", [
    (VirtualRanks(1, torch.device("cpu"), tp=2), 40),
    (MeshConfig(tp=2), 9),
    (MeshConfig(tp=4), 40),
    (VirtualRanks(1, torch.device("cpu"), tp=4), 9)])
def test_tp_engine_streams_equal_tp1_and_jax(world, mesh, n_pages):
    """The tp engine's token streams equal the tp = 1 engine's and JAX's
    engine's (reference attend), evictions too (9 pages evict)."""
    jparams, params, prompts = world
    scfg = ServeConfig(n_pages=n_pages, page_integrity=False, **SHAPE)
    reqs1, s1 = _serve(ServeEngine(params, _pc(JC), scfg, device="cpu"),
                       prompts)
    eng = ServeEngine(params, _pc(JC), scfg, device="cpu", tp_mesh=mesh)
    assert eng.tp_size == mesh.tp and isinstance(eng.params, list)
    kv = dec.kv_local_heads(_pc(JC), mesh.tp) * mesh.tp
    assert eng.pool[0]["k"].shape[1] == kv
    reqs, s = _serve(eng, prompts)
    assert [r.generated for r in reqs] == [r.generated for r in reqs1]
    assert s["evictions"] == s1["evictions"]
    assert (s["evictions"] > 0) == (n_pages == 9)
    assert s["serve"]["pool_bytes"] == pool_bytes(_pc(JC), scfg,
                                                  tp_size=mesh.tp)
    jeng = JaxServeEngine(jparams, JC, JaxServeConfig(
                              n_pages=n_pages, page_integrity=False, **SHAPE),
                          attend_impl="reference")
    jreqs, _ = _serve(jeng, prompts)
    assert [r.generated for r in reqs] == [r.generated for r in jreqs]


def test_tp_engine_moe_streams_equal_tp1():
    params = llama.params_from_jax(_params(JC_MOE, 4), "cpu")
    prompts = [np.arange(3 + i, dtype=np.int32) % JC_MOE.vocab
               for i in range(5)]
    scfg = ServeConfig(n_pages=40, page_integrity=False, **SHAPE)
    reqs1, _ = _serve(ServeEngine(params, _pc(JC_MOE), scfg, device="cpu"),
                      prompts)
    reqs, _ = _serve(ServeEngine(params, _pc(JC_MOE), scfg, device="cpu",
                                 tp_mesh=MeshConfig(tp=2)), prompts)
    assert [r.generated for r in reqs] == [r.generated for r in reqs1]


def test_tp_pool_sizes():
    pc = _pc(JC)
    scfg = ServeConfig(n_pages=5, **SHAPE)
    for tp, kv in ((1, 2), (2, 2), (4, 4)):     # tp = 4: one head a rank
        pool = init_pool(pc, scfg, device="cpu", tp_size=tp)
        assert pool[0]["k"].shape == (5, kv, SHAPE["page_size"],
                                      pc.head_dim)
        assert pool_bytes(pc, scfg, tp_size=tp) == sum(
            t.numel() * t.element_size() for lyr in pool
            for t in lyr.values())


def test_tp_engine_refusals(world):
    _, params, _ = world
    pc = _pc(JC)
    with pytest.raises(ValueError, match="page_integrity"):
        ServeEngine(params, pc, ServeConfig(page_integrity=True, **SHAPE),
                    device="cpu", tp_mesh=MeshConfig(tp=2))
    scfg = ServeConfig(page_integrity=False, **SHAPE)
    with pytest.raises(ValueError, match="tp ranks only"):
        ServeEngine(params, pc, scfg, device="cpu",
                    tp_mesh=MeshConfig(dp=2, tp=2))
    with pytest.raises(TypeError, match="tp_mesh"):
        ServeEngine(params, pc, scfg, device="cpu", tp_mesh=object())
    with pytest.raises(ValueError, match="must divide n_heads"):
        ServeEngine(params, pc, scfg, device="cpu",
                    tp_mesh=MeshConfig(tp=3))
    # chaos and the watchdog, refused until A.8's restore tier was
    # ported, construct with tp as JAX's engine allows
    from fpga_ai_nic_tpu_torch.runtime import chaos
    eng = ServeEngine(params, pc, ServeConfig(page_integrity=False,
                                              step_timeout_s=30.0, **SHAPE),
                      device="cpu", tp_mesh=MeshConfig(tp=2),
                      chaos=chaos.FaultPlan([]))
    assert eng.watchdog.timeout_s == 30.0 and eng.chaos.faults == ()
    # the roles, refused with tp until the fleet was ported, run with tp
    # as JAX's engine allows: a prefill replica prefills only, its pages
    # hand off to a decode replica, which decodes only; the stream is the
    # tp = 1 engine's
    _, prompts = world[0], world[2]
    (ref,), _ = _serve(ServeEngine(params, pc, scfg, device="cpu"),
                       prompts[:1])
    pre, dcd = (ServeEngine(params, pc, scfg, device="cpu",
                            tp_mesh=MeshConfig(tp=2), role=role)
                for role in ("prefill", "decode"))
    req = pre.submit(prompts[0], MAX_NEW)
    dcd.submit(prompts[1], MAX_NEW)          # a decode replica admits none
    while req.state != "decode":
        pre.tick()
        dcd.tick()
    src = pre.batcher.pages_of(req)
    dst = dcd.alloc.alloc(len(src))
    handoff.apply_handoff(handoff.plan_for(pc, scfg, len(src)), pre.pool,
                          dcd.pool, src, dst)
    pre.batcher.release(req)
    assert dcd.batcher.adopt(req, dst) is not None
    while not req.done:
        assert pre.tick() is False
        dcd.tick()
    assert req.generated == ref.generated
    assert pre.trace_counts() == {"prefill": 1, "decode": 0}
    assert dcd.trace_counts() == {"prefill": 0, "decode": 1}
    assert len(dcd.batcher.waiting) == 1
