"""The port's Llama decode path against the JAX package, on the CPU.

The same seeded numpy inputs go through the JAX functions and the port's;
the JAX parameter pytree is carried across with ``llama.params_from_jax``.

- ``forward`` / ``forward_paged`` logits: atol = rtol = 1e-5 in float32
  (the two frameworks sum the matmuls in other orders); in bfloat16 the
  frameworks round at other places (each projection's output, the
  residual adds), a few bf16 ulps of O(1) logits: atol = rtol = 0.1.
- ``forward_paged(attend_impl="reference")`` is bit-equal to the port's
  own ``forward`` over a contiguous cache, for a shuffled page assignment
  into a dirty pool — the port's copy of the JAX mask-parity contract.
- ``generate``'s greedy tokens equal JAX's.
"""

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import jax
import jax.numpy as jnp

from fpga_ai_nic_tpu.models import llama as jax_llama
from fpga_ai_nic_tpu.models import llama_decode as jax_dec
from fpga_ai_nic_tpu_torch.models import llama, llama_decode as dec

CFG = llama.LlamaConfig.tiny()
JCFG = jax_llama.LlamaConfig.tiny()
B, PS, NP, PW = 3, 4, 16, 4            # slots, page size, pool pages, P
F32_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=0.1, rtol=0.1)


def _jax_params(jcfg, seed=0):
    p = jax_llama.init(jax.random.PRNGKey(seed), jcfg)
    return jax.tree_util.tree_map(np.asarray, p)


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _schedule(toks, chunk):
    """(tokens [B, chunk-or-1], pos): chunked prefill of about half the
    stream (zero-padded chunks), then one token per step."""
    Bn, S = toks.shape
    n_pre = max(1, (S // 2) // chunk * chunk)
    out = []
    for s in range(0, n_pre, chunk):
        c = toks[:, s:s + chunk]
        if c.shape[1] < chunk:
            c = np.concatenate(
                [c, np.zeros((Bn, chunk - c.shape[1]), np.int32)], axis=1)
        out.append((c, s))
    for s in range(n_pre, S):
        out.append((toks[:, s:s + 1], s))
    return out


def _table(rng, R, P_, n_pages):
    pages = rng.permutation(np.arange(1, n_pages))[:R * P_]
    return pages.reshape(R, P_).astype(np.int32)


def _dirty_pool_np(rng, cfg, n_pages):
    shape = (n_pages, cfg.n_kv_heads, PS, cfg.head_dim)
    return [{"k": (rng.standard_normal(shape) * 1e6).astype(np.float32),
             "v": (rng.standard_normal(shape) * 1e6).astype(np.float32)}
            for _ in range(cfg.n_layers)]


def test_params_from_jax_and_counts():
    tree = _jax_params(JCFG)
    p = llama.params_from_jax(tree, "cpu")
    assert set(p) == set(tree)
    for a, b in zip(p["layers"], tree["layers"]):
        for k in b:
            np.testing.assert_array_equal(a[k].numpy(), b[k])
    assert llama.num_params(CFG) == jax_llama.num_params(JCFG)
    assert llama.num_params(llama.LlamaConfig.llama3_8b()) == \
        jax_llama.num_params(jax_llama.LlamaConfig.llama3_8b())
    assert llama.param_bytes(p) == 4 * llama.num_params(CFG)


def test_init_fan_in_scaling():
    big = llama.LlamaConfig.tiny(dim=256, ffn_dim=512)
    p = llama.init(torch.Generator().manual_seed(0), big, "cpu")
    lyr = p["layers"][0]
    assert abs(float(lyr["wq"].std()) - 256 ** -0.5) < 0.05 * 256 ** -0.5
    assert abs(float(lyr["w2"].std()) - 512 ** -0.5) < 0.05 * 512 ** -0.5
    assert bool((lyr["attn_norm"] == 1).all())
    # a MoE layer: the router stays f32, the experts take the model dtype,
    # both at JAX's fan-in scaling
    moe_cfg = llama.LlamaConfig(**{**big.__dict__, "moe_experts": 4,
                                   "dtype": "bfloat16"})
    m = llama.init(torch.Generator().manual_seed(0), moe_cfg,
                   "cpu")["layers"][0]["moe"]
    assert m["wr"].dtype == torch.float32 and m["w1"].dtype == torch.bfloat16
    assert abs(float(m["w1"].float().std()) - 256 ** -0.5) < 0.05 * 256 ** -0.5
    assert abs(float(m["w2"].float().std()) - 512 ** -0.5) < 0.05 * 512 ** -0.5
    assert m["w1"].shape == (4, 256, 512) and m["wr"].shape == (256, 4)


@pytest.mark.parametrize("scaling", [1.0, 8.0])
def test_rope_freqs_and_rope(scaling):
    cfg = llama.LlamaConfig.tiny()
    cfg = llama.LlamaConfig(**{**cfg.__dict__, "rope_scaling": scaling,
                               "rope_old_context": 16})
    jcfg = jax_llama.LlamaConfig(**cfg.__dict__)
    half = 32
    np.testing.assert_allclose(
        llama._rope_freqs(cfg, half).numpy(),
        np.asarray(jax_llama._rope_freqs(jcfg, half)), rtol=1e-6)
    x = np.random.default_rng(1).standard_normal((2, 3, 7, 64)).astype(
        np.float32)
    pos = np.arange(100, 107, dtype=np.int32)
    got = llama._rope(torch.from_numpy(x), torch.from_numpy(pos), cfg)
    want = jax_llama._rope(jnp.asarray(x), jnp.asarray(pos), jcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_rmsnorm_casts_before_weight():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 64)).astype(np.float32) * 3
    w = rng.standard_normal(64).astype(np.float32)
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        got = llama._rmsnorm(torch.from_numpy(x).to(dt),
                             torch.from_numpy(w).to(dt), 1e-5)
        want = jax_llama._rmsnorm(jnp.asarray(x, jdt), jnp.asarray(w, jdt),
                                  1e-5)
        tol = F32_TOL if dt == torch.float32 else dict(atol=0.05, rtol=0.02)
        np.testing.assert_allclose(_np(got),
                                   np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_forward_paged_match_jax(dtype):
    cfg = llama.LlamaConfig.tiny(dtype=dtype)
    jcfg = jax_llama.LlamaConfig.tiny(dtype=dtype)
    tree = _jax_params(jcfg)
    params = llama.params_from_jax(tree, "cpu")
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab, (B, 10)).astype(np.int32)
    table = _table(rng, B, PW, NP)
    dirty = _dirty_pool_np(rng, cfg, NP)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    dt = getattr(torch, dtype)
    cache = dec.init_cache(cfg, B, PW * PS, device="cpu")
    jcache = jax_dec.init_cache(jcfg, B, PW * PS)
    pool = [{k: torch.from_numpy(v.copy()).to(dt) for k, v in lyr.items()}
            for lyr in dirty]
    jpool = [{k: jnp.asarray(v, jnp.dtype(dtype)) for k, v in lyr.items()}
             for lyr in dirty]
    for chunk, p0 in _schedule(toks, 4):
        got, cache = dec.forward(params, torch.from_numpy(chunk), cache, p0,
                                 cfg)
        want, jcache = jax_dec.forward(tree, jnp.asarray(chunk), jcache,
                                       jnp.int32(p0), jcfg)
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                                   **tol)
        pos = np.full((B,), p0, np.int32)
        gotp, pool = dec.forward_paged(
            params, torch.from_numpy(chunk), pool, torch.from_numpy(table),
            torch.from_numpy(pos), cfg, page_size=PS)
        wantp, jpool = jax_dec.forward_paged(
            tree, jnp.asarray(chunk), jpool, jnp.asarray(table),
            jnp.asarray(pos), jcfg, page_size=PS)
        np.testing.assert_allclose(_np(gotp), np.asarray(wantp, np.float32),
                                   **tol)
    # the in-place pool writes land where JAX's functional ones do
    live = np.unique(table)
    for lyr, jlyr in zip(pool, jpool):
        for k in ("k", "v"):
            np.testing.assert_allclose(
                _np(lyr[k])[live], np.asarray(jlyr[k], np.float32)[live],
                **tol)


def test_forward_paged_ragged_positions_and_inactive_match_jax():
    tree = _jax_params(JCFG)
    params = llama.params_from_jax(tree, "cpu")
    rng = np.random.default_rng(4)
    table = _table(rng, B, PW, NP)
    dirty = _dirty_pool_np(rng, CFG, NP)
    pool = [{k: torch.from_numpy(v.copy()) for k, v in lyr.items()}
            for lyr in dirty]
    jpool = [{k: jnp.asarray(v) for k, v in lyr.items()} for lyr in dirty]
    pos = np.array([9, 0, 14], np.int32)
    active = np.array([True, False, True])
    toks = rng.integers(0, CFG.vocab, (B, 1)).astype(np.int32)
    got, pool = dec.forward_paged(
        params, torch.from_numpy(toks), pool, torch.from_numpy(table),
        torch.from_numpy(pos), CFG, page_size=PS,
        active=torch.from_numpy(active))
    want, jpool = jax_dec.forward_paged(
        tree, jnp.asarray(toks), jpool, jnp.asarray(table), jnp.asarray(pos),
        JCFG, page_size=PS, active=jnp.asarray(active))
    np.testing.assert_allclose(_np(got)[active],
                               np.asarray(want)[active], **F32_TOL)
    # the inactive slot wrote nothing into its table row's pages, only
    # zeros into the null page at its position's offset
    for lyr, d in zip(pool, dirty):
        np.testing.assert_array_equal(lyr["k"].numpy()[table[1]],
                                      d["k"][table[1]])
        np.testing.assert_array_equal(lyr["k"].numpy()[0, :, 0], 0)


def test_forward_paged_reference_bitequal_to_contiguous():
    params = llama.params_from_jax(_jax_params(JCFG), "cpu")
    rng = np.random.default_rng(5)
    toks = rng.integers(0, CFG.vocab, (B, 10)).astype(np.int32)
    table = _table(rng, B, PW, NP)
    cache = dec.init_cache(CFG, B, PW * PS, device="cpu")
    pool = [{k: torch.from_numpy(v.copy()) for k, v in lyr.items()}
            for lyr in _dirty_pool_np(rng, CFG, NP)]
    for chunk, p0 in _schedule(toks, 4):
        want, cache = dec.forward(params, torch.from_numpy(chunk), cache,
                                  p0, CFG)
        for impl in ("reference", "kernel"):      # kernel: plain on CPU
            got, _ = dec.forward_paged(
                params, torch.from_numpy(chunk),
                [{k: v.clone() for k, v in lyr.items()} for lyr in pool],
                torch.from_numpy(table), torch.full((B,), p0), CFG,
                page_size=PS, attend_impl=impl)
            assert torch.equal(got, want), (impl, p0)
        dec.forward_paged(params, torch.from_numpy(chunk), pool,
                          torch.from_numpy(table), torch.full((B,), p0),
                          CFG, page_size=PS, attend_impl="reference")
    with pytest.raises(ValueError, match="attend_impl"):
        dec.forward_paged(params, torch.from_numpy(toks[:, :1]), pool,
                          torch.from_numpy(table), torch.zeros(B), CFG,
                          page_size=PS, attend_impl="pallas")


def test_generate_tokens_equal_jax():
    tree = _jax_params(JCFG)
    params = llama.params_from_jax(tree, "cpu")
    rng = np.random.default_rng(6)
    prompt = rng.integers(0, CFG.vocab, (2, 7)).astype(np.int32)
    got = dec.generate(params, torch.from_numpy(prompt), 6, CFG)
    want = jax_dec.generate(jax.tree_util.tree_map(jnp.asarray, tree),
                            jnp.asarray(prompt), 6, JCFG)
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, 13)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
