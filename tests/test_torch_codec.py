"""The port's top-k codec, error feedback and codec rings against the JAX
package and the bit spec.

Top-k's selection (ties included) and ``error_feedback_encode`` are held
bit for bit against JAX's; the plain rings (``ops.ring``) with int8 in both
layouts and with top-k against the codec-generic ring golden of both
packages.  The rings encode all ranks in one codec call, so they refuse a
rank part that is not a whole number of the codec's layout units — for the
sublane layout, whole (16, 128) tiles — as JAX's Pallas kernels assert.
"""

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import jax.numpy as jnp

from fpga_ai_nic_tpu import compress as jax_compress
from fpga_ai_nic_tpu.compress import golden as jax_golden
from fpga_ai_nic_tpu.ops import fused_update as jax_fused_update
from fpga_ai_nic_tpu_torch import compress
from fpga_ai_nic_tpu_torch.compress import golden
from fpga_ai_nic_tpu_torch.ops import fused_update, ring
from fpga_ai_nic_tpu_torch.utils.config import BFPConfig
from fpga_ai_nic_tpu.utils.config import BFPConfig as JaxBFPConfig

TILE = 16 * 128

# (name, port codec, JAX codec)
CODECS = {
    "topk": (lambda: compress.TopKCodec(bucket_elems=256, k=32),
             lambda: jax_compress.TopKCodec(bucket_elems=256, k=32)),
    "int8_flat": (lambda: compress.Int8Codec(seed=5),
                  lambda: jax_compress.Int8Codec(seed=5)),
    "int8_sublane": (lambda: compress.Int8Codec(backend="pallas", seed=5),
                     lambda: jax_compress.Int8Codec(backend="pallas",
                                                    seed=5)),
    "int8_nearest": (lambda: compress.Int8Codec(rounding="nearest"),
                     lambda: jax_compress.Int8Codec(rounding="nearest")),
    "bfp_sublane": (lambda: compress.BFPCodec(BFPConfig(codec="pallas")),
                    lambda: jax_compress.BFPCodec(
                        JaxBFPConfig(codec="pallas"))),
}


def _shards(n, L, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, L)) * 3).astype(np.float32)


def _tied(n_elems, seed=0):
    """Magnitudes from a small set, so every bucket holds long runs of
    ties (zeros, and +-v pairs of equal magnitude)."""
    rng = np.random.default_rng(seed)
    return (rng.integers(-4, 5, n_elems) * 0.5).astype(np.float32)


@pytest.mark.parametrize("bucket,k", [(256, 32), (512, 64), (64, 64)])
@pytest.mark.parametrize("kind", ["tied", "gaussian"])
def test_topk_equals_jax(bucket, k, kind):
    """Values, indices and decode equal JAX's TopKCodec and both goldens,
    bit for bit — ties kept in ascending index order."""
    n = 8 * 512
    x = _tied(n, bucket) if kind == "tied" else _shards(1, n, bucket)[0]
    c = compress.TopKCodec(bucket_elems=bucket, k=k)
    j = jax_compress.TopKCodec(bucket_elems=bucket, k=k)
    vals, idx = c.encode(torch.from_numpy(x))
    jv, ji = j.encode(jnp.asarray(x))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    gv, gi = golden.topk_encode(x, bucket, k)
    np.testing.assert_array_equal(idx.numpy(), gi)
    np.testing.assert_array_equal(gi, jax_golden.topk_encode(x, bucket, k)[1])
    got = c.decode((vals, idx), n).numpy()
    np.testing.assert_array_equal(got, np.asarray(j.decode((jv, ji), n)))
    np.testing.assert_array_equal(got, golden.topk_decode(gv, gi, n, bucket))
    if kind == "tied":          # the tie rule is exercised, not vacuous
        mags = np.abs(x.reshape(-1, bucket))
        kth = -np.sort(-mags, axis=-1)[:, k - 1]
        assert ((mags == kth[:, None]).sum(-1) > 1).any()


def test_topk_facts_equal_jax():
    for opts in ({}, {"bucket_elems": 256, "k": 64},
                 {"bucket_elems": 1024, "k": 8, "error_feedback": False}):
        c, j = compress.TopKCodec(**opts), jax_compress.TopKCodec(**opts)
        assert c.describe() == j.describe()
        assert c.wire_bytes(1 << 16) == j.wire_bytes(1 << 16)
        for chunk, sl in ((8192, 4096), (8192, 256), (8192, 100), (512,
                                                                    None)):
            assert c.sliceable(chunk, sl) == j.sliceable(chunk, sl)
    assert compress.get_codec("topk").error_feedback
    st = compress.TopKCodec().state_init((2, 1024))
    assert st.shape == (2, 1024) and not bool(st.any())
    assert compress.Int8Codec().state_init((2, 16)) is None
    assert compress.BFPCodec().describe() == jax_compress.BFPCodec(
    ).describe()


@pytest.mark.parametrize("name", list(CODECS))
def test_error_feedback_equals_jax(name):
    """Three steps of compensate-then-compress over two ranks: the wire
    vector and the residual equal JAX's ``error_feedback_encode`` on each
    rank, bit for bit."""
    port, jx = CODECS[name][0](), CODECS[name][1]()
    n, L = 2, 2 * TILE
    resid = torch.zeros((n, L))
    jres = [jnp.zeros(L, jnp.float32) for _ in range(n)]
    for step in range(3):
        g = _shards(n, L, seed=10 + step)
        wire, resid = fused_update.error_feedback_encode(
            port, torch.from_numpy(g), resid)
        for i in range(n):
            jw, jres[i] = jax_fused_update.error_feedback_encode(
                jx, jnp.asarray(g[i]), jres[i])
            np.testing.assert_array_equal(wire[i].numpy(), np.asarray(jw))
            np.testing.assert_array_equal(resid[i].numpy(),
                                          np.asarray(jres[i]))


@pytest.mark.parametrize("name", ["topk", "int8_flat", "int8_sublane",
                                  "int8_nearest"])
@pytest.mark.parametrize("n", [2, 3])
def test_plain_ring_equals_golden(name, n):
    """ring_reduce_scatter and ring_all_reduce over n virtual ranks ==
    the port's ring golden == the JAX package's, bit for bit."""
    port, jx = CODECS[name][0](), CODECS[name][1]()
    x = _shards(n, n * 2 * TILE, seed=n)
    want_rs = golden.ring_reduce_scatter(x, golden.roundtrip_fn(port))
    np.testing.assert_array_equal(want_rs, jax_golden.ring_reduce_scatter(
        x, jax_golden.roundtrip_fn(jx)))
    got_rs = ring.ring_reduce_scatter(torch.from_numpy(x), port)
    np.testing.assert_array_equal(got_rs.numpy(), want_rs)
    want = golden.ring_all_reduce(x, golden.roundtrip_fn(port))
    np.testing.assert_array_equal(want, jax_golden.ring_all_reduce(
        x, jax_golden.roundtrip_fn(jx)))
    got = ring.ring_all_reduce(torch.from_numpy(x), port).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got == got[0]).all()


@pytest.mark.parametrize("name", ["int8_sublane", "bfp_sublane"])
def test_ring_refuses_rank_parts_off_the_tile_grid(name):
    """A rank chunk of 2064 = 16 x 129 elements is a whole number of int8
    blocks but not of (16, 128) tiles (C % 2048 != 0): encoding both ranks
    in one call would mix their blocks, so the rings raise, as the golden's
    sublane layout and JAX's kernels refuse it.  The flat layout takes it."""
    port = CODECS[name][0]()
    n, C = 2, 16 * 129
    x = torch.from_numpy(_shards(n, n * C))
    with pytest.raises(ValueError, match="layout units"):
        ring.ring_reduce_scatter(x, port)
    with pytest.raises(ValueError, match="layout units"):
        ring.ring_all_gather(x[:, :C].contiguous(), port)
    with pytest.raises(ValueError, match="divisible by 2048"):
        jax_golden.ring_reduce_scatter(
            x.numpy(), jax_golden.roundtrip_fn(CODECS[name][1]()))
    flat = compress.Int8Codec(seed=5)
    got = ring.ring_all_reduce(x, flat).numpy()
    np.testing.assert_array_equal(got, golden.ring_all_reduce(
        x.numpy(), golden.roundtrip_fn(flat)))


@pytest.mark.parametrize("name,slice_elems,sliceable", [
    ("int8_sublane", TILE, True), ("int8_sublane", 1024, False),
    ("int8_flat", 1024, True), ("topk", 512, True), ("topk", 200, False)])
def test_sliced_hops_equal_whole_hops(name, slice_elems, sliceable):
    """Where ``sliceable`` allows slicing, sliced and whole hops give the
    same bits; where it does not, the ring sends the whole chunk."""
    port = CODECS[name][0]()
    n, C = 2, 4 * TILE
    assert port.sliceable(C, slice_elems) == sliceable
    x = torch.from_numpy(_shards(n, n * C, seed=3))
    whole = ring.ring_reduce_scatter(x, port)
    sliced = ring.ring_reduce_scatter(x, port, slice_elems=slice_elems)
    np.testing.assert_array_equal(sliced.numpy(), whole.numpy())
