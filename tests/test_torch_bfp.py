"""The port's BFP codecs (torch) against the bit spec and the JAX codecs.

Both layouts: "flat16" (``ops.bfp``, consecutive blocks) and "sublane"
(``ops.bfp_cuda``, blocks of elements 128 apart — the CUDA kernels'
layout, run here through their plain versions because the tensors lie on
the CPU).  Every comparison is bit for bit.
"""

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import jax.numpy as jnp

from fpga_ai_nic_tpu.ops import bfp as jax_bfp
from fpga_ai_nic_tpu.ops import bfp_golden as jax_golden
from fpga_ai_nic_tpu.ops import bfp_pallas as jax_bfp_pallas
from fpga_ai_nic_tpu.ops import ring as jax_ring
from fpga_ai_nic_tpu.utils.config import BFPConfig as JaxBFPConfig
from fpga_ai_nic_tpu_torch.compress import BFPCodec, get_codec
from fpga_ai_nic_tpu_torch.ops import bfp, bfp_cuda, bfp_golden, ring
from fpga_ai_nic_tpu_torch.utils.config import BFPConfig

N = 2 * 16 * 128          # two sublane tiles of the default block


def _inputs(seed: int = 0) -> np.ndarray:
    """Gaussian values plus the corners: zeros, a block of subnormals in
    each layout, tiny normals whose scale clamps at -126, and block maxima
    that round past +-127 and clip."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(N) * 3).astype(np.float32)
    x[::97] = 0.0
    sub = (rng.standard_normal(16) * 1e-39).astype(np.float32)
    x[16:32] = sub                       # a whole flat16 block
    x[2048 + 5:4096:128] = sub           # a whole sublane block (tile 1)
    x[7::131] = (rng.standard_normal(x[7::131].shape) * 1e-41
                 ).astype(np.float32)    # scattered subnormals
    x[64:80] = np.float32(3e-37) * rng.standard_normal(16).astype(np.float32)
    x[96:112] = np.float32(1.999) * np.sign(rng.standard_normal(16)
                                            ).astype(np.float32)
    x[300:2048:128] = np.float32(-255.9)  # sublane block max past the clip
    return x


@pytest.mark.parametrize("rounding", ["nearest", "rtz"])
@pytest.mark.parametrize("mantissa_bits", [4, 8])
def test_flat16_bitexact_vs_golden_and_jax(rounding, mantissa_bits):
    x = _inputs()
    mant, se = bfp.bfp_encode(torch.from_numpy(x), 16, mantissa_bits,
                              rounding)
    g_mant, g_se = bfp_golden.bfp_encode(x, 16, mantissa_bits, rounding)
    j_mant, j_se = jax_bfp.bfp_encode(jnp.asarray(x), 16, mantissa_bits,
                                      rounding)
    for want_m, want_s in ((g_mant, g_se), (np.asarray(j_mant),
                                            np.asarray(j_se))):
        np.testing.assert_array_equal(mant.numpy(), want_m)
        np.testing.assert_array_equal(se.numpy(), want_s)
    dec = bfp.bfp_decode(mant, se, 16).numpy()
    np.testing.assert_array_equal(dec, bfp_golden.bfp_decode(g_mant, g_se))
    np.testing.assert_array_equal(
        dec, np.asarray(jax_bfp.bfp_decode(j_mant, j_se, 16)))


@pytest.mark.parametrize("rounding", ["nearest", "rtz"])
@pytest.mark.parametrize("mantissa_bits", [4, 8])
def test_sublane_bitexact_vs_golden_and_pallas(rounding, mantissa_bits):
    x = _inputs(1)
    mant, se = bfp_cuda.bfp_encode(torch.from_numpy(x), 16, mantissa_bits,
                                   rounding)
    g_mant, g_se = bfp_golden.bfp_encode(x, 16, mantissa_bits, rounding,
                                         layout="sublane")
    p_mant, p_se = jax_bfp_pallas.bfp_encode_inline(
        jnp.asarray(x), 16, mantissa_bits, rounding, interpret=True)
    for want_m, want_s in ((g_mant, g_se), (np.asarray(p_mant),
                                            np.asarray(p_se))):
        np.testing.assert_array_equal(mant.numpy(), want_m)
        np.testing.assert_array_equal(se.numpy(), want_s)
    dec = bfp_cuda.bfp_decode(mant, se, 16).numpy()
    np.testing.assert_array_equal(
        dec, bfp_golden.bfp_decode(g_mant, g_se, layout="sublane"))
    np.testing.assert_array_equal(dec, np.asarray(
        jax_bfp_pallas.bfp_decode_inline(p_mant, p_se, 16, interpret=True)))


@pytest.mark.parametrize("layout", ["flat16", "sublane"])
def test_golden_copy_equals_jax_golden(layout):
    """The port's numpy spec is the JAX package's, unchanged."""
    x = _inputs(2)
    for rounding in ("nearest", "rtz"):
        a = bfp_golden.bfp_encode(x, 16, 8, rounding, layout=layout)
        b = jax_golden.bfp_encode(x, 16, 8, rounding, layout=layout)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])


def test_subnormal_and_clip_corners_hit():
    """The corner inputs really exercise the clamp and the clip."""
    x = _inputs()
    mant, se = bfp_golden.bfp_encode(x, 16, 8, layout="sublane")
    assert (se == -126).any()
    assert (np.abs(mant) == 127).any()
    assert (x[x != 0] != 0).all() and (np.abs(x[x != 0]) < 1.18e-38).any()


@pytest.mark.parametrize("codec", ["xla", "pallas"])
def test_codec_roundtrip_matches_layout(codec):
    cfg = BFPConfig(codec=codec)
    layout = "sublane" if codec == "pallas" else "flat16"
    x = _inputs(3)
    got = BFPCodec(cfg).roundtrip(torch.from_numpy(x)).numpy()
    m, s = bfp_golden.bfp_encode(x, layout=layout)
    np.testing.assert_array_equal(got, bfp_golden.bfp_decode(
        m, s, layout=layout))
    np.testing.assert_array_equal(
        bfp.bfp_roundtrip(torch.from_numpy(x), BFPConfig()).numpy(),
        bfp_golden.bfp_decode(*bfp_golden.bfp_encode(x)))


def test_wire_bytes_pinned():
    """136 bits per 16 f32 values (the reference frame), the same count
    as the JAX package for the same payload."""
    cfg = BFPConfig()
    assert bfp.wire_bytes(4096, cfg) == 4096 + 256
    assert BFPCodec(cfg).wire_bytes(4096) == 4352
    assert BFPCodec(cfg).wire_bytes(4096) * 8 == bfp_golden.wire_bits(4096)
    assert jax_bfp.wire_bytes(4096, JaxBFPConfig()) == 4352
    for L, n in ((4096, 8), (41_975_808, 8), (2048 * 4, 4)):
        assert ring.wire_bytes_per_device(L, n, cfg) == \
            jax_ring.wire_bytes_per_device(L, n, JaxBFPConfig())
        assert ring.wire_bytes_per_device(L, n) == \
            jax_ring.wire_bytes_per_device(L, n)
    assert get_codec("bfp").wire_bytes(16) == 17


def test_sublane_rejects_untiled_length():
    with pytest.raises(ValueError):
        bfp_cuda.bfp_encode(torch.zeros(16 * 100))
