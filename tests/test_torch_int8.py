"""The port's int8 codec against the JAX package and the bit spec.

The sublane layout's plain versions (``ops.int8_cuda``, what a CPU tensor
takes) are held bit for bit against JAX's Pallas kernels
(``int8_encode_pallas`` / ``int8_decode_pallas``) in interpret mode; the
flat layout against JAX's ``int8_encode`` / ``int8_decode``; both against
the port's numpy golden (``compress.golden``), which is held against the
JAX package's golden.  The CUDA kernels are held against the plain versions
in tests/test_torch_cuda.py.
"""

import os
import subprocess
import sys
import textwrap

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fpga_ai_nic_tpu import compress as jax_compress
from fpga_ai_nic_tpu.compress import golden as jax_golden
from fpga_ai_nic_tpu.compress import int8 as jax_int8
import fpga_ai_nic_tpu_torch
from fpga_ai_nic_tpu_torch import compress
from fpga_ai_nic_tpu_torch.compress import golden
from fpga_ai_nic_tpu_torch.ops import int8_cuda
from fpga_ai_nic_tpu_torch.utils.config import CollectiveConfig

TILE = 16 * 128
ROUNDINGS = ("stochastic", "nearest")


def _data(n, seed=0):
    """Gaussian values at mixed magnitudes, with an all-zero block in each
    layout, subnormals, negative zeros and exact grid points."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * 3).astype(np.float32)
    x *= np.float32(10.0) ** rng.integers(-3, 3, n).astype(np.float32)
    x[:16] = 0.0                             # flat block 0
    x[5 * 128:n:128][:16] = 0.0              # part of sublane column 5
    x[16 * 128 + 3::128][:16] = 0.0          # all of column 3 of tile 1
    x[40:48:2] = np.float32(1e-40)           # subnormals among normals
    x[48:52] = -0.0
    x[60:64] = np.float32(127.0)             # maxabs/127 = 1 exactly
    return x


def _bits(scale: torch.Tensor) -> np.ndarray:
    """bf16 tensor -> its bit patterns as uint16."""
    return scale.view(torch.int16).numpy().view(np.uint16)


def _jax_bits(scale) -> np.ndarray:
    return np.asarray(scale).view(np.uint16)


@pytest.mark.parametrize("rounding,seed", [("stochastic", 0),
                                          ("stochastic", 7),
                                          ("nearest", 0), ("nearest", 7)])
def test_sublane_plain_equals_pallas_interpret(rounding, seed):
    """int8_encode_plain / int8_decode_plain == JAX's Pallas kernels in
    interpret mode, bit for bit, at 1 and 5 tiles."""
    for tiles in (1, 5):
        x = _data(tiles * TILE, seed=tiles + seed)
        q, s = int8_cuda.int8_encode(torch.from_numpy(x), 16, rounding, seed)
        jq, js = jax_int8.int8_encode_pallas(jnp.asarray(x), 16, rounding,
                                             seed, interpret=True)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(_bits(s), _jax_bits(js))
        d = int8_cuda.int8_decode(q, s, 16)
        jd = jax_int8.int8_decode_pallas(jq, js, 16, interpret=True)
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd))


@pytest.mark.parametrize("block", [4, 16, 32])
@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("seed", [0, 7])
def test_flat_equals_jax(block, rounding, seed):
    x = _data(3 * TILE, seed=block)
    q, s = compress.int8.int8_encode(torch.from_numpy(x), block, rounding,
                                     seed)
    jq, js = jax_int8.int8_encode(jnp.asarray(x), block, rounding, seed)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_bits(s), _jax_bits(js))
    d = compress.int8.int8_decode(q, s, block)
    jd = jax_int8.int8_decode(jq, js, block)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))


@pytest.mark.parametrize("layout,backend", [("flat16", "xla"),
                                            ("sublane", "pallas")])
@pytest.mark.parametrize("rounding", ROUNDINGS)
def test_codec_equals_port_golden_and_golden_equals_jax(layout, backend,
                                                        rounding):
    """Int8Codec (both backends, plain=True too) == the port's golden ==
    the JAX package's golden, bit for bit."""
    x = _data(2 * TILE, seed=11)
    gq, gs = golden.int8_encode(x, 16, rounding, 3, layout)
    jq, js = jax_golden.int8_encode(x, 16, rounding, 3, layout)
    np.testing.assert_array_equal(gq, jq)
    np.testing.assert_array_equal(gs, _jax_bits(js))
    gd = golden.int8_decode(gq, gs, 16, layout=layout)
    np.testing.assert_array_equal(gd, jax_golden.int8_decode(
        jq, js, 16, layout=layout))
    for plain in (False, True):
        c = compress.Int8Codec(rounding=rounding, seed=3, backend=backend,
                               plain=plain)
        q, s = c.encode(torch.from_numpy(x))
        np.testing.assert_array_equal(q.numpy(), gq)
        np.testing.assert_array_equal(_bits(s), gs)
        np.testing.assert_array_equal(c.decode((q, s), x.shape[0]).numpy(),
                                      gd)
        np.testing.assert_array_equal(c.roundtrip(torch.from_numpy(x))
                                      .numpy(), gd)


def test_all_subnormal_block_follows_the_golden():
    """A block of subnormals only: its scale max|x| * f32(1/127) rounds to
    bf16 zero, so the golden (IEEE, subnormals kept) stores scale 0 and
    q = 127, which decodes to 0.  JAX on XLA:CPU flushes subnormal inputs
    to zero and stores scale 1.0 and q = 0: the same decoded values in
    other wire bits.  The port follows the golden in both layouts, as the
    CUDA kernel does (built with -ftz=false)."""
    x = _data(TILE, seed=2)
    x[0:16] = np.float32(1e-40)               # flat block 0
    x[7::128] = np.float32(-3e-41)            # sublane column 7
    for layout, backend in (("flat16", "xla"), ("sublane", "pallas")):
        c = compress.Int8Codec(backend=backend, rounding="nearest")
        q, s = c.encode(torch.from_numpy(x))
        gq, gs = golden.int8_encode(x, 16, "nearest", 0, layout)
        np.testing.assert_array_equal(q.numpy(), gq)
        np.testing.assert_array_equal(_bits(s), gs)
        blk = 0 if layout == "flat16" else 7
        assert gs[blk] == 0 and abs(int(q.numpy()[blk])) == 127
        assert c.decode((q, s), TILE).numpy()[blk] == 0.0


def test_bf16_rounding_equals_ml_dtypes():
    """The golden's numpy f32 -> bf16 rounding == ml_dtypes' cast, over
    random bit patterns (NaNs, infinities and subnormals among them) and
    constructed ties; torch's cast gives the same bits on finite values."""
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2 ** 32, 200_000, dtype=np.uint64).astype(
        np.uint32)
    ties = (rng.integers(0, 2 ** 16, 2000, dtype=np.uint32) << 16) | 0x8000
    edge = np.array([0, 0x80000000, 1, 0x007FFFFF, 0x7F7FFFFF, 0xFF7FFFFF,
                     0x7F800000, 0xFF800000, 0x7FC00000, 0x7F800001,
                     0xFFFFFFFF, 0x3F808000, 0x3F818000, 0x7F7F8000],
                    np.uint32)
    x = np.concatenate([bits, ties, edge]).view(np.float32)
    with np.errstate(invalid="ignore"):
        want = x.astype(ml_dtypes.bfloat16).view(np.uint16)
    np.testing.assert_array_equal(golden._to_bf16(x), want)
    finite = np.isfinite(x)
    got_t = _bits(torch.from_numpy(x[finite]).to(torch.bfloat16))
    np.testing.assert_array_equal(got_t, want[finite])


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5])
def test_hash_edge_bit_patterns(seed):
    """The plain torch hash (int64, 16-bit split multiplies) == the golden
    == JAX's golden on 0, -0.0, subnormals, +-inf, the largest finite
    values and random patterns."""
    edge = np.array([0, 0x80000000, 1, 0x80000001, 0x007FFFFF, 0x807FFFFF,
                     0x7F800000, 0xFF800000, 0x7F7FFFFF, 0xFF7FFFFF,
                     0x3F800000, 0xFFFFFFFF], np.uint32)
    rng = np.random.default_rng(seed % 1000)
    bits = np.concatenate([edge, rng.integers(0, 2 ** 32, 4096,
                                              dtype=np.uint64)
                           .astype(np.uint32)])
    want = golden.hash_u01(bits, seed)
    np.testing.assert_array_equal(want, jax_golden.hash_u01(bits, seed))
    got = int8_cuda.hash_u01(torch.from_numpy(bits.view(np.float32)), seed)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.min() >= 0.0 and want.max() < 1.0
    assert int8_cuda.seed_stamp(seed) == golden.seed_stamp(seed)


def test_codec_facts_equal_jax():
    """describe(), wire_bytes, error_bound, compression ratio and
    sliceable equal JAX's for a grid of options and sizes."""
    sizes = [None, 16, 512, 2048, 4096, 8192, 6144, 24576, 3 * 8192]
    for opts in ({}, {"backend": "pallas"}, {"rounding": "nearest"},
                 {"block_size": 32, "seed": 9}, {"error_feedback": True},
                 {"block_size": 8, "backend": "pallas",
                  "rounding": "nearest"}):
        c = compress.Int8Codec(**opts)
        j = jax_compress.Int8Codec(**opts)
        assert c.describe() == j.describe()
        assert c.error_bound == j.error_bound
        assert c.compression_ratio_vs_f32 == j.compression_ratio_vs_f32
        for n in (64, 2048, 41_963_520):
            assert c.wire_bytes(n) == j.wire_bytes(n)
        for chunk in sizes[1:]:
            for sl in sizes:
                assert c.sliceable(chunk, sl) == j.sliceable(chunk, sl), (
                    opts, chunk, sl)


def test_registry_and_config():
    """get_codec("int8") works; fused_kernel with int8 raises the
    reference's ValueError; backend="auto" raises naming ROADMAP A.2."""
    assert compress.available_codecs() == ("bfp", "int8", "topk")
    assert isinstance(compress.get_codec("int8"), compress.Int8Codec)
    cfg = CollectiveConfig(impl="ring", codec="int8",
                           codec_opts=(("backend", "pallas"),))
    assert compress.resolve(cfg).backend == "pallas"
    with pytest.raises(ValueError, match="cannot ride the fused"):
        CollectiveConfig(impl="ring", codec="int8", fused_kernel=True)
    with pytest.raises(NotImplementedError, match="A.2"):
        compress.Int8Codec(backend="auto")


def test_kernel_wrappers_refuse_bad_shapes():
    """A payload that is not a whole number of tiles raises, as JAX's
    kernel asserts; a CPU tensor never reaches the launch."""
    with pytest.raises(ValueError, match="divisible by 2048"):
        int8_cuda.int8_encode(torch.zeros(TILE + 16))
    with pytest.raises(ValueError, match="CUDA tensor"):
        int8_cuda.launch_encode(torch.zeros(TILE), torch.zeros(
            TILE, dtype=torch.int8), torch.zeros(128, dtype=torch.bfloat16),
            16, "stochastic", 0)


def test_error_bound_and_unbiased():
    """One pass stays within the declared bound of each block's max, and
    stochastic rounding is unbiased over many seeds' passes."""
    x = _data(4 * TILE, seed=5)
    for backend in ("xla", "pallas"):
        for rounding in ROUNDINGS:
            c = compress.Int8Codec(backend=backend, rounding=rounding)
            err = np.abs(c.roundtrip(torch.from_numpy(x)).numpy() - x)
            layout = "sublane" if backend == "pallas" else "flat16"
            from fpga_ai_nic_tpu_torch.ops import bfp_golden
            blk = bfp_golden._to_blocks(np.abs(x), 16, layout).max(-1)
            eb = bfp_golden._to_blocks(err, 16, layout)
            assert (eb <= c.error_bound * blk[:, None] * (1 + 1e-6)).all()
    y = np.full(TILE, 0.3, np.float32) * np.linspace(0.5, 1, TILE,
                                                     dtype=np.float32)
    y[::16] = 1.0
    mean = np.mean([compress.Int8Codec(seed=s).roundtrip(
        torch.from_numpy(y)).numpy() for s in range(64)], axis=0)
    assert abs(float(np.mean(mean - y))) < 1e-4


def test_port_imports_without_jax_or_ml_dtypes():
    """Every module of the port, and ``chip_smoke``, imports with ``jax``,
    ``ml_dtypes`` and the JAX package blocked."""
    import pkgutil
    pkg = fpga_ai_nic_tpu_torch
    mods = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                  pkg.__name__ + ".")]
    for m in ("compress.int8", "compress.topk", "compress.golden",
              "ops.int8_cuda", "evals.codec_convergence"):
        assert f"fpga_ai_nic_tpu_torch.{m}" in mods, m
    mods.append("chip_smoke")
    code = textwrap.dedent(f"""
        import importlib, sys
        for name in ("jax", "jaxlib", "ml_dtypes", "fpga_ai_nic_tpu"):
            sys.modules[name] = None
        for m in {mods!r}:
            importlib.import_module(m)
        leaked = [m for m in sys.modules
                  if m.startswith(("jax.", "jaxlib.", "ml_dtypes.",
                                   "fpga_ai_nic_tpu."))
                  and sys.modules[m] is not None]
        assert not leaked, leaked
        print(len({mods!r}))
    """)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = root
    res = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) == len(mods)
