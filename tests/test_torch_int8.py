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
from torch_threads import one_torch_thread  # noqa: F401

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
    reference's ValueError; backend="auto" resolves per payload
    (tests/test_torch_codec_auto.py)."""
    assert compress.available_codecs() == ("bfp", "int8", "topk")
    assert isinstance(compress.get_codec("int8"), compress.Int8Codec)
    cfg = CollectiveConfig(impl="ring", codec="int8",
                           codec_opts=(("backend", "pallas"),))
    assert compress.resolve(cfg).backend == "pallas"
    with pytest.raises(ValueError, match="cannot ride the fused"):
        CollectiveConfig(impl="ring", codec="int8", fused_kernel=True)
    auto = compress.Int8Codec(backend="auto")
    assert auto.backend == "auto"
    assert auto.for_payload(2048, torch.device("cpu")).backend == "xla"


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
    """Every module of the port, ``chip_smoke`` and ``codec_probe`` import
    with ``jax``, ``ml_dtypes`` and the JAX package blocked."""
    import pkgutil
    pkg = fpga_ai_nic_tpu_torch
    mods = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                  pkg.__name__ + ".")]
    for m in ("compress.int8", "compress.topk", "compress.golden",
              "ops.int8_cuda", "ops.moe", "evals.codec_convergence",
              "tune.calibration", "tune.autotune", "tune.adapt",
              "parallel.reshard", "utils.trace_analysis", "obs.timeline",
              "obs_demo"):
        assert f"fpga_ai_nic_tpu_torch.{m}" in mods, m
    mods += ["chip_smoke", "codec_probe"]
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


# -- csrc/int8_codec.cu's encode arithmetic, emulated op by op ----------------
#
# The kernel divides by no element: it takes each block's r = RN(1/s),
# corrects y = RN(x r) with one FMA (div_rn), scales x by 2^64 first where
# x or y is below 2^-60, and floors (or rounds), clips and converts with one
# cvt.rmi (cvt.rni) and an integer clamp.  numpy's f32 arithmetic is IEEE
# (round to nearest even, subnormals kept) and _fma32 rounds a*b + c once,
# so these functions take the kernel's steps with the kernel's roundings;
# the kernel itself is held against the plain version on the card
# (tests/test_torch_cuda.py, chip_smoke.py).

F32 = np.float32
TINY, UP, DOWN = F32(2.0 ** -60), F32(2.0 ** 64), F32(2.0 ** -64)
S_MIN, S_MAX = F32(2.0 ** -100), F32(2.0 ** 122)


def _fma32(a, b, c):
    """RN_f32(a * b + c), rounded once (``__fmaf_rn``).  a * b is exact in
    f64; TwoSum splits p + c into hi + lo exactly; hi rounds to f32 as the
    exact sum does unless hi is the midpoint of two f32 neighbours, where
    lo's sign decides."""
    p = np.multiply(a, b, dtype=np.float64)
    c = np.broadcast_to(c, p.shape).astype(np.float64)
    hi = p + c
    bb = hi - p
    lo = (p - (hi - bb)) + (c - bb)
    out = hi.astype(F32)
    down = np.where(out.astype(np.float64) > hi,
                    np.nextafter(out, F32(-np.inf)), out)
    up = np.nextafter(down, F32(np.inf))
    tie = (hi == (down.astype(np.float64) + up) / 2) & (lo != 0)
    return np.where(tie, np.where(lo > 0, up, down), out)


def _div_rn_emulated(x, s):
    """The kernel's div_rn: x / s for a finite x and a block's bf16 scale s
    (broadcast) in [S_MIN, S_MAX]."""
    with np.errstate(all="ignore"):
        r = F32(1) / s                                # __frcp_rn
        y0 = x * r
        small = (np.abs(x) < TINY) | (np.abs(y0) < TINY)
        xs = np.where(small, x * UP, x)
        y = xs * r
        e = _fma32(-s, y, xs)
        y = _fma32(e, r, y)
        return np.where(small, y * DOWN, y)


def _cvt_s32(v):
    """cvt.s32.f32 of an integral f32: saturating, NaN to 0."""
    return np.where(np.isnan(v), 0.0, np.clip(v, -2.0 ** 31,
                                              2.0 ** 31 - 1)).astype(np.int64)


def _kernel_encode_emulated(x, rounding, seed, block=16):
    """Flat f32 [N] -> (int8 q, bf16 bits) as int8_encode_kernel makes them."""
    xb = x.reshape(-1, block, 128).transpose(0, 2, 1)
    with np.errstate(all="ignore"):
        m = np.abs(xb).max(-1)                         # max.NaN: NaN stays
        bits = golden._to_bf16(np.where(m > 0, m * int8_cuda.INV127,
                                        F32(1)))
        s = (bits.astype(np.uint32) << 16).view(F32)[..., None]
        # the block's divisor is ok: div_rn for all its elements, else
        # exact_lanes' __fdiv_rn
        ok = (s >= S_MIN) & (s <= S_MAX) & ~np.isnan(m)[..., None]
        v = np.where(ok, _div_rn_emulated(xb, s), xb / s)
        if rounding == "nearest":
            k = np.rint(v)
        else:
            u = golden.hash_u01(np.ascontiguousarray(xb).view(np.uint32),
                                seed)
            k = np.floor(v + u)
    q = np.clip(_cvt_s32(k), -127, 127).astype(np.int8)
    return q.transpose(0, 2, 1).reshape(-1), bits.reshape(-1)


def _extreme_tiles(n_tiles, seed):
    """Sublane tiles (block 16) whose blocks reach every branch of the
    kernel's encode: scales from 0 and bf16's subnormals to the largest a
    finite block gives, subnormal and tiny x, quotients that underflow,
    ties k + 1/2, clipped values, all-zero, NaN and +-inf blocks."""
    rng = np.random.default_rng(seed)
    shape = (n_tiles, 16, 128)
    E = rng.integers(-142, 121, (n_tiles, 1, 128))
    sig = 128 + rng.integers(0, 128, (n_tiles, 1, 128))
    M = (127.0 * sig * 2.0 ** (E - 7)).astype(F32)   # scale sig * 2^(E-7)
    expo = np.clip(E + 127 + rng.integers(-180, 7, shape), 0, 254)
    bits = ((rng.integers(0, 2, shape) << 31) | (expo << 23)
            | rng.integers(0, 2 ** 23, shape)).astype(np.uint32)
    x = bits.view(F32).copy()
    sign = np.where(rng.integers(0, 2, (n_tiles, 2, 128)) == 1, -1.0, 1.0)
    k = rng.integers(0, 127, (n_tiles, 1, 128))
    x[:, 0:1] = M * sign[:, 0:1]                      # fixes the scale
    x[:, 1:2] = ((2 * k + 1) * sig * 2.0 ** (E - 8)).astype(F32) * sign[
        :, 1:2]                                       # quotient k + 1/2
    x[:, 2:3] = -x[:, 0:1]                            # clips at -127 / 127
    x.reshape(-1)[::37] = -0.0
    x[0, :, 0] = 0.0                                  # all-zero block
    x[0, 3, 1] = np.nan
    x[0, 4, 2] = np.inf
    x[0, 5, 3] = -np.inf
    x[0, 6, 4], x[0, 7, 4] = np.nan, np.inf
    x[0, :, 5] = (rng.integers(1, 2 ** 23, 16).astype(np.uint32)
                  .view(F32))                         # all subnormal
    x[0, :, 6] = F32(2.0 ** -149) * rng.integers(0, 3, 16)   # scale 0
    return x.reshape(-1)


def test_kernel_division_equals_ieee_division():
    """div_rn == f32 division for each of the 128 bf16 scale significands
    against 8192 x significands (edges among them), at the exponents of
    a normal block; and for random pairs over its whole domain, bit for
    bit where the quotient is normal and, below 2^-126, in what reaches
    the output: whether it is zero, and its sign.  chip_smoke.py runs every
    x significand on the card."""
    rng = np.random.default_rng(3)
    m = np.concatenate([[0, 1, 2, 2 ** 22, 2 ** 23 - 2, 2 ** 23 - 1],
                        rng.integers(0, 2 ** 23, 8186)]).astype(np.uint32)
    x = (np.uint32(0x3F800000) | m).view(F32)         # [1, 2)
    s = ((np.arange(128, dtype=np.uint32) | 0x3F80) << 16).view(F32)
    for ex, es in ((0, 0), (6, 0), (-3, 5), (-1, 0)):
        xx = x[None, :] * F32(2.0 ** ex)
        ss = s[:, None] * F32(2.0 ** es)
        with np.errstate(all="ignore"):
            want = xx / ss
        np.testing.assert_array_equal(_div_rn_emulated(xx, ss), want)
    xb = rng.integers(0, 0x7F800000, 400_000, dtype=np.uint64).astype(
        np.uint32) | (rng.integers(0, 2, 400_000).astype(np.uint32) << 31)
    sb = rng.integers(0, 0x7F00, 400_000).astype(np.uint32) << 16
    sb[::16] = 0x3F800000
    xx, ss = xb.view(F32), sb.view(F32)
    with np.errstate(all="ignore"):
        want = xx / ss
        exact = xx.astype(np.float64) / ss.astype(np.float64)
        got = _div_rn_emulated(xx, ss)
    # div_rn's domain: scales in [S_MIN, S_MAX], quotients within a block's
    # max, below 128, or any x under scale 1.0
    keep = ((ss >= S_MIN) & (ss <= S_MAX)
            & ((np.abs(exact) < 128) | (ss == 1)))
    got, want, exact = got[keep], want[keep], exact[keep]
    normal = np.abs(exact) >= 2.0 ** -126
    assert normal.sum() > 50_000 and (~normal).sum() > 20_000
    np.testing.assert_array_equal(got[normal], want[normal])
    np.testing.assert_array_equal(got[~normal] == 0, want[~normal] == 0)
    np.testing.assert_array_equal(np.signbit(got[~normal & (want != 0)]),
                                  np.signbit(want[~normal & (want != 0)]))


@pytest.mark.parametrize("rounding,seed", [("stochastic", 0),
                                          ("stochastic", 7),
                                          ("nearest", 0)])
def test_kernel_encode_emulation_equals_plain(rounding, seed):
    """The kernel's encode, emulated step by step, == int8_encode_plain bit
    for bit on _extreme_tiles (and on _data), q and scales."""
    for x in (_extreme_tiles(24, seed + 1), _data(4 * TILE, seed)):
        q, bits = _kernel_encode_emulated(x, rounding, seed)
        pq, ps = int8_cuda.int8_encode_plain(torch.from_numpy(x), 16,
                                             rounding, seed)
        np.testing.assert_array_equal(q, pq.numpy())
        np.testing.assert_array_equal(bits, _bits(ps))


def test_floor_convert_clamp_equals_floor_clip_cast():
    """One cvt (saturating, NaN to 0) then an integer clamp == the plain
    version's floor (or round) -> clamp(-127, 127) -> int8 cast, on +-0,
    +-inf, NaN, values past +-2^31 and halves."""
    halves = np.arange(-130, 131) + 0.5
    v = np.concatenate([[0.0, -0.0, np.inf, -np.inf, np.nan, 2.0 ** 31,
                         -2.0 ** 31, 3e9, -3e9, 3e38, -3e38, 1e-45, -1e-45,
                         127.0, -127.0, 126.99999, -127.00001],
                        halves, -halves / 3]).astype(F32)
    t = torch.from_numpy(v)
    for np_round, t_round in ((np.floor, torch.floor),
                              (np.rint, torch.round)):
        with np.errstate(invalid="ignore"):
            got = np.clip(_cvt_s32(np_round(v)), -127, 127).astype(np.int8)
        want = torch.clamp(t_round(t), -127.0, 127.0).to(torch.int8)
        np.testing.assert_array_equal(got, want.numpy())
