"""The port's exact wire and page integrity and the trainer's two-tier
collective guard, against the JAX package.

Inputs come from numpy seeds; the JAX side runs on the CPU mesh of eight
devices that ``tests/conftest.py`` sets up, where a per-rank row of the
port is one JAX device's shard.  Held:

* the checksums (``ops.integrity``, ``compress.golden``) bit for bit against
  JAX's, per wire dtype, and the conservation and replica verdicts against
  JAX's under ``shard_map``;
* the chaos arithmetic (``integrity_tol``, ``chunk_checksums``,
  ``collective_integrity``, ``check_step_diag``, ``NormDriftGuard``) and the
  fault plan's corrupted words against JAX's;
* the rings with ``integrity=True``: a clean verdict, outputs bit-equal to
  integrity off and to JAX's ring, JAX's verdict on the same input, and one
  ``wirebit`` tripping both;
* the fused reduce-scatter's checksum pair (plain version) against the
  ``ring_golden`` twin;
* ``DPTrainer(integrity_check=True)``: integrity on bit-equal to off, the
  masters against JAX's ``DPTrainer`` with integrity off (JAX's
  integrity-on trainer fails the varying-axes check of its step on this
  CPU mesh), a gated wirebit step, a value-tier trip.
"""

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from fpga_ai_nic_tpu import compress as jax_compress
from fpga_ai_nic_tpu.compress import golden as jax_golden
from fpga_ai_nic_tpu.models import mlp as jax_mlp
from fpga_ai_nic_tpu.ops import integrity as jax_integrity
from fpga_ai_nic_tpu.ops import ring as jax_ring
from fpga_ai_nic_tpu.parallel import make_mesh
from fpga_ai_nic_tpu.parallel.train import DPTrainer as JaxDPTrainer
from fpga_ai_nic_tpu.runtime import chaos as jax_chaos
from fpga_ai_nic_tpu.utils import config as jax_config
from fpga_ai_nic_tpu_torch import compress, optim, train_mlp
from fpga_ai_nic_tpu_torch.compress import golden
from fpga_ai_nic_tpu_torch.models import mlp
from fpga_ai_nic_tpu_torch.ops import fused_update, integrity, ring
from fpga_ai_nic_tpu_torch.ops import ring_cuda, ring_golden
from fpga_ai_nic_tpu_torch.parallel.mesh import VirtualRanks
from fpga_ai_nic_tpu_torch.parallel.train import DPTrainer
from fpga_ai_nic_tpu_torch.runtime import chaos
from fpga_ai_nic_tpu_torch.utils import config

N = 8
TOPK = (("bucket_elems", 512), ("k", 64))
DIAG_KEYS = {"integrity_ok", "integrity_err", "nonfinite", "wire_ok",
             "grad_norm", "loss"}


def _mesh(n=N):
    return Mesh(np.array(jax.devices()[:n]), ("dp",))


def _shard(fn, out_specs, n=N, in_specs=P("dp")):
    return jax.jit(jax.shard_map(fn, mesh=_mesh(n), in_specs=in_specs,
                                 out_specs=out_specs, check_vma=False))


def _bits(dtype, size, seed):
    """(numpy array for JAX, torch tensor for the port) of random bits in
    ``dtype`` (a name); bf16 travels as its uint16 patterns."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 2 ** 32, size, dtype=np.uint64).astype(np.uint32)
    if dtype == "bfloat16":
        u16 = (raw & 0xFFFF).astype(np.uint16)
        return (jax.lax.bitcast_convert_type(jnp.asarray(u16), jnp.bfloat16),
                torch.from_numpy(u16.view(np.int16)).view(torch.bfloat16))
    width = np.dtype(dtype).itemsize
    a = raw.view(np.uint8)[:size * width].view(dtype).copy()
    return jnp.asarray(a), torch.from_numpy(a)


@pytest.fixture
def wire_taps():
    """Both packages' wire taps, installed for one test and always
    removed: a leaked tap would run in every later collective."""
    jax_chaos.install_wire_tap()
    chaos.install_wire_tap()
    try:
        yield
    finally:
        jax_chaos.uninstall_wire_tap()
        chaos.uninstall_wire_tap()


# ---------------------------------------------------------------------------
# checksums: bit for bit against JAX and the goldens
# ---------------------------------------------------------------------------

DTYPES = ["uint8", "int8", "bfloat16", "float16", "float32", "int32"]


@pytest.mark.parametrize("dtype", DTYPES)
def test_word_and_payload_checksums_match_jax(dtype):
    ja, ta = _bits(dtype, 777, seed=len(dtype))
    jb, tb = _bits(dtype, 130, seed=7)
    want = np.uint32(np.asarray(jax.jit(jax_integrity.word_checksum)(ja)))
    assert int(integrity.word_checksum(ta)) == int(want)
    host = np.asarray(ta.view(torch.int16) if dtype == "bfloat16" else ta)
    assert int(golden.golden_word_checksum(host)) == int(want)
    assert int(jax_golden.golden_word_checksum(np.asarray(ja))) == int(want)
    pay = jax.jit(jax_integrity.payload_checksum)((ja, jb))
    got = integrity.payload_checksum((ta, tb))
    assert int(got) == int(np.uint32(np.asarray(pay)))
    host_b = np.asarray(tb.view(torch.int16) if dtype == "bfloat16" else tb)
    assert int(golden.golden_payload_checksum((host, host_b))) == int(got)
    rows = integrity.row_checksums((ta[:776].reshape(8, -1),
                                    tb[:128].reshape(8, -1)))
    for r in range(8):
        one = jax_integrity.payload_checksum((ja[r * 97:(r + 1) * 97],
                                              jb[r * 16:(r + 1) * 16]))
        assert int(rows[r]) == int(np.uint32(np.asarray(one)))
    assert int(integrity.payload_checksum((tb, ta))) != int(got)


@pytest.mark.parametrize("s", [0, 1, 2, 7, 12345, 2 ** 30 + 3, 2 ** 31 - 1])
def test_hop_weight_matches_jax(s):
    want = int(np.uint32(np.asarray(jax_integrity.hop_weight(s))))
    assert integrity.hop_weight(s) == want
    assert int(integrity.hop_weight(torch.tensor(s))) == want


def test_page_checksums_match_jax_and_golden():
    rng = np.random.default_rng(3)
    host = [{k: rng.standard_normal((6, 2, 4, 8)).astype(np.float32)
             for k in ("k", "v")} for _ in range(3)]
    jpool = [{k: jnp.asarray(v) for k, v in lyr.items()} for lyr in host]
    tpool = [{k: torch.from_numpy(v) for k, v in lyr.items()}
             for lyr in host]
    want = np.asarray(jax.jit(jax_integrity.page_checksums)(jpool))
    np.testing.assert_array_equal(integrity.page_checksums(tpool).numpy(),
                                  want)
    np.testing.assert_array_equal(
        integrity.page_checksums_plain(tpool).numpy(), want)
    np.testing.assert_array_equal(golden.golden_page_checksums(host), want)
    pages = [4, 1, 5]
    blocks = [lyr[k][pages] for lyr in tpool for k in ("k", "v")]
    np.testing.assert_array_equal(
        integrity.gathered_page_checksums(blocks).numpy(), want[pages])
    zero = [{k: torch.zeros(5, 2, 4, 8, dtype=torch.bfloat16)
             for k in ("k", "v")}]
    assert not integrity.page_checksums(zero).any()


@pytest.mark.parametrize("dtype", [torch.float64, torch.int64])
def test_eight_byte_payloads_rejected(dtype):
    with pytest.raises(TypeError, match="itemsize 8"):
        integrity.word_checksum(torch.zeros(4, dtype=dtype))
    with pytest.raises(TypeError, match="itemsize 8"):
        golden.golden_words_u32(np.zeros(4, np.float64))


def test_single_bit_flip_always_changes_the_checksum():
    rng = np.random.default_rng(5)
    arr = rng.standard_normal(257).astype(np.float32)
    base = int(integrity.word_checksum(torch.from_numpy(arr)))
    for i in rng.choice(257, 40, replace=False):
        for bit in (0, 1, 11, 23, 31):
            mut = arr.copy()
            mut.view(np.uint32)[i] ^= np.uint32(1 << bit)
            assert int(integrity.word_checksum(torch.from_numpy(mut))) != base


@pytest.mark.parametrize("disagree", [False, True])
def test_conservation_and_replica_verdicts_match_jax(disagree):
    """The port's verdicts over the rows of [n] / [n, L] against JAX's
    psum / pmax-pmin over eight devices holding the same values."""
    rng = np.random.default_rng(11)
    send = rng.integers(0, 2 ** 32, N, dtype=np.uint64).astype(np.uint32)
    recv = np.roll(send, 3)
    if disagree:
        recv[5] ^= np.uint32(1 << 7)
    want = _shard(lambda s, r: jax_integrity.conservation_ok(s, r, "dp"),
                  P(), in_specs=(P("dp"), P("dp")))(jnp.asarray(send),
                                                    jnp.asarray(recv))
    got = integrity.conservation_ok(torch.from_numpy(send.astype(np.int64)),
                                    torch.from_numpy(recv.astype(np.int64)))
    assert bool(got) == bool(np.asarray(want).all()) == (not disagree)

    x = np.tile(rng.standard_normal(300).astype(np.float32), (N, 1))
    if disagree:
        x[6, 17] = np.nextafter(x[6, 17], np.float32(9))
    want = _shard(lambda v: jax_integrity.replica_consistent(v, "dp"),
                  P())(jnp.asarray(x.reshape(-1)))
    got = integrity.replica_consistent(torch.from_numpy(x))
    assert bool(got) == bool(np.asarray(want).all()) == (not disagree)


# ---------------------------------------------------------------------------
# chaos: tolerance, value tier, verdict order, drift guard, fault plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("codec,opts", [(None, ()), ("bfp", ()),
                                        ("int8", ()), ("topk", TOPK)])
def test_integrity_tol_matches_jax(n, codec, opts):
    def coll(mod):
        return mod.CollectiveConfig(impl="ring", codec=codec,
                                    codec_opts=opts)
    assert chaos.integrity_tol(coll(config), n) == \
        jax_chaos.integrity_tol(coll(jax_config), n)


def test_chunk_checksums_and_collective_integrity_match_jax():
    """Eight ranks' [L] contributions and [C] reduced chunks that miss
    their input sums by about a quarter of the chunk's L1 (so the relative
    error is not a difference of near-equal numbers), once clean of
    non-finites and once with two NaNs."""
    rng = np.random.default_rng(13)
    C = 512
    flat = rng.standard_normal((N, N * C)).astype(np.float32)
    l1 = np.abs(flat).reshape(N, N, C).sum(axis=(0, 2))
    g_red = np.repeat((0.25 * l1 / C)[:, None], C, axis=1).astype(np.float32)
    tol = 0.3

    def jfn(f, g):
        expect, l1_ = jax_chaos.chunk_checksums(f, "dp", N)
        return expect, l1_, jax_chaos.collective_integrity(
            expect, l1_, g, "dp", N, tol)

    run = _shard(jfn, P(), in_specs=(P("dp"), P("dp")))
    for nan in (False, True):
        if nan:
            g_red[2, 7] = g_red[5, 0] = np.nan
        j_expect, j_l1, jd = run(jnp.asarray(flat.reshape(-1)),
                                 jnp.asarray(g_red.reshape(-1)))
        expect, l1_t = chaos.chunk_checksums(torch.from_numpy(flat), N)
        d = chaos.collective_integrity(expect, l1_t, torch.from_numpy(g_red),
                                       N, tol)
        np.testing.assert_allclose(expect.numpy(), np.asarray(j_expect),
                                   rtol=1e-6, atol=1e-6 * float(l1.max()))
        np.testing.assert_allclose(l1_t.numpy(), np.asarray(j_l1), rtol=1e-6)
        assert int(d["nonfinite"]) == int(np.asarray(jd["nonfinite"]))
        assert bool(d["integrity_ok"]) == bool(np.asarray(jd["integrity_ok"]))
        if not nan:
            np.testing.assert_allclose(float(d["integrity_err"]),
                                       float(np.asarray(jd["integrity_err"])),
                                       rtol=1e-6)
            assert bool(d["integrity_ok"])
        else:
            assert int(d["nonfinite"]) == 2 and not bool(d["integrity_ok"])


DIAGS = [
    {"wire_ok": False, "integrity_ok": False, "nonfinite": 3,
     "integrity_err": 0.5},
    {"wire_ok": False, "integrity_ok": True, "nonfinite": 0,
     "integrity_err": 0.0},
    {"wire_ok": True, "integrity_ok": False, "nonfinite": 0,
     "integrity_err": 0.7},
    {"wire_ok": True, "integrity_ok": True, "nonfinite": 2,
     "integrity_err": 0.0},
    {"wire_ok": True, "integrity_ok": True, "nonfinite": 0,
     "integrity_err": 1e-4},
    {},
]


@pytest.mark.parametrize("diag", DIAGS)
def test_check_step_diag_raises_in_jax_order(diag):
    def outcome(mod, d):
        try:
            mod.check_step_diag(d, 4)
        except mod.IntegrityError as e:
            return type(e).__name__
        return None
    tdiag = {k: torch.tensor(v) for k, v in diag.items()}
    jdiag = {k: np.asarray(v) for k, v in diag.items()}
    assert outcome(chaos, tdiag) == outcome(jax_chaos, jdiag)


def test_norm_drift_guard_trips_like_jax():
    series = [1.0, 1.2, 0.9, 1.1, 2e3, 1.0, 0.95, float("nan"), 1.05,
              float("inf"), 1.1, 1.5e3, 1.0]
    for factor, warmup in ((1e3, 3), (10.0, 2)):
        trips = []
        for mod in (chaos, jax_chaos):
            g = mod.NormDriftGuard(factor=factor, warmup=warmup)
            out = []
            for v in series:
                try:
                    g.check(v)
                    out.append(None)
                except mod.IntegrityError as e:
                    out.append(str(e))
            trips.append((out, list(g.history)))
        assert trips[0] == trips[1]
        assert any(t is not None for t in trips[0][0])


@pytest.mark.parametrize("mode,dtype", [
    ("nan", "float32"), ("scale", "float32"), ("bitflip", "float32"),
    ("wirebit", "float32"), ("wirebit", "int8"), ("wirebit", "int16"),
    ("wirebit", "bfloat16")])
@pytest.mark.parametrize("seed,step,fraction", [(3, 0, 0.01),
                                                (11, 5, 0.2)])
def test_fault_plan_corrupts_the_same_words_as_jax(mode, dtype, seed, step,
                                                   fraction):
    ja, ta = _bits(dtype, 1000, seed=seed + step)
    if dtype == "float32":
        ja = np.asarray(np.random.default_rng(seed).standard_normal(1000),
                        np.float32)
        ta = torch.from_numpy(ja.copy())
    host = np.asarray(ja)
    port_host = chaos._to_numpy(ta)

    def fire(mod, a):
        plan = mod.FaultPlan([mod.FaultSpec("corruption", "collective",
                                            step=step, mode=mode,
                                            fraction=fraction)], seed=seed)
        plan.begin_step(step)
        if mode == "wirebit":
            out = plan.wire_payload(a, "ring.wire")
        else:
            out = plan.collective_payload(a)
        assert len(plan.fired) == 1
        return out

    want = fire(jax_chaos, host.copy())
    got = fire(chaos, port_host.copy())
    assert got.tobytes() == want.tobytes()
    assert got.tobytes() != port_host.tobytes()


def test_unported_fault_kinds_and_sites_raise():
    """Only the live reshard tier's wire stays unported (the next slice of
    ROADMAP A.8); the kinds and sites refused before now construct as in
    JAX (tests/test_torch_chaos_sites.py fires them)."""
    with pytest.raises(NotImplementedError, match="A.8"):
        chaos.FaultSpec("corruption", "reshard.transfer", step=0,
                        mode="wirebit")
    chaos.FaultSpec("hang", "collective", step=0)
    chaos.FaultSpec("corruption", "serve.step", step=0, mode="wirebit")
    with pytest.raises(ValueError):
        chaos.FaultSpec("corruption", "nowhere", step=0)


# ---------------------------------------------------------------------------
# rings: no false trips, bit-identity, JAX's verdicts, wirebit trips
# ---------------------------------------------------------------------------

RING_CELLS = [
    # (codec, opts, which, sliced): JAX's flat RING_CELLS and the rest of
    # each codec's three collectives
    (None, (), "reduce_scatter", False),
    (None, (), "all_gather", False),
    (None, (), "all_reduce", False),
    ("bfp", (), "reduce_scatter", True),
    ("bfp", (), "all_reduce", False),
    ("bfp", (), "all_gather", False),
    ("topk", TOPK, "reduce_scatter", False),
    ("topk", TOPK, "all_reduce", False),
    ("int8", (), "all_gather", False),
    ("int8", (), "reduce_scatter", True),
    ("int8", (), "all_reduce", True),
]


def _codecs(name, opts):
    if name is None:
        return None, None
    return (jax_compress.get_codec(name, dict(opts)),
            compress.get_codec(name, dict(opts)))


def _ring_input(jcodec, sliced, seed):
    """A global vector whose per-device part chunks into N codec-padded
    hop payloads (JAX's sizing), and the hop slice."""
    unit = N * N * (jcodec.pad_elems if jcodec else 1)
    L = unit * max(1, 32768 // unit)
    chunk = L // N // N
    x = np.random.default_rng(seed).standard_normal(L).astype(np.float32)
    return x, (chunk // 2 if sliced else None)


def _port_ring(which, x, codec, slice_elems, integ):
    if which == "reduce_scatter":
        return ring.ring_reduce_scatter(x, codec, slice_elems, integ)
    if which == "all_gather":
        return ring.ring_all_gather(x, codec, integ)
    return ring.ring_all_reduce(x, codec, slice_elems, integ)


def _jax_ring(which, codec, slice_elems, integ):
    def run(v):
        kw = dict(compression=codec, integrity=integ)
        if which == "reduce_scatter":
            return jax_ring.ring_reduce_scatter(v, "dp",
                                                slice_elems=slice_elems, **kw)
        if which == "all_gather":
            return jax_ring.ring_all_gather(v, "dp", **kw)
        return jax_ring.ring_all_reduce(v, "dp", slice_elems=slice_elems,
                                        **kw)
    return _shard(run, (P("dp"), P()) if integ else P("dp"))


@pytest.mark.parametrize("name,opts,which,sliced", RING_CELLS)
def test_ring_integrity_clean_matches_jax(name, opts, which, sliced):
    """A clean run: the verdict is true, the output bit-equal to integrity
    off and to JAX's ring, and JAX's own integrity ring agrees."""
    jcodec, codec = _codecs(name, opts)
    x, slice_elems = _ring_input(jcodec, sliced, seed=len(RING_CELLS))
    rows = torch.from_numpy(x.reshape(N, -1))
    on, ok = _port_ring(which, rows, codec, slice_elems, True)
    off = _port_ring(which, rows, codec, slice_elems, False)
    assert bool(ok), "a clean run tripped the exact tier"
    assert torch.equal(on, off)
    j_on, j_ok = _jax_ring(which, jcodec, slice_elems, True)(jnp.asarray(x))
    assert bool(np.asarray(j_ok))
    np.testing.assert_array_equal(on.numpy().reshape(-1), np.asarray(j_on))


@pytest.mark.parametrize("name,opts", [(None, ()), ("bfp", ()),
                                       ("int8", ()), ("topk", TOPK)])
def test_wirebit_trips_the_ring_like_jax(wire_taps, name, opts):
    """One low bit flipped in one encoded frame (finite, in-band) fails
    the conservation verdict of the port's all-reduce and of JAX's on the
    same input; the outputs stay finite."""
    jcodec, codec = _codecs(name, opts)
    x, _ = _ring_input(jcodec, False, seed=21)
    verdicts = []
    for mod, run in ((chaos, lambda: ring.ring_all_reduce(
            torch.from_numpy(x.reshape(N, -1)), codec, integrity=True)),
                     (jax_chaos, lambda: _jax_ring(
                         "all_reduce", jcodec, None, True)(jnp.asarray(x)))):
        plan = mod.FaultPlan([mod.FaultSpec("corruption", "collective",
                                            step=0, mode="wirebit",
                                            fraction=0.01)], seed=3)
        with mod.activate(plan):
            plan.begin_step(0)
            out, ok = run()
            out, ok = np.asarray(out), bool(np.asarray(ok))
        assert len(plan.fired) == 1
        assert np.isfinite(out).all()
        verdicts.append(ok)
    assert verdicts == [False, False]


def test_taps_alone_do_not_trip(wire_taps):
    chaos.install_collective_tap()
    try:
        x = torch.from_numpy(np.random.default_rng(2).standard_normal(
            (N, N * 512)).astype(np.float32))
        with chaos.activate(chaos.FaultPlan([])):
            out, ok = ring.ring_all_reduce(x, compress.get_codec("int8"),
                                           integrity=True)
        assert bool(ok)
        assert torch.equal(out, ring.ring_all_reduce(
            x, compress.get_codec("int8")))
    finally:
        chaos.uninstall_collective_tap()


# ---------------------------------------------------------------------------
# the fused reduce-scatter's checksum pair
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("kind", ["sgd", "momentum", "adamw"])
def test_rs_update_pair_matches_golden_twin(n, kind):
    """``ring_reduce_scatter_update_plain(integrity=True)``: the pair equals
    ``ring_golden.ring_reduce_scatter_pair``, conserves, and g, w and the
    moments are bit-equal to integrity off."""
    cfg = config.BFPConfig(codec="pallas")
    tile = cfg.block_size * 128
    C, se = 3 * tile, tile
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.standard_normal((n, n * C)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((n, C)).astype(np.float32))
    st = {k: torch.from_numpy(rng.random((n, C)).astype(np.float32) * 1e-3)
          for k in config.OptimizerSpec(kind=kind).state_keys}
    hyper = optim.fused_hyperparams(
        config.OptimizerConfig(kind=kind, learning_rate=1e-2), 1)
    on = ring_cuda.ring_reduce_scatter_update_plain(
        x, w, st, hyper, opt_kind=kind, compression=cfg, slice_elems=se,
        integrity=True)
    off = ring_cuda.ring_reduce_scatter_update_plain(
        x, w, st, hyper, opt_kind=kind, compression=cfg)
    owned, pair = ring_golden.ring_reduce_scatter_pair(x.numpy(), cfg, se)
    np.testing.assert_array_equal(on[3].numpy(), pair.astype(np.int64))
    np.testing.assert_array_equal(on[0].numpy(), owned)
    assert torch.equal(on[0], off[0]) and torch.equal(on[1], off[1])
    for k in st:
        assert torch.equal(on[2][k], off[2][k])
    assert bool(integrity.conservation_ok(on[3][:, 0], on[3][:, 1]))
    # a frame of another size is another pair; the same bits
    other = ring_cuda.ring_reduce_scatter_update_plain(
        x, w, st, hyper, opt_kind=kind, compression=cfg,
        slice_elems=3 * tile, integrity=True)
    assert not torch.equal(other[3], on[3]) and torch.equal(other[1], on[1])


# ---------------------------------------------------------------------------
# DPTrainer(integrity_check=True)
# ---------------------------------------------------------------------------

SIZES = (64, 128, 128, 16)
BATCH, LR = 32, 0.1
INT8_STEP = (1.0 + 2.0 ** -8) / 127.0     # int8 grid step / block max


def _cfg(mod, n, codec, opts=(), fused=True, integ=False, kind="sgd",
         lr=LR, **coll):
    return mod.TrainConfig(
        global_batch=BATCH, mesh=mod.MeshConfig(dp=n),
        collective=mod.CollectiveConfig(impl="ring", codec=codec,
                                        codec_opts=opts,
                                        fused_optimizer=fused,
                                        integrity_check=integ, **coll),
        optimizer=mod.OptimizerConfig(kind=kind, learning_rate=lr))


def _data(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((BATCH, SIZES[0])).astype(np.float32)
    y = rng.integers(0, SIZES[-1], BATCH).astype(np.int32)
    return x, y


def _jax_params():
    p = jax_mlp.init(jax.random.PRNGKey(0),
                     jax_config.MLPConfig(layer_sizes=SIZES))
    return jax.tree_util.tree_map(np.asarray, p)


def _port(cfg, n):
    mcfg = config.MLPConfig(layer_sizes=SIZES)
    tr = DPTrainer(lambda p, b: mlp.loss_fn(p, b, mcfg),
                   VirtualRanks(n, torch.device("cpu")), cfg)
    state = tr.init_state(mlp.from_jax_params(_jax_params(), device="cpu"))
    x, y = _data()
    return tr, state, tr.shard_batch((torch.from_numpy(x),
                                      torch.from_numpy(y)))


def _same_state(a, b):
    assert torch.equal(a.w_own, b.w_own)
    assert a.opt_state.keys() == b.opt_state.keys()
    for k in a.opt_state:
        assert torch.equal(a.opt_state[k], b.opt_state[k]), k
    assert (a.codec_state is None) == (b.codec_state is None)
    if a.codec_state is not None:
        assert torch.equal(a.codec_state, b.codec_state)


TRAIN_ROUTES = [  # (codec, opts, fused_optimizer, extra collective fields)
    ("bfp", (), True, {}),
    ("bfp", (), False, {}),
    ("int8", (("error_feedback", True),), True, {}),
    ("int8", (), False, {}),
    (None, (), True, {"compression": config.BFPConfig(codec="pallas"),
                      "fused_kernel": True}),
]


@pytest.mark.parametrize("codec,opts,fused,extra", TRAIN_ROUTES)
def test_dp_trainer_integrity_on_equals_off(codec, opts, fused, extra):
    """Two AdamW steps: masters, moments, replicas and the error-feedback
    residual bit-equal with integrity on and off; the diag has JAX's keys
    and clean verdicts."""
    n = 4
    a, sa, batch = _port(_cfg(config, n, codec, opts, fused, True, "adamw",
                              3e-3, **extra), n)
    b, sb, _ = _port(_cfg(config, n, codec, opts, fused, False, "adamw",
                          3e-3, **extra), n)
    for step in range(2):
        sa, diag = a.step(sa, batch)
        sb, loss = b.step(sb, batch)
        assert set(diag) == DIAG_KEYS
        assert bool(diag["wire_ok"]) and bool(diag["integrity_ok"])
        assert int(diag["nonfinite"]) == 0
        assert float(diag["loss"]) == float(loss)
        assert float(diag["grad_norm"]) > 0
        chaos.check_step_diag(diag, step)
    _same_state(sa, sb)
    assert torch.equal(sa.replicas, sb.replicas)


@pytest.mark.parametrize("codec,opts", [("bfp", ()), ("int8", ())])
def test_dp_trainer_integrity_tracks_jax_trainer(codec, opts):
    """Three SGD steps of the integrity trainer against JAX's DPTrainer
    with integrity off, from the same weights and batch.  Torch and XLA sum
    the GEMMs in other orders, so a value on a rounding boundary may move
    one grid step of its block: the masters are held within one grid step
    of the largest gradient (BFP, 2^-6 of a block max, times lr, as
    tests/test_torch_train.py) or of the largest master (int8, as
    tests/test_torch_codec_train.py) per step."""
    n = 4
    jt = JaxDPTrainer(
        lambda p, b: jax_mlp.loss_fn(p, b, jax_config.MLPConfig(
            layer_sizes=SIZES)),
        make_mesh(jax_config.MeshConfig(dp=n)),
        _cfg(jax_config, n, codec, opts))
    js = jt.init_state(jax.tree_util.tree_map(jnp.asarray, _jax_params()))
    x, y = _data()
    jb = jt.shard_batch((jnp.asarray(x), jnp.asarray(y)))
    tr, st, batch = _port(_cfg(config, n, codec, opts, integ=True), n)
    atol = 0.0
    for step in range(3):
        js, jloss = jt.step(js, jb)
        g, loss = tr.grads(st, batch)
        g, resid = tr.error_feedback(st, g)
        st, diag = tr.apply_grads(st, g, resid)
        chaos.check_step_diag(diag, step)
        if codec == "int8":
            atol += INT8_STEP * float(st.w_own.abs().max())
            rtol = 1e-2
        else:
            atol += LR * 2.0 ** -6 * float(g.abs().max())
            rtol = 1e-5
        np.testing.assert_allclose(float(loss), float(jloss), rtol=rtol)
        np.testing.assert_allclose(st.w_own.numpy(),
                                   np.asarray(js.w_own).reshape(n, -1),
                                   rtol=0, atol=atol)


@pytest.mark.parametrize("fused", [True, False])
def test_wirebit_step_is_gated_and_raises(wire_taps, fused):
    """A wirebit on the ring: the exact tier trips, check_step_diag raises
    WireIntegrityError, the outputs are finite, and the masters, the AdamW
    moments and the error-feedback residual keep their pre-step values."""
    n = 4
    tr, st, batch = _port(_cfg(config, n, "int8", (("error_feedback", True),),
                               fused, True, "adamw", 3e-3), n)
    st, diag = tr.step(st, batch)
    chaos.check_step_diag(diag, 0)
    assert st.codec_state is not None and bool(st.codec_state.any())
    plan = chaos.FaultPlan([chaos.FaultSpec(
        "corruption", "collective", step=1, mode="wirebit", fraction=0.01)],
        seed=3)
    with chaos.activate(plan):
        plan.begin_step(1)
        new, diag = tr.step(st, batch)
    assert len(plan.fired) == 1
    assert not bool(diag["wire_ok"])
    with pytest.raises(chaos.WireIntegrityError):
        chaos.check_step_diag(diag, 1)
    assert bool(torch.isfinite(new.replicas).all())
    _same_state(new, st)
    assert new.step == st.step + 1


def test_value_corruption_trips_the_value_tier():
    """A "scale" corruption of one rank's input at the collective tap:
    IntegrityError (not the wire tier: the frames were sent as encoded),
    update gated; a clean control step passes."""
    n = 4
    tr, st, batch = _port(_cfg(config, n, "bfp", (), True, True), n)
    chaos.install_collective_tap()
    try:
        plan = chaos.FaultPlan([chaos.FaultSpec(
            "corruption", "collective", step=0, mode="scale")], seed=1)
        with chaos.activate(plan):
            plan.begin_step(0)
            new, diag = tr.step(st, batch)
            assert len(plan.fired) == 1
            with pytest.raises(chaos.IntegrityError) as err:
                chaos.check_step_diag(diag, 0)
            assert not isinstance(err.value, chaos.WireIntegrityError)
            _same_state(new, st)
            plan.begin_step(1)
            new, diag = tr.step(st, batch)
            chaos.check_step_diag(diag, 1)
            assert not torch.equal(new.w_own, st.w_own)
    finally:
        chaos.uninstall_collective_tap()


def test_update_route_gatable():
    """False only on the CUDA kernel route, as JAX's is False only on its
    in-kernel TPU route."""
    kern = config.CollectiveConfig(
        impl="ring", compression=config.BFPConfig(codec="pallas"),
        fused_kernel=True, fused_optimizer=True, integrity_check=True)
    unfused = config.CollectiveConfig(impl="ring", codec="bfp",
                                      fused_optimizer=True)
    gate = fused_update.update_route_gatable
    assert not gate(kern, 8, "cuda") and not gate(kern, 8, torch.device(
        "cuda", 0))
    assert not gate(kern)                    # unknown: assume the kernel
    assert gate(kern, 8, "cpu") and gate(kern, 1, "cuda")
    assert gate(unfused, 8, "cuda") and gate(unfused, 8, "cpu")


def test_xla_collective_verdict_is_constant_true():
    coll = config.CollectiveConfig(impl="xla")
    x = torch.ones((4, 64))
    out, ok = fused_update.reduce_scatter(x, coll, integrity=True)
    assert bool(ok) and torch.equal(out, fused_update.reduce_scatter(x, coll))
    out, ok = fused_update.all_gather_flat(x, coll, integrity=True)
    assert bool(ok)


def test_train_mlp_integrity_flag_on_cpu():
    out = train_mlp.main([
        "--model.layer_sizes=256,256,256", "--global_batch=64", "--iters=2",
        "--device=cpu", "--bfp=1", "--mesh.dp=4",
        "--collective.compression.codec=pallas",
        "--collective.fused_kernel=true", "--collective.fused_optimizer=true",
        "--collective.integrity_check=true"])
    assert out["wire_ok"] is True and out["integrity_ok"] is True
    assert np.isfinite(out["loss"])
