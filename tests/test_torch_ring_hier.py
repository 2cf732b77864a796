"""The port's hierarchical (intra x inter) rings (``ops.ring_hier``) against
the JAX package's ``ops/ring_hier.py``, the numpy golden twins and the flat
ring.

* The reduce-scatter, all-gather and all-reduce over the stacked ranks,
  bit-equal to the port's golden twins, to JAX's goldens and to JAX's
  ``ring_hier`` under ``shard_map`` (8 CPU devices), for every codec of
  JAX's tests and every intra size of 8.
* Bit-identity to the flat ring where every add is exact, and the
  degenerate factorizations (ni = 1, ni = n) equal to the flat rings.
* The plan's bytes and ``describe()`` equal to JAX's; the phase program
  (``verify.opstream``) equal to JAX's.
* ``integrity=True``: clean runs true and bit-equal to integrity off and
  to JAX's, whose verdicts are true too; a ``wirebit`` on a hop trips it.
* ``topology="hier"`` through ``DPTrainer`` (against the flat trainer and
  JAX's hier trainer; the fused BFP update against the golden composition),
  ``DDPTrainer`` and ``train_mlp``'s flags; the three config errors.
"""

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from fpga_ai_nic_tpu import compress as jax_compress
from fpga_ai_nic_tpu import optim as jax_optim
from fpga_ai_nic_tpu.compress import golden as jax_golden
from fpga_ai_nic_tpu.models import mlp as jax_mlp
from fpga_ai_nic_tpu.ops import ring_hier as jax_hier
from fpga_ai_nic_tpu.parallel import make_mesh
from fpga_ai_nic_tpu.parallel.train import DPTrainer as JaxDPTrainer
from fpga_ai_nic_tpu.utils import config as jcfg
from fpga_ai_nic_tpu.verify import opstream as jax_opstream
from fpga_ai_nic_tpu_torch import compress, train_mlp
from fpga_ai_nic_tpu_torch.compress import golden
from fpga_ai_nic_tpu_torch.models import mlp
from fpga_ai_nic_tpu_torch.ops import fused_update, ring, ring_hier
from fpga_ai_nic_tpu_torch.parallel.ddp import DDPTrainer
from fpga_ai_nic_tpu_torch.parallel.mesh import VirtualRanks
from fpga_ai_nic_tpu_torch.parallel.train import DPTrainer
from fpga_ai_nic_tpu_torch.runtime import chaos
from fpga_ai_nic_tpu_torch.utils import config
from fpga_ai_nic_tpu_torch.verify import opstream

N = 8
CODECS = (None, "bfp", "topk", "int8")        # tests/test_ring_hier.py:31
FACTORS = (1, 2, 4, 8)
CPU = torch.device("cpu")


def _codecs(name):
    """(JAX codec, port codec) of a registered name, or (None, None)."""
    if name is None:
        return None, None
    return jax_compress.get_codec(name), compress.get_codec(name)


def _run(fn, per_dev, out_specs=P("dp")):
    """shard_map a per-device JAX collective over 8 CPU devices; per_dev
    [n, k] (device-major)."""
    mesh = Mesh(np.array(jax.devices()[:N]), ("dp",))
    out = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=P("dp"),
                                out_specs=out_specs, check_vma=False))(
        jnp.asarray(per_dev.reshape(-1)))
    if isinstance(out, tuple):
        return np.asarray(out[0]).reshape(N, -1), bool(np.asarray(out[1]))
    return np.asarray(out).reshape(N, -1)


def _payload(codec, seed=0, l_unit=64):
    unit = N * (codec.pad_elems if codec else 1) * 2
    rng = np.random.default_rng(seed)
    return rng.standard_normal((N, l_unit * unit)).astype(np.float32)


@pytest.mark.parametrize("name", CODECS)
@pytest.mark.parametrize("ni", FACTORS)
def test_reduce_scatter_matches_golden_and_jax(name, ni):
    jc, pc = _codecs(name)
    x = _payload(jc)
    out = ring_hier.hier_reduce_scatter(torch.from_numpy(x), ni,
                                        compression=pc).numpy()
    want = jax_golden.hier_reduce_scatter(
        x, ni, jax_golden.roundtrip_fn(jc) if jc else None)
    np.testing.assert_array_equal(out, want)
    np.testing.assert_array_equal(out, golden.hier_reduce_scatter(
        x, ni, golden.roundtrip_fn(pc) if pc else None))
    np.testing.assert_array_equal(out, _run(
        lambda v: jax_hier.hier_reduce_scatter(v, "dp", ni, compression=jc),
        x))


@pytest.mark.parametrize("name", CODECS)
@pytest.mark.parametrize("ni", FACTORS)
def test_all_gather_matches_golden_and_jax(name, ni):
    """Every replica reassembles the same vector, bit-equal to the goldens
    and to JAX's gather."""
    jc, pc = _codecs(name)
    rt = jax_golden.roundtrip_fn(jc) if jc else None
    owned = jax_golden.hier_reduce_scatter(_payload(jc, 1), ni, rt)
    out = ring_hier.hier_all_gather(torch.from_numpy(owned), ni,
                                    compression=pc).numpy()
    np.testing.assert_array_equal(out, jax_golden.hier_all_gather(owned, ni,
                                                                  rt))
    np.testing.assert_array_equal(out, golden.hier_all_gather(
        owned, ni, golden.roundtrip_fn(pc) if pc else None))
    np.testing.assert_array_equal(out, _run(
        lambda v: jax_hier.hier_all_gather(v, "dp", ni, compression=jc),
        owned))
    assert np.array_equal(out, np.broadcast_to(out[0], out.shape))


@pytest.mark.parametrize("name", CODECS)
@pytest.mark.parametrize("ni", FACTORS)
def test_all_reduce_matches_golden_and_jax(name, ni):
    jc, pc = _codecs(name)
    x = _payload(jc, 2)
    out = ring_hier.hier_all_reduce(torch.from_numpy(x), ni,
                                    compression=pc).numpy()
    np.testing.assert_array_equal(out, jax_golden.hier_all_reduce(
        x, ni, jax_golden.roundtrip_fn(jc) if jc else None))
    np.testing.assert_array_equal(out, _run(
        lambda v: jax_hier.hier_all_reduce(v, "dp", ni, compression=jc), x))


@pytest.mark.parametrize("ni", (2, 4))
def test_sliced_inter_hop_is_bit_identical(ni):
    """slice_elems on the slow hop changes the schedule, never the bits."""
    _, pc = _codecs("bfp")
    x = torch.from_numpy(_payload(pc, 3))
    C = x.shape[1] // N
    whole = ring_hier.hier_reduce_scatter(x, ni, compression=pc)
    sliced = ring_hier.hier_reduce_scatter(x, ni, compression=pc,
                                           slice_elems=C // 2)
    assert torch.equal(whole, sliced)


@pytest.mark.parametrize("ni", (2, 4))
def test_bit_identical_to_flat_ring_on_exact_payloads(ni):
    """codec=None: the same sum in another association; integer-valued
    payloads make every f32 add exact, so hier equals flat bit for bit."""
    x = torch.from_numpy(np.random.default_rng(4).integers(
        -64, 64, (N, N * 256)).astype(np.float32))
    flat = ring.ring_reduce_scatter(x)
    assert torch.equal(flat, ring_hier.hier_reduce_scatter(x, ni))
    assert torch.equal(ring.ring_all_gather(flat),
                       ring_hier.hier_all_gather(flat, ni))


def test_degenerate_factorizations_reduce_to_flat():
    """ni = 1 runs the codec ring across every rank, ni = n the raw ring:
    both are the flat schedules."""
    _, pc = _codecs("bfp")
    x = torch.from_numpy(_payload(pc, 5))
    assert torch.equal(ring_hier.hier_reduce_scatter(x, 1, compression=pc),
                       ring.ring_reduce_scatter(x, pc))
    assert torch.equal(ring_hier.hier_reduce_scatter(x, N),
                       ring.ring_reduce_scatter(x))


@pytest.mark.parametrize("name", CODECS)
@pytest.mark.parametrize("ni", FACTORS)
def test_plan_equals_jax(name, ni):
    """The exact per-phase wire bytes and ``describe()`` equal JAX's."""
    jc, pc = _codecs(name)
    L = N * (jc.pad_elems if jc else 1) * 128
    plan = ring_hier.plan_hier(L, N, ni, pc)
    want = jax_hier.plan_hier(L, N, ni, jc)
    assert plan.describe() == want.describe()
    for which in ("reduce_scatter", "all_gather", "all_reduce"):
        assert plan.wire_bytes(which) == want.wire_bytes(which)
        assert plan.intra_bytes(which) == want.intra_bytes(which)
        assert plan.inter_bytes(which) == want.inter_bytes(which)
    assert ring_hier.wire_bytes_per_device(L, N, ni, pc) == \
        jax_hier.wire_bytes_per_device(L, N, ni, jc)


def test_bad_factorization_fails_loudly():
    with pytest.raises(ValueError):
        ring_hier.plan_hier(N * 16, N, 3, None)    # 3 does not divide 8
    with pytest.raises(ValueError):
        ring_hier.plan_hier(N * 16 + 1, N, 2, None)
    with pytest.raises(ValueError):
        ring_hier.hier_reduce_scatter(torch.zeros((N, N * 4)), 3)


@pytest.mark.parametrize("n,ni,s_inter", [(8, 2, 1), (8, 4, 3), (6, 3, 2),
                                          (8, 1, 1), (8, 8, 4)])
def test_phase_program_equals_jax(n, ni, s_inter):
    got = opstream.hier_program(n, ni, s_inter)
    want = jax_opstream.hier_program(n, ni, s_inter)
    assert tuple(got) == tuple(want)
    for phase in ("rs_intra", "rs_inter", "ag_inter", "ag_intra"):
        assert getattr(got, phase).msg(2, 1) == getattr(want, phase).msg(2, 1)
    assert opstream.intra_perm(n, ni) == jax_opstream.intra_perm(n, ni)
    assert opstream.inter_perm(n, ni) == jax_opstream.inter_perm(n, ni)


# JAX's hier RING_CELLS (tests/test_integrity.py) and the rest of each
# collective: (codec, which, ni, sliced)
INTEGRITY_CELLS = [
    ("bfp", "all_reduce", 2, False),
    ("int8", "reduce_scatter", 4, True),
    (None, "all_gather", 2, False),
    (None, "reduce_scatter", 4, False),
    ("topk", "all_reduce", 4, False),
    ("bfp", "all_gather", 4, False),
]


def _hier(which, ni, codec, slice_elems, integ, jax_side=False):
    mod, kw = (jax_hier, {}) if jax_side else (ring_hier, {})
    kw = dict(compression=codec, integrity=integ)
    if which == "all_gather":
        if jax_side:
            return lambda v: mod.hier_all_gather(v, "dp", ni, **kw)
        return lambda v: mod.hier_all_gather(v, ni, **kw)
    kw["slice_elems"] = slice_elems
    fn = mod.hier_reduce_scatter if which == "reduce_scatter" \
        else mod.hier_all_reduce
    if jax_side:
        return lambda v: fn(v, "dp", ni, **kw)
    return lambda v: fn(v, ni, **kw)


@pytest.mark.parametrize("name,which,ni,sliced", INTEGRITY_CELLS)
def test_integrity_clean_matches_jax(name, which, ni, sliced):
    """A clean run: the verdict true, the result bit-equal to integrity
    off and to JAX's integrity run, whose verdict is true too."""
    jc, pc = _codecs(name)
    x = _payload(jc, 6)
    slice_elems = x.shape[1] // N // 2 if sliced else None
    rows = torch.from_numpy(x)
    on, ok = _hier(which, ni, pc, slice_elems, True)(rows)
    off = _hier(which, ni, pc, slice_elems, False)(rows)
    assert bool(ok)
    assert torch.equal(on, off)
    j_on, j_ok = _run(_hier(which, ni, jc, slice_elems, True, True), x,
                      (P("dp"), P()))
    assert j_ok
    np.testing.assert_array_equal(on.numpy(), j_on)


@pytest.fixture
def wire_taps():
    chaos.install_wire_tap()
    try:
        yield
    finally:
        chaos.uninstall_wire_tap()


@pytest.mark.parametrize("name,which,ni", [
    (None, "all_reduce", 2), ("bfp", "all_reduce", 4),
    ("int8", "reduce_scatter", 2), ("topk", "all_reduce", 2),
    ("bfp", "all_gather", 2), (None, "all_gather", 4)])
def test_wirebit_on_a_hier_hop_trips(wire_taps, name, which, ni):
    """One low bit flipped in one received frame (the collective's wire
    tap fires on hier hops as on flat ones) fails the verdict; the outputs
    stay finite.  The port only: JAX's host wire tap aborted the test
    process on hier hops (the bfp gather, the top-k all-reduce) on this
    CPU mesh, and JAX's own tests fault no hier hop."""
    _, pc = _codecs(name)
    x = _payload(pc, 7)
    plan = chaos.FaultPlan([chaos.FaultSpec(
        "corruption", "collective", step=0, mode="wirebit",
        fraction=0.01)], seed=3)
    with chaos.activate(plan):
        plan.begin_step(0)
        out, ok = _hier(which, ni, pc, None, True)(torch.from_numpy(x))
    assert len(plan.fired) == 1
    assert torch.isfinite(out).all()
    assert not bool(ok)


def test_config_errors():
    """JAX's three ValueErrors: hier with impl="xla", without intra_size,
    and with fused_kernel."""
    with pytest.raises(ValueError, match="impl='ring'"):
        config.CollectiveConfig(impl="xla", topology="hier", intra_size=2)
    with pytest.raises(ValueError, match="intra_size"):
        config.CollectiveConfig(impl="ring", topology="hier")
    with pytest.raises(ValueError, match="fused_kernel"):
        config.CollectiveConfig(impl="ring", codec="bfp", topology="hier",
                                intra_size=2, fused_kernel=True)


SIZES = (64, 64, 32)


def _mlp_data():
    r = np.random.default_rng(0)
    return (r.standard_normal((64, 64)).astype(np.float32),
            r.integers(0, 32, (64,)).astype(np.int32))


def _port_dp(coll, cls=DPTrainer, opt=None):
    m = config.MLPConfig(layer_sizes=SIZES)
    cfg = config.TrainConfig(mesh=config.MeshConfig(dp=N), collective=coll,
                             global_batch=64,
                             optimizer=opt or config.OptimizerConfig())
    return cls(lambda p, b: mlp.loss_fn(p, b, m), VirtualRanks(N, CPU), cfg)


def _jax_params():
    p = jax_mlp.init(jax.random.PRNGKey(0), jcfg.MLPConfig(layer_sizes=SIZES))
    return jax.tree_util.tree_map(np.asarray, p)


def _train(tr, steps=2):
    st = tr.init_state(mlp.from_jax_params(_jax_params(), CPU))
    x, y = _mlp_data()
    batch = tr.shard_batch((torch.from_numpy(x), torch.from_numpy(y)))
    for _ in range(steps):
        st, loss = tr.step(st, batch)
    return st, float(loss)


def test_hier_trainer_matches_flat_and_jax():
    """DPTrainer with hier (intra 4) against the flat trainer and JAX's
    hier DPTrainer: masters within rtol 1e-5 / atol 1e-6; the statics'
    declaration is the plan's, and equals JAX's."""
    hier = config.CollectiveConfig(impl="ring", topology="hier",
                                   intra_size=4)
    trh = _port_dp(hier)
    sh, lh = _train(trh)
    sf, lf = _train(_port_dp(config.CollectiveConfig(impl="ring")))
    assert np.isfinite(lh) and np.isfinite(lf)
    np.testing.assert_allclose(sh.w_own.numpy(), sf.w_own.numpy(),
                               rtol=1e-5, atol=1e-6)
    sm = trh.obs_static_metrics()
    assert sm["topology"] == "hier" and sm["hier_plan"]["n_intra"] == 4
    assert sm["wire_bytes_per_allreduce"] == \
        sm["hier_plan"]["wire_bytes_all_reduce"]
    jt = JaxDPTrainer(
        lambda p, b: jax_mlp.loss_fn(p, b, jcfg.MLPConfig(layer_sizes=SIZES)),
        make_mesh(jcfg.MeshConfig(dp=N)),
        jcfg.TrainConfig(mesh=jcfg.MeshConfig(dp=N), global_batch=64,
                         collective=jcfg.CollectiveConfig(
                             impl="ring", topology="hier", intra_size=4)))
    js = jt.init_state(jax.tree_util.tree_map(jnp.asarray, _jax_params()))
    x, y = _mlp_data()
    for _ in range(2):
        js, _ = jt.step(js, jt.shard_batch((jnp.asarray(x),
                                            jnp.asarray(y))))
    np.testing.assert_allclose(sh.w_own.numpy(),
                               np.asarray(js.w_own).reshape(N, -1),
                               rtol=1e-5, atol=1e-6)
    assert sm == jt.obs_static_metrics()


@pytest.mark.parametrize("ni", (2, 4))
def test_hier_bfp_fused_update_bitexact_vs_golden(ni):
    """The EQuARX shape: BFP on the slow hop only and the fused update
    after the reduce.  ``apply_grads`` on JAX's gradients equals the hier
    goldens composed with ``golden_fused_apply``, two steps, bit for bit."""
    coll = config.CollectiveConfig(impl="ring", codec="bfp",
                                   topology="hier", intra_size=ni,
                                   fused_optimizer=True)
    sgd = config.OptimizerConfig(kind="sgd", learning_rate=0.1)
    tr = _port_dp(coll, opt=sgd)
    params = _jax_params()
    st = tr.init_state(mlp.from_jax_params(params, CPU))
    L = N * st.w_own.shape[1]
    rt = jax_golden.roundtrip_fn(jax_compress.get_codec("bfp"))
    hyper = np.asarray(jax_optim.fused_hyperparams(
        jax_optim.OptimizerConfig(kind="sgd", learning_rate=0.1)))
    vg = jax.jit(jax.grad(lambda p, b: jax_mlp.loss_fn(
        p, b, jcfg.MLPConfig(layer_sizes=SIZES))))
    w_ref = st.w_own.numpy().copy()
    x, y = _mlp_data()
    for _ in range(2):
        rows = []
        for i in range(N):
            g = vg(params, (jnp.asarray(x[i * 8:(i + 1) * 8]),
                            jnp.asarray(y[i * 8:(i + 1) * 8])))
            row = np.concatenate([np.asarray(v).reshape(-1)
                                  for v in jax.tree_util.tree_leaves(g)])
            rows.append(np.pad(row, (0, L - row.shape[0])))
        flat_g = np.stack(rows).astype(np.float32)
        st = tr.apply_grads(st, torch.from_numpy(flat_g))
        g_sum = jax_golden.hier_reduce_scatter(flat_g, ni, rt)
        w_ref = np.stack([jax_optim.golden_fused_apply(
            "sgd", w_ref[i], g_sum[i], {}, hyper, N)[0] for i in range(N)])
        np.testing.assert_array_equal(st.w_own.numpy(), w_ref)
        np.testing.assert_array_equal(
            st.replicas.numpy(), jax_golden.hier_all_gather(w_ref, ni, rt))
        params = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(params),
            [a.numpy() for a in fused_update.tree_leaves(st.params)])


def test_hier_ddp_trainer_tracks_flat():
    """The bucketed DDP trainer takes hier through
    ``ring_all_reduce_routed``: two AdamW steps within rtol 1e-5 / atol
    1e-6 of the flat ring's, replicas identical."""
    adamw = config.OptimizerConfig(kind="adamw", learning_rate=1e-3)

    def run(coll):
        tr = _port_dp(coll, DDPTrainer, adamw)
        st, loss = _train(tr)
        return tr, st, loss
    trh, sh, _ = run(config.CollectiveConfig(
        impl="ring", topology="hier", intra_size=2, bucket_elems=2048))
    _, sf, _ = run(config.CollectiveConfig(impl="ring", bucket_elems=2048))
    np.testing.assert_allclose(sh.w_master.numpy(), sf.w_master.numpy(),
                               rtol=1e-5, atol=1e-6)
    assert trh.obs_static_metrics()["topology"] == "hier"


def test_train_mlp_hier_flags_on_cpu():
    """train_mlp's flags, intra_size before topology (``from_flags``
    validates each flag as it comes)."""
    out = train_mlp.main([
        "--device=cpu", "--mesh.dp=8", "--global_batch=64", "--iters=2",
        "--model.layer_sizes=64,64,32", "--collective.impl=ring",
        "--collective.codec=bfp", "--collective.intra_size=2",
        "--collective.topology=hier", "--collective.fused_optimizer=true"])
    assert np.isfinite(out["loss"]) and out["codec"]["codec"] == "bfp"
