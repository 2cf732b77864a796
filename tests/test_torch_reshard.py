"""The port's live reshard tier (``parallel/reshard.py``, ``ReshardPolicy``
in ``parallel/elastic.py``) against the JAX package's
``tests/test_reshard.py``, on the tiny MLP (32, 64, 10) over virtual ranks.

- the IR (intersection table, owners, union layout, action programs, op
  streams) and the plans (``describe()``, wire and seed bytes) equal the
  JAX package's on its four cases and on every n_src, n_tgt in 1..8;
- the same numpy state moved by both packages' ``reshard_state`` lands
  bit-equal, the residual bit-equal to the numpy golden;
- within the port, resharded equals native (the restore path plus the
  golden residual) bitwise, state and next step, for JAX's six parity
  cells and the grows 2 -> 8 and 4 -> 8, and the wire counter equals
  ``plan.wire_bytes()`` (the seed counter ``plan.seed_bytes()``);
- after a move, a step tracks JAX's within ``test_torch_train.py``'s
  stated atol;
- a ``wirebit`` at ``reshard.transfer`` trips the transfer's verdict;
- the elastic cells: preemption, dead buffers, tier accounting, re-arm,
  ``max_reshards``, scale-out, the no-op rung, rung validation, and the
  integrity trip falling through to restore.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import jax
import jax.numpy as jnp

from fpga_ai_nic_tpu.models import mlp as jax_mlp
from fpga_ai_nic_tpu.parallel import DPTrainer as JaxDPTrainer, make_mesh
from fpga_ai_nic_tpu.parallel import reshard as jrs
from fpga_ai_nic_tpu.utils import config as jcfg
from fpga_ai_nic_tpu.verify import opstream as jops
from fpga_ai_nic_tpu_torch.models import mlp
from fpga_ai_nic_tpu_torch.ops import fused_update
from fpga_ai_nic_tpu_torch.parallel import FSDPTrainer
from fpga_ai_nic_tpu_torch.parallel import reshard as rs
from fpga_ai_nic_tpu_torch.parallel.elastic import (ElasticConfig,
                                                    ElasticTrainer,
                                                    ReshardPolicy)
from fpga_ai_nic_tpu_torch.parallel.mesh import VirtualRanks
from fpga_ai_nic_tpu_torch.parallel.train import DPTrainer
from fpga_ai_nic_tpu_torch.runtime import chaos
from fpga_ai_nic_tpu_torch.utils import config
from fpga_ai_nic_tpu_torch.utils.observability import Profiler
from fpga_ai_nic_tpu_torch.verify import opstream as ops

SIZES = (32, 64, 10)
CPU = torch.device("cpu")
MCFG = config.MLPConfig(layer_sizes=SIZES, dtype="float32")
JMCFG = jcfg.MLPConfig(layer_sizes=SIZES, dtype="float32")


def _loss(params, batch):
    return mlp.loss_fn(params, batch, MCFG)


def _data(n=64, seed=0):
    r = np.random.default_rng(seed)
    x = r.standard_normal((n, 32)).astype(np.float32)
    y = r.integers(0, 10, n).astype(np.int32)
    return x, y


def _batch(tr, seed=0):
    x, y = _data(seed=seed)
    return tr.shard_batch((torch.from_numpy(x), torch.from_numpy(y)))


def _cfg(mod, n, codec=None, codec_opts=(), fused=False, kind="adamw",
         axis="dp", integrity=False):
    return mod.TrainConfig(
        iters=4, global_batch=64, mesh=mod.MeshConfig(**{axis: n}),
        collective=mod.CollectiveConfig(
            impl="ring", codec=codec, codec_opts=tuple(codec_opts),
            fused_optimizer=fused, integrity_check=integrity),
        optimizer=mod.OptimizerConfig(kind=kind, learning_rate=3e-3,
                                      weight_decay=0.01))


def _trainer(n, cls=DPTrainer, **kw):
    axis = "fsdp" if cls is FSDPTrainer else "dp"
    return cls(_loss, VirtualRanks(n, CPU), _cfg(config, n, axis=axis, **kw))


def _jax_params():
    return jax.tree_util.tree_map(np.asarray, jax_mlp.init(
        jax.random.PRNGKey(0), JMCFG))


def _params():
    return mlp.from_jax_params(_jax_params(), "cpu")


def _trained(n, steps=2, **kw):
    tr = _trainer(n, **kw)
    state = tr.init_state(_params())
    batch = _batch(tr)
    for _ in range(steps):
        state, _ = tr.step(state, batch)
    return tr, state


def _host(state):
    """Copies of what a move reads (the move releases the sources)."""
    return {"w_own": state.w_own.clone(),
            "opt_state": {k: v.clone() for k, v in state.opt_state.items()},
            "step": int(state.step),
            "codec_state": (None if state.codec_state is None
                            else state.codec_state.clone())}


def _native_state(tr_tgt, host, tr_src):
    """The same logical state built on the target through the restore path
    (``repad_flat`` of the flat leaves) and the golden residual twin."""
    payload = {"w_own": host["w_own"].reshape(-1).numpy(),
               "opt_state": {k: v.reshape(-1).numpy()
                             for k, v in host["opt_state"].items()},
               "step": host["step"]}
    native = tr_tgt.restore_state(
        payload, params_like=fused_update.params_like_from_meta(tr_src._meta))
    if host["codec_state"] is not None:
        g = rs.golden_redistribute_residual(
            host["codec_state"].numpy(), sum(tr_src._meta.sizes), tr_tgt.n,
            tr_tgt._meta.padded_len)
        native = native._replace(codec_state=torch.from_numpy(g))
    return native


def _equal(a, b):
    assert a.shape == b.shape and torch.equal(a, b)


def _loss_of(m):
    return m["loss"] if isinstance(m, dict) else m


# ---------------------------------------------------------------------------
# the IR and the plans, against the JAX package's
# ---------------------------------------------------------------------------

JAX_TABLE_CASES = [(5000, 625, 1250), (5000, 625, 1667), (5000, 2500, 625),
                   (4999, 717, 1009)]


@pytest.mark.parametrize("live,c_src,c_tgt", JAX_TABLE_CASES)
def test_intersection_table_equals_jax(live, c_src, c_tgt):
    table = rs.intersection_table(live, c_src, c_tgt)
    assert [tuple(t) for t in table] == [
        tuple(t) for t in jrs.intersection_table(live, c_src, c_tgt)]
    off = 0
    for t in table:                   # an exact partition, in order
        assert t.src * c_src + t.src_off == off
        assert t.dst * c_tgt + t.dst_off == off
        assert t.src_off + t.length <= c_src
        assert t.dst_off + t.length <= c_tgt
        off += t.length
    assert off == live
    for base in (0, 7):
        assert [tuple(a) for a in ops.reshard_leaf_actions(table, base)] \
            == [tuple(a) for a in jops.reshard_leaf_actions(table, base)]


def _pad(live, n, m=1):
    unit = n * m
    return live + (-live) % unit


@pytest.mark.parametrize("n_src", range(1, 9))
def test_ir_and_plans_equal_jax_over_rank_counts(n_src):
    """Every n_tgt in 1..8 (n_src != n_tgt), with and without a residual,
    at three flat leaves: the union layout, the owners, the message
    bases, the residual actions, the op streams (integrity on and off)
    and the plan's ``describe()``, wire and seed bytes."""
    live = 2762                      # the tiny MLP's live elements
    for n_tgt in range(1, 9):
        if n_tgt == n_src:
            continue
        p_src, p_tgt = _pad(live, n_src, 16), _pad(live, n_tgt, 16)
        args = (live, n_src, p_src, n_tgt, p_tgt)
        assert ops.union_layout(*args) == jops.union_layout(*args)
        assert ops.reshard_owners(n_src, n_tgt) == \
            jops.reshard_owners(n_src, n_tgt)
        assert ops.reshard_msg_bases(5, 3) == jops.reshard_msg_bases(5, 3)
        owners = ops.reshard_owners(n_src, n_tgt)
        assert [tuple(a) for a in ops.reshard_residual_actions(owners, 9)] \
            == [tuple(a) for a in jops.reshard_residual_actions(owners, 9)]
        c_src, c_tgt, n_union, _ = ops.union_layout(*args)
        for integ in (False, True):
            assert ops.reshard_op_stream(
                live, c_src, c_tgt, n_union, owners, 3, integ) == \
                jops.reshard_op_stream(live, c_src, c_tgt, n_union, owners,
                                       3, integ)
        for resid in (False, True):
            mine = rs.make_plan(*args, n_flat_leaves=3, residual=resid)
            ref = jrs.make_plan(*args, n_flat_leaves=3, residual=resid)
            assert mine.describe() == ref.describe()
            assert mine.wire_bytes() == ref.wire_bytes()
            assert mine.seed_bytes() == ref.seed_bytes()
            assert [tuple(t) for t in mine.flat.table] == [
                tuple(t) for t in ref.flat.table]


def test_plan_wire_accounting_counts_only_owner_changes():
    plan = rs.make_plan(5000, 8, 5000, 4, 5000, n_flat_leaves=3,
                        residual=True)
    fp = plan.flat
    assert fp.wire_elems + fp.local_elems == fp.live
    assert fp.seed_elems == 0
    by_hand = sum(t.length for t in fp.table if t.src != t.dst)
    assert plan.wire_bytes() == 4 * (3 * by_hand + plan.residual.wire_elems)
    assert plan.residual.wire_elems == 5000 * 7
    grow = rs.make_plan(5000, 2, 5000, 8, 5000, n_flat_leaves=1)
    assert grow.flat.n_union == 8
    assert grow.seed_bytes() == 4 * (5000 - 625)


def test_plan_at_the_mlp_width():
    """The byte counts of the card's moves at MLPConfig()'s layout
    (41,963,520 live, padded_len 41,963,520 at n = 8, 4 and 2)."""
    L = 41_963_520
    assert rs.make_plan(L, 8, L, 4, L, n_flat_leaves=1).wire_bytes() == \
        146_872_320
    assert rs.make_plan(L, 8, L, 4, L, n_flat_leaves=3).wire_bytes() == \
        440_616_960
    assert rs.make_plan(L, 4, L, 2, L, n_flat_leaves=1).wire_bytes() == \
        125_890_560
    grow = rs.make_plan(L, 4, L, 8, L, n_flat_leaves=1)
    assert (grow.wire_bytes(), grow.seed_bytes()) == (0, 146_872_320)


def test_residual_golden_equals_jax_and_conserves_mass():
    r = np.random.default_rng(7)
    res = r.standard_normal((8, 96)).astype(np.float32)
    out = rs.golden_redistribute_residual(res, live=80, n_tgt=4,
                                          pad_tgt=112)
    np.testing.assert_array_equal(out, jrs.golden_redistribute_residual(
        res, live=80, n_tgt=4, pad_tgt=112))
    np.testing.assert_allclose(out[:, :80].sum(0), res[:, :80].sum(0),
                               rtol=1e-6)
    assert np.abs(out[:, 80:]).max() == 0.0
    np.testing.assert_array_equal(out[0, :80], res[0, :80] + res[1, :80])


def test_plan_for_rejects_mismatches():
    tr8, _ = _trained(8, steps=0)
    with pytest.raises(ValueError, match="wire format"):
        rs.plan_for(tr8, _trainer(4, codec="topk"))
    with pytest.raises(ValueError, match="trainer kinds"):
        rs.plan_for(tr8, _trainer(4, cls=FSDPTrainer))
    ef8, _ = _trained(8, steps=0, codec="int8",
                      codec_opts=(("error_feedback", True),))
    with pytest.raises(ValueError, match="wire format"):
        rs.plan_for(ef8, _trainer(4, codec="int8"))


# ---------------------------------------------------------------------------
# the move: both packages on the same numpy state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_src,n_tgt,codec,opts", [
    (8, 4, None, ()),
    (8, 3, "topk", ()),
    (4, 8, None, ()),
    (8, 4, "int8", (("error_feedback", True),)),
])
def test_both_packages_move_the_same_state_bit_equal(n_src, n_tgt, codec,
                                                     opts):
    """JAX's trainer trains two steps; its state, as numpy, goes through
    JAX's ``reshard_state`` and (as the port's state of the same values)
    through the port's: every landed leaf bit-equal."""
    jtr = {n: JaxDPTrainer(lambda p, b: jax_mlp.loss_fn(p, b, JMCFG),
                           make_mesh(jcfg.MeshConfig(dp=n)),
                           _cfg(jcfg, n, codec=codec, codec_opts=opts))
           for n in (n_src, n_tgt)}
    js = jtr[n_src].init_state(jax.tree_util.tree_map(jnp.asarray,
                                                      _jax_params()))
    x, y = _data()
    jb = jtr[n_src].shard_batch((jnp.asarray(x), jnp.asarray(y)))
    for _ in range(2):
        js, _ = jtr[n_src].step(js, jb)
    host = jax.device_get(js)
    ptr = {n: _trainer(n, codec=codec, codec_opts=opts)
           for n in (n_src, n_tgt)}
    payload = {"w_own": np.asarray(host.w_own),
               "opt_state": {k: np.asarray(v)
                             for k, v in host.opt_state.items()},
               "step": int(host.step)}
    ps = ptr[n_src].restore_state(payload, params_like=_params())
    if host.codec_state is not None:
        ps = ps._replace(codec_state=torch.from_numpy(np.asarray(
            host.codec_state).reshape(n_src, -1).copy()))
    jout = jax.device_get(jrs.reshard_state(jtr[n_src], jtr[n_tgt], js))
    pout = rs.reshard_state(ptr[n_src], ptr[n_tgt], ps)
    np.testing.assert_array_equal(pout.w_own.reshape(-1).numpy(),
                                  np.asarray(jout.w_own))
    for k in jout.opt_state:
        np.testing.assert_array_equal(
            pout.opt_state[k].reshape(-1).numpy(),
            np.asarray(jout.opt_state[k]))
    if jout.codec_state is not None:
        np.testing.assert_array_equal(
            pout.codec_state.reshape(-1).numpy(),
            np.asarray(jout.codec_state))
    assert pout.step == int(jout.step) == 2


# ---------------------------------------------------------------------------
# bit-parity within the port: resharded against native
# ---------------------------------------------------------------------------

_PARITY_CELLS = [
    # (cls, codec, codec_opts, fused, n_src, n_tgt): JAX's six, two grows
    (DPTrainer, None, (), True, 8, 4),
    (DPTrainer, "bfp", (), True, 8, 4),
    (DPTrainer, "topk", (), True, 8, 4),
    (DPTrainer, "int8", (("error_feedback", True),), False, 8, 4),
    (FSDPTrainer, None, (), False, 8, 4),
    (FSDPTrainer, "topk", (), False, 8, 4),
    (DPTrainer, "topk", (), True, 2, 8),
    (DPTrainer, "topk", (), True, 4, 8),
]


@pytest.mark.parametrize(
    "cls,codec,opts,fused,n_src,n_tgt", _PARITY_CELLS,
    ids=[f"{c.__name__}-{k or 'none'}{'-fused' if f else ''}-{a}to{b}"
         for c, k, _, f, a, b in _PARITY_CELLS])
def test_bit_parity_resharded_vs_native(cls, codec, opts, fused, n_src,
                                        n_tgt):
    """Two steps at n_src, a move to n_tgt, against the same logical state
    built natively at n_tgt: every leaf bitwise (the residual too, and
    nonzero), then one more step on each, loss and masters bitwise.  The
    wire counter equals ``plan.wire_bytes()``, the seed counter
    ``plan.seed_bytes()``."""
    kw = dict(cls=cls, codec=codec, codec_opts=opts, fused=fused)
    tr_s, state = _trained(n_src, **kw)
    tr_t = _trainer(n_tgt, **kw)
    host = _host(state)
    native = _native_state(tr_t, host, tr_s)
    plan = rs.plan_for(tr_s, tr_t)
    rs.reset_wire_counters()
    moved = rs.reshard_state(tr_s, tr_t, state)
    assert rs.WIRE["bytes"] == plan.wire_bytes()
    assert rs.WIRE["seed_bytes"] == plan.seed_bytes()
    assert (plan.seed_bytes() > 0) == (n_tgt > n_src)
    assert not chaos.state_buffers_alive(state)      # donated
    assert moved.step == native.step == 2
    _equal(moved.w_own, native.w_own)
    for k in native.opt_state:
        _equal(moved.opt_state[k], native.opt_state[k])
    if native.codec_state is not None:
        _equal(moved.codec_state, native.codec_state)
        assert float(moved.codec_state.abs().max()) > 0.0
    if hasattr(native, "replicas"):
        _equal(moved.replicas, native.replicas)
    batch = _batch(tr_t)
    s_r, m_r = tr_t.step(moved, batch)
    s_n, m_n = tr_t.step(native, batch)
    assert float(_loss_of(m_r)) == float(_loss_of(m_n))
    _equal(s_r.w_own, s_n.w_own)
    if s_n.codec_state is not None:
        _equal(s_r.codec_state, s_n.codec_state)


def test_grow_2_to_8_value_exact_momentum():
    tr2, state = _trained(2, steps=1, kind="momentum")
    host = {k: v.reshape(-1).clone()
            for k, v in tr2.reshard_leaves(state).items()}
    live = sum(tr2._meta.sizes)
    tr8 = _trainer(8, kind="momentum")
    grown = rs.reshard_state(tr2, tr8, state)
    for k, v in tr8.reshard_leaves(grown).items():
        _equal(v.reshape(-1)[:live], host[k][:live])
        assert not bool(v.reshape(-1)[live:].any())
    _, loss = tr8.step(grown, _batch(tr8))
    assert np.isfinite(float(loss))


def test_step_after_move_tracks_jax():
    """Two steps at dp=8 and a move to dp=4 in both packages (BFP ring,
    fused SGD, from the same weights and batch), then one step at dp=4:
    losses at rtol 1e-5 and the masters within ``test_torch_train.py``'s
    stated atol, lr * 2^-6 * max|g| a step (one BFP grid step may flip
    where the GEMMs' summation order moves a value across a rounding
    boundary)."""
    lr = 0.1
    bfp = dict(impl="ring", compression=None, codec="bfp",
               fused_optimizer=True)

    def cfg(mod, n):
        return mod.TrainConfig(
            global_batch=64, mesh=mod.MeshConfig(dp=n),
            collective=mod.CollectiveConfig(**bfp),
            optimizer=mod.OptimizerConfig(kind="sgd", learning_rate=lr))

    jtr = {n: JaxDPTrainer(lambda p, b: jax_mlp.loss_fn(p, b, JMCFG),
                           make_mesh(jcfg.MeshConfig(dp=n)), cfg(jcfg, n))
           for n in (8, 4)}
    ptr = {n: DPTrainer(_loss, VirtualRanks(n, CPU), cfg(config, n))
           for n in (8, 4)}
    x, y = _data()
    js = jtr[8].init_state(jax.tree_util.tree_map(jnp.asarray,
                                                  _jax_params()))
    ps = ptr[8].init_state(_params())
    atol = 0.0
    for _ in range(2):
        g, _ = ptr[8].grads(ps, _batch(ptr[8]))
        atol += lr * 2.0 ** -6 * float(g.abs().max())
        js, _ = jtr[8].step(js, jtr[8].shard_batch((jnp.asarray(x),
                                                    jnp.asarray(y))))
        ps, _ = ptr[8].step(ps, _batch(ptr[8]))
    js = jrs.reshard_state(jtr[8], jtr[4], js)
    ps = rs.reshard_state(ptr[8], ptr[4], ps)
    g, _ = ptr[4].grads(ps, _batch(ptr[4]))
    atol += lr * 2.0 ** -6 * float(g.abs().max())
    js, jl = jtr[4].step(js, jtr[4].shard_batch((jnp.asarray(x),
                                                 jnp.asarray(y))))
    ps, pl = ptr[4].step(ps, _batch(ptr[4]))
    np.testing.assert_allclose(float(pl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(ps.w_own.reshape(-1).numpy(),
                               np.asarray(js.w_own), rtol=0, atol=atol)


def test_side_leaves_and_sharded_trainers_are_refused():
    tr8, state = _trained(8, steps=0)
    with pytest.raises(ValueError, match="side leaves"):
        tr8.reshard_leaves(state._replace(side=torch.zeros(8, 4)))
    tr8.takes_sp = True
    with pytest.raises(ValueError, match="ShardedTrainer"):
        rs.plan_for(tr8, _trainer(4))


# ---------------------------------------------------------------------------
# the transfer's integrity tier
# ---------------------------------------------------------------------------

@pytest.fixture
def wire_tap():
    chaos.install_wire_tap()
    yield
    chaos.uninstall_wire_tap()


def test_wirebit_trips_the_reshard_transfer(wire_tap):
    """A flipped bit on a segment's wire raises WireIntegrityError before
    the landed state reaches the target trainer (JAX's
    tests/test_integrity.py case)."""
    tr8, state = _trained(8, steps=1)
    plan = chaos.FaultPlan(
        [chaos.FaultSpec("corruption", "reshard.transfer", step=0,
                         mode="wirebit", fraction=0.05)], seed=5)
    with chaos.activate(plan):
        plan.begin_step(0)
        with pytest.raises(chaos.WireIntegrityError,
                           match="reshard transfer"):
            rs.reshard_state(tr8, _trainer(4), state, integrity=True)
    assert len(plan.fired) == 1


def test_reshard_integrity_clean_is_bit_identical(wire_tap):
    kw = dict(codec="topk", codec_opts=(("bucket_elems", 512), ("k", 64)))
    tr8, state = _trained(8, steps=1, **kw)
    twin = state._replace(w_own=state.w_own.clone(),
                          opt_state={k: v.clone() for k, v in
                                     state.opt_state.items()},
                          codec_state=state.codec_state.clone())
    a = rs.reshard_state(tr8, _trainer(4, **kw), state, integrity=True)
    b = rs.reshard_state(tr8, _trainer(4, **kw), twin, integrity=False)
    _equal(a.w_own, b.w_own)
    _equal(a.codec_state, b.codec_state)
    for k in a.opt_state:
        _equal(a.opt_state[k], b.opt_state[k])


def test_reshard_transfer_site_takes_wirebit_only():
    chaos.FaultSpec("corruption", "reshard.transfer", step=0, mode="wirebit")
    for kind, mode in (("corruption", "nan"), ("hang", "nan")):
        with pytest.raises(ValueError, match="reshard.transfer"):
            chaos.FaultSpec(kind, "reshard.transfer", step=0, mode=mode)


# ---------------------------------------------------------------------------
# the elastic loop's shrinkable tier
# ---------------------------------------------------------------------------

_ECFG = ElasticConfig(step_timeout_s=4.0, stall_after_s=60.0,
                      max_retries=3, backoff_s=0.01, ckpt_every=1)


def _sgd(n):
    return _trainer(n, kind="sgd")


def _native_run(widths, steps):
    """Masters of a run that trains ``widths[i]`` ranks for ``steps[i]``
    steps each, moving between them through the restore path (the native
    twin of the reshard tier)."""
    tr = _sgd(widths[0])
    state = tr.init_state(_params())
    for i, (n, k) in enumerate(zip(widths, steps)):
        if i:
            nxt = _sgd(n)
            state = nxt.restore_state(
                {"w_own": state.w_own.reshape(-1).numpy(),
                 "opt_state": {k_: v.reshape(-1).numpy()
                               for k_, v in state.opt_state.items()},
                 "step": state.step},
                params_like=fused_update.params_like_from_meta(tr._meta))
            tr = nxt
        for _ in range(k):
            state, _ = tr.step(state, _batch(tr))
    return state.w_own


def _run_elastic(tmp_path, specs, widths0, shrink_to, n_steps=5,
                 prewarm=True, **pol):
    tr = _sgd(widths0)
    state = tr.init_state(_params())
    batch = _batch(tr)
    plan = chaos.FaultPlan(specs, seed=11)
    with chaos.activate(plan):
        et = ElasticTrainer(tr, str(tmp_path), _ECFG, plan=plan,
                            reshard=ReshardPolicy(_sgd, shrink_to=shrink_to,
                                                  **pol))
        if prewarm:
            et.prewarm_reshard(state, batch)
        state, metrics = et.run(state, lambda i: batch, n_steps)
    return et, state, metrics


def test_elastic_preemption_recovers_by_live_reshard(tmp_path):
    et, state, metrics = _run_elastic(
        tmp_path, [chaos.FaultSpec("preemption", "queue.issue", step=2)],
        8, 4)
    rec = et.profiler.recovery.as_dict()
    assert state.step == 5 and np.isfinite(float(metrics["loss"]))
    assert et.trainer.n == 4
    assert rec["faults"] == {"shrinkable": 1}
    assert rec["reshards"] == 1 and rec["checkpoint_restores"] == 0
    assert rec["mttr_reshard_mean_s"] > 0
    assert rec["events"][0]["tier"] == "reshard"
    assert et.reshard_policy is None
    names = {e["name"] for e in et.profiler.events.snapshot()}
    assert {"reshard.transfer", "reshard.done"} <= names
    _equal(state.w_own, _native_run((8, 4), (2, 3)))


def test_classify_falls_back_when_state_buffers_dead(tmp_path):
    tr8 = _sgd(8)
    state = tr8.init_state(_params())
    et = ElasticTrainer(tr8, str(tmp_path), _ECFG,
                        reshard=ReshardPolicy(_sgd, shrink_to=4))
    err = chaos.InjectedPreemption(
        chaos.FaultSpec("preemption", "queue.wait", step=0))
    assert et._classify(err, state) == "shrinkable"
    state.w_own.untyped_storage().resize_(0)     # what a donation leaves
    assert not chaos.state_buffers_alive(state)
    assert et._classify(err, state) == "preemption"
    et2 = ElasticTrainer(tr8, str(tmp_path), _ECFG)
    assert et2._classify(err, None) == "preemption"


def test_recovery_stats_tier_accounting():
    p = Profiler()
    ev1 = p.recovery.record_fault("shrinkable", 3, site="queue.issue")
    p.recovery.record_recovery(0.2, resharded=True, event=ev1)
    ev2 = p.recovery.record_fault("preemption", 4, site="queue.wait")
    p.recovery.record_recovery(1.0, restored=True, event=ev2)
    d = p.recovery.as_dict()
    assert d["reshards"] == 1 and d["checkpoint_restores"] == 1
    assert d["mttr_reshard_mean_s"] == pytest.approx(0.2)
    assert d["mttr_restore_mean_s"] == pytest.approx(1.0)
    assert ev1["tier"] == "reshard" and ev2["tier"] == "restore"
    ev3 = p.recovery.record_fault("shrinkable", 5)
    p.recovery.record_recovery(5.0, resharded=True, restored=True,
                               event=ev3)
    d = p.recovery.as_dict()
    assert ev3["tier"] == "reshard+restore"
    assert d["reshards"] == 2 and d["checkpoint_restores"] == 2
    assert d["mttr_reshard_mean_s"] == pytest.approx(0.2)
    assert d["mttr_mean_s"] == pytest.approx((0.2 + 1.0 + 5.0) / 3)


def test_elastic_rearm_second_preemption_reshards_again(tmp_path):
    et, state, metrics = _run_elastic(
        tmp_path, [chaos.FaultSpec("preemption", "queue.issue", step=1),
                   chaos.FaultSpec("preemption", "queue.issue", step=3)],
        8, (4, 2))
    rec = et.profiler.recovery.as_dict()
    assert state.step == 5 and et.trainer.n == 2
    assert rec["faults"] == {"shrinkable": 2}
    assert rec["reshards"] == 2 and rec["checkpoint_restores"] == 0
    assert et.reshard_policy is None
    _equal(state.w_own, _native_run((8, 4, 2), (1, 2, 2)))


def test_rearm_bounded_by_max_reshards(tmp_path):
    et, state, _ = _run_elastic(
        tmp_path, [chaos.FaultSpec("preemption", "queue.issue", step=1),
                   chaos.FaultSpec("preemption", "queue.issue", step=3)],
        8, (4, 2), max_reshards=1)
    rec = et.profiler.recovery.as_dict()
    assert state.step == 5 and et.trainer.n == 4
    assert rec["faults"] == {"shrinkable": 1, "preemption": 1}
    assert rec["reshards"] == 1 and rec["checkpoint_restores"] >= 1
    assert et.reshard_policy is None
    _equal(state.w_own, _native_run((8, 4), (1, 4)))


def test_elastic_scale_out_grow_4_to_8(tmp_path):
    et, state, _ = _run_elastic(
        tmp_path, [chaos.FaultSpec("preemption", "queue.issue", step=2)],
        4, 8)
    rec = et.profiler.recovery.as_dict()
    assert state.step == 5 and et.trainer.n == 8
    assert rec["faults"] == {"shrinkable": 1}
    assert rec["reshards"] == 1 and rec["checkpoint_restores"] == 0
    done = [e for e in et.profiler.events.snapshot()
            if e["name"] == "reshard.done"]
    src, tgt = _sgd(4), _sgd(8)
    src.init_state(_params())
    want = rs.plan_for(src, tgt)
    assert done[-1]["attrs"]["seed_bytes"] == want.seed_bytes() > 0
    assert done[-1]["attrs"]["wire_bytes"] == want.wire_bytes()
    _equal(state.w_own, _native_run((4, 8), (2, 3)))


def test_noop_rung_skipped_not_wedged(tmp_path):
    et, state, _ = _run_elastic(
        tmp_path, [chaos.FaultSpec("preemption", "queue.issue", step=2)],
        8, (8, 4), prewarm=False)
    rec = et.profiler.recovery.as_dict()
    assert state.step == 5 and et.trainer.n == 4
    assert rec["faults"] == {"shrinkable": 1}
    assert rec["reshards"] == 1 and rec["checkpoint_restores"] == 0
    assert et.reshard_policy is None


def test_reshard_policy_validates_rungs():
    with pytest.raises(ValueError, match="non-positive"):
        ReshardPolicy(lambda n: None, shrink_to=(4, 0))
    with pytest.raises(ValueError, match="at least one"):
        ReshardPolicy(lambda n: None, shrink_to=())
    assert ReshardPolicy(lambda n: None, shrink_to=4).rungs() == (4,)
    assert [f.name for f in dataclasses.fields(ReshardPolicy)] == [
        "trainer_factory", "shrink_to", "prewarm", "max_reshards"]


def test_wire_corruption_falls_through_to_restore(tmp_path, wire_tap):
    """A preemption with a ``wirebit`` on the same step's reshard wire and
    integrity on: the transfer trips, the tier falls through to the
    checkpoint restore on the source width, and the run ends bit-equal to
    the fault-free run."""
    def ichk(n):
        return _trainer(n, kind="sgd", integrity=True)

    tr = ichk(8)
    state = tr.init_state(_params())
    batch = _batch(tr)
    clean = state
    for _ in range(4):
        clean, _ = tr.step(clean, batch)
    plan = chaos.FaultPlan(
        [chaos.FaultSpec("preemption", "queue.issue", step=2),
         chaos.FaultSpec("corruption", "reshard.transfer", step=2,
                         mode="wirebit")], seed=11)
    with chaos.activate(plan):
        et = ElasticTrainer(tr, str(tmp_path), _ECFG, plan=plan,
                            reshard=ReshardPolicy(ichk, shrink_to=4,
                                                  prewarm=False))
        state, _ = et.run(state, lambda i: batch, 4)
    rec = et.profiler.recovery.as_dict()
    assert len(plan.fired) == 2
    assert et.trainer.n == 8
    assert rec["reshards"] == 0 and rec["checkpoint_restores"] == 1
    assert any(e["name"] == "reshard.failed"
               for e in et.profiler.events.snapshot())
    _equal(state.w_own, clean.w_own)
