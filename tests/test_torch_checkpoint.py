"""The port's checkpoints (``utils/checkpoint.py``) against the JAX
package's: JAX's ``tests/test_checkpoint.py`` cases on the port, then the
cross-reads (each package restores the other's steps bit for bit, with
equal manifests), ``compress_array``'s bits, every trainer's
``restore_state`` against JAX's on the same payload, and the drivers
(``train_llama --save=`` read by both ``generate_llama --ckpt=``)."""

import json
import os
import shutil
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import jax
import jax.numpy as jnp
import ml_dtypes
from jax.sharding import Mesh

from fpga_ai_nic_tpu.compress.golden import golden_word_checksum
from fpga_ai_nic_tpu.models import llama as jax_llama
from fpga_ai_nic_tpu.models import mlp as jax_mlp
from fpga_ai_nic_tpu.parallel import DDPTrainer as JaxDDPTrainer
from fpga_ai_nic_tpu.parallel import DPTrainer as JaxDPTrainer
from fpga_ai_nic_tpu.parallel import ShardedTrainer as JaxShardedTrainer
from fpga_ai_nic_tpu.parallel import make_mesh
from fpga_ai_nic_tpu.parallel.fsdp import FSDPTrainer as JaxFSDPTrainer
from fpga_ai_nic_tpu.utils import checkpoint as jax_ckpt
from fpga_ai_nic_tpu.utils import config as jcfg
from fpga_ai_nic_tpu_torch import generate_llama, train_llama
from fpga_ai_nic_tpu_torch.models import llama, mlp
from fpga_ai_nic_tpu_torch.parallel import DDPTrainer, FSDPTrainer
from fpga_ai_nic_tpu_torch.parallel.mesh import VirtualRanks, make_ranks
from fpga_ai_nic_tpu_torch.parallel.sharded import ShardedTrainer
from fpga_ai_nic_tpu_torch.parallel.train import DPTrainer
from fpga_ai_nic_tpu_torch.runtime import chaos
from fpga_ai_nic_tpu_torch.utils import checkpoint as ckpt
from fpga_ai_nic_tpu_torch.utils import config
from fpga_ai_nic_tpu_torch.utils.checkpoint import (
    MANIFEST_FILE, CheckpointIntegrityError, bytes_checksum,
    flip_stored_bit, peer_fetch)

CPU = torch.device("cpu")
SIZES = (16, 32, 8)


def _mcfg(mod):
    return mod.MLPConfig(layer_sizes=SIZES, dtype="float32")


def _tcfg(mod, n=8, kind="momentum", **coll):
    return mod.TrainConfig(iters=1, global_batch=16, mesh=mod.MeshConfig(dp=n),
                           collective=mod.CollectiveConfig(**coll),
                           optimizer=mod.OptimizerConfig(kind=kind))


def _jax_params():
    return jax.tree_util.tree_map(
        np.asarray, jax_mlp.init(jax.random.PRNGKey(0), _mcfg(jcfg)))


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((16, 16)).astype(np.float32),
            rng.integers(0, 8, 16).astype(np.int32))


def _dp(n=8, cls=DPTrainer, **kw):
    """A port trainer on the tiny MLP, its initial state and batch."""
    m = _mcfg(config)
    tcfg = _tcfg(config, n, **kw)
    if cls is FSDPTrainer:
        tcfg = config.TrainConfig(iters=1, global_batch=16,
                                  mesh=config.MeshConfig(fsdp=n),
                                  collective=tcfg.collective,
                                  optimizer=tcfg.optimizer)
        ranks = make_ranks(tcfg.mesh, "cpu")
    else:
        ranks = VirtualRanks(n, CPU)
    tr = cls(lambda p, b: mlp.loss_fn(p, b, m), ranks, tcfg)
    state = tr.init_state(mlp.from_jax_params(_jax_params(), CPU))
    x, y = _batch()
    return tr, state, tr.shard_batch((torch.from_numpy(x),
                                      torch.from_numpy(y)))


def _jax_dp(n=8, cls=JaxDPTrainer, **kw):
    tcfg = _tcfg(jcfg, n, **kw)
    m = _mcfg(jcfg)
    if cls is JaxFSDPTrainer:
        tcfg = jcfg.TrainConfig(iters=1, global_batch=16,
                                mesh=jcfg.MeshConfig(fsdp=n),
                                collective=tcfg.collective,
                                optimizer=tcfg.optimizer)
    tr = cls(lambda p, b: jax_mlp.loss_fn(p, b, m), make_mesh(tcfg.mesh),
             tcfg)
    state = tr.init_state(jax.tree_util.tree_map(jnp.asarray,
                                                 _jax_params()))
    x, y = _batch()
    return tr, state, tr.shard_batch((jnp.asarray(x), jnp.asarray(y)))


def _flip_data_bit(step_dir, fname, byte_off=0):
    flip_stored_bit(os.path.join(step_dir, fname), byte_off=byte_off)


def _primary_files(step_dir):
    return sorted(f for f in os.listdir(step_dir)
                  if f.endswith(".npy") and not f.endswith(".m.npy"))


# ---------------------------------------------------------------------------
# JAX's tests/test_checkpoint.py cases, on the port
# ---------------------------------------------------------------------------

def test_compress_roundtrip_bound():
    x = np.random.default_rng(0).standard_normal((257, 33)).astype(
        np.float32)                                         # forces padding
    blob = ckpt.compress_array(x, config.BFPConfig())
    out = ckpt.decompress_array(blob)
    assert out.shape == x.shape and out.dtype == x.dtype
    packed = blob["mant"].size + blob["scale"].size
    assert packed < 0.3 * x.nbytes
    assert np.abs(out - x).max() < 2 ** -6 * np.abs(x).max() * 2


@pytest.mark.parametrize("rounding", ["nearest", "rtz"])
def test_compress_array_bits_equal_jax(rounding):
    x = (np.random.default_rng(1).standard_normal(4099) * 5).astype(
        np.float32)
    x[::31] = 0.0
    cfg = dict(block_size=16, mantissa_bits=8, rounding=rounding)
    got = ckpt.compress_array(x, config.BFPConfig(**cfg))
    want = jax_ckpt.compress_array(x, jcfg.BFPConfig(**cfg))
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)
    assert ckpt.decompress_array(got).tobytes() == \
        jax_ckpt.decompress_array(want).tobytes()


def test_checkpointer_save_restore(tmp_path):
    tr, state, batch = _dp()
    state, _ = tr.step(state, batch)
    c = ckpt.Checkpointer(str(tmp_path / "ck"))
    c.save(1, state)
    assert c.latest_step() == 1
    restored = c.restore(1)
    np.testing.assert_array_equal(restored["w_own"],
                                  state.w_own.reshape(-1).numpy())
    np.testing.assert_array_equal(restored["opt_state"]["m"],
                                  state.opt_state["m"].reshape(-1).numpy())
    assert restored["step"].dtype == np.int32 and restored["step"] == 1
    assert set(restored) == {"w_own", "opt_state", "step"}


def test_resume_continuity(tmp_path):
    """Save, restore, step: bit-equal to the uninterrupted run (the
    replicas are rebuilt by the step's own gather)."""
    tr, state, batch = _dp()
    state, _ = tr.step(state, batch)
    c = ckpt.Checkpointer(str(tmp_path / "ck"))
    c.save(1, state)
    state, _ = tr.step(state, batch)
    tr2, _, _ = _dp()
    state2 = tr2.restore_state(c.restore(1))
    state2, _ = tr2.step(state2, batch)
    assert torch.equal(state2.w_own, state.w_own)
    assert torch.equal(state2.replicas, state.replicas)
    assert state2.step == state.step == 2


def test_checkpointer_compressed(tmp_path):
    tr, state, _ = _dp()
    c = ckpt.Checkpointer(str(tmp_path / "ck"), compress=config.BFPConfig())
    c.save(2, state)
    restored = c.restore(2)
    w = state.w_own.reshape(-1).numpy()
    err = np.abs(restored["w_own"] - w).max()
    assert restored["w_own"].shape == w.shape
    assert err <= 2 ** -6 * max(np.abs(w).max(), 1e-9) * 2


def test_async_checkpointer_save_restore(tmp_path):
    tr, state, batch = _dp()
    state, _ = tr.step(state, batch)
    c = ckpt.Checkpointer(str(tmp_path / "ck"), async_save=True)
    c.save(3, state)
    w_saved = state.w_own.clone()
    state, _ = tr.step(state, batch)        # trains while the save commits
    c.wait_until_finished()
    assert c.latest_step() == 3
    restored = tr.restore_state(ckpt.Checkpointer(str(tmp_path / "ck"))
                                .restore(3))
    assert torch.equal(restored.w_own, w_saved) and restored.step == 1


def test_ddp_trainer_checkpoint_roundtrip(tmp_path):
    tr, state, batch = _dp(cls=DDPTrainer)
    state, _ = tr.step(state, batch)
    c = ckpt.Checkpointer(str(tmp_path / "ck"))
    c.save(1, state)
    payload = c.restore(1)
    assert payload["w_master"].shape == (state.w_master.shape[1],)
    tr2, _, _ = _dp(cls=DDPTrainer)
    restored = tr2.restore_state(payload)
    assert torch.equal(restored.w_master, state.w_master)
    assert torch.equal(restored.replicas, state.replicas)
    for a, b in zip(mlp_leaves(restored.params), mlp_leaves(state.params)):
        assert torch.equal(a, b)
    st2, loss = tr2.step(restored, batch)
    assert np.isfinite(float(loss))
    # diverged replicas cannot be stored as one vector
    bad = state._replace(w_master=state.w_master.clone())
    bad.w_master[3, 0] += 1.0
    with pytest.raises(ValueError, match="diverged"):
        c.save(2, bad)


def mlp_leaves(p):
    return [t for k in sorted(p) for t in p[k]]


def test_layout_sidecar_enforced(tmp_path):
    c = ckpt.Checkpointer(str(tmp_path / "ck"))
    layout = {"layers_order": "interleaved-device-major",
              "pp": 4, "virtual_stages": 2}
    c.save(1, {"w": np.ones(4, np.float32)}, layout=layout)
    assert c.saved_layout() == layout
    with pytest.raises(ValueError, match="sidecar"):
        c.restore(1)
    with pytest.raises(ValueError, match="virtual_stages"):
        c.restore(1, expect_layout=dict(layout, virtual_stages=4))
    out = c.restore(1, expect_layout=dict(layout))
    np.testing.assert_array_equal(out["w"], np.ones(4, np.float32))
    c2 = ckpt.Checkpointer(str(tmp_path / "ck2"))
    c2.save(1, {"w": np.ones(4, np.float32)})
    with pytest.raises(ValueError, match="no .*sidecar|model order"):
        c2.restore(1, expect_layout=layout)
    assert c2.restore(1)["w"].shape == (4,)


def test_legacy_directory_sidecar_honored_and_migrated(tmp_path):
    layout = {"layers_order": "interleaved-device-major",
              "pp": 2, "virtual_stages": 2}
    d = str(tmp_path / "ck")
    c = ckpt.Checkpointer(d)
    c.save(1, {"w": np.ones(2, np.float32)})
    with open(os.path.join(d, "layer_layout.json"), "w") as f:
        json.dump(layout, f)
    c2 = ckpt.Checkpointer(d)
    assert c2.saved_layout(1) == layout
    with pytest.raises(ValueError, match="sidecar"):
        c2.restore(1)
    np.testing.assert_array_equal(
        c2.restore(1, expect_layout=dict(layout))["w"],
        np.ones(2, np.float32))
    c2.save(2, {"w": np.zeros(2, np.float32)})
    assert not os.path.exists(os.path.join(d, "layer_layout.json"))
    assert c2.saved_layout(1) == layout
    assert c2.saved_layout(2) is None


def test_async_save_defers_layout_sidecar(tmp_path):
    layout = {"layers_order": "interleaved-device-major",
              "pp": 2, "virtual_stages": 2}
    c = ckpt.Checkpointer(str(tmp_path / "ck"), async_save=True)
    c.save(1, {"w": np.ones(2, np.float32)}, layout=layout)
    assert c.saved_layout(1) == layout
    c.wait_until_finished()
    assert c.saved_layout(1) == layout
    with pytest.raises(ValueError, match="sidecar"):
        c.restore(1)
    c.save(1, {"w": np.zeros(2, np.float32)})
    c.wait_until_finished()
    assert c.saved_layout(1) is None
    c._stage_sidecar(1, layout)
    c2 = ckpt.Checkpointer(str(tmp_path / "ck"), async_save=True)
    assert c2.saved_layout(1) == layout
    with pytest.raises(ValueError, match="sidecar"):
        c2.restore(1)
    np.testing.assert_array_equal(
        c2.restore(1, expect_layout=dict(layout))["w"],
        np.zeros(2, np.float32))


def test_layout_sidecar_cleared_by_plain_save(tmp_path):
    c = ckpt.Checkpointer(str(tmp_path / "ck"))
    layout = {"layers_order": "interleaved-device-major",
              "pp": 2, "virtual_stages": 2}
    c.save(1, {"w": np.ones(2, np.float32)}, layout=layout)
    c.save(2, {"w": np.zeros(2, np.float32)})
    assert c.saved_layout(2) is None and c.saved_layout() is None
    assert c.saved_layout(1) == layout
    with pytest.raises(ValueError, match="sidecar"):
        c.restore(1)
    c.save(1, {"w": np.full(2, 3.0, np.float32)})
    assert c.saved_layout(1) is None
    np.testing.assert_array_equal(c.restore(1)["w"],
                                  np.full(2, 3.0, np.float32))


def test_manifest_committed_with_step_and_audit_clean(tmp_path):
    c = ckpt.Checkpointer(str(tmp_path / "ck"))
    g = np.arange(300, dtype=np.float32)
    c.save(1, {"w": g, "step": np.int32(1)})
    man = c.read_manifest(1)
    assert man is not None and man["step"] == 1 and not man["emergency"]
    by_path = {tuple(e["path"]): e for e in man["leaves"]}
    assert by_path[("w",)]["checksum"] == bytes_checksum(g.tobytes())
    rep = c.audit_step(1)
    assert rep.ok and rep.restorable and rep.failures == []
    assert c.latest_step(verified=True) == 1


def test_single_bit_flip_every_leaf_refused_unmirrored(tmp_path):
    base = str(tmp_path / "base")
    c = ckpt.Checkpointer(base, compress=config.BFPConfig())
    g = np.linspace(-3, 3, 2048).astype(np.float32)
    c.save(1, {"w_own": g, "opt_state": {"m": g * 0.5},
               "step": np.int32(1)})
    files = _primary_files(c._path(1))
    assert len(files) >= 5
    for fname in files:
        d = str(tmp_path / f"flip_{fname}")
        shutil.copytree(base, d)
        c2 = ckpt.Checkpointer(d, compress=config.BFPConfig())
        _flip_data_bit(c2._path(1), fname)
        with pytest.raises(CheckpointIntegrityError, match="refusing"):
            c2.restore(1)
        assert c2.latest_step(verified=True) is None


def test_single_bit_flip_repaired_bit_exact_from_peer(tmp_path):
    base = str(tmp_path / "base")
    c = ckpt.Checkpointer(base, shards=4, mirror=True)
    g = np.arange(1024, dtype=np.float32)
    c.save(1, {"w": g})
    shard_files = [f for f in _primary_files(c._path(1)) if ".s" in f]
    assert len(shard_files) == 4
    for fname in shard_files:
        d = str(tmp_path / f"rep_{fname}")
        shutil.copytree(base, d)
        c2 = ckpt.Checkpointer(d, shards=4, mirror=True)
        _flip_data_bit(c2._path(1), fname)
        rep = c2.audit_step(1, repair=True)
        assert rep.restorable and len(rep.repaired) == 1
        assert rep.repair_wire_bytes == g.nbytes // 4
        np.testing.assert_array_equal(rep.tree["w"], g)
        assert c2.audit_step(1).ok
        np.testing.assert_array_equal(c2.restore(1)["w"], g)


def test_primary_and_mirror_both_corrupt_refuses(tmp_path):
    c = ckpt.Checkpointer(str(tmp_path / "ck"), shards=4, mirror=True)
    g = np.arange(1024, dtype=np.float32)
    c.save(1, {"w": g})
    _flip_data_bit(c._path(1), "leaf_00000.s02.npy")
    _flip_data_bit(c._path(1), "leaf_00000.s02.m.npy")
    with pytest.raises(CheckpointIntegrityError, match="also bad"):
        c.restore(1)


def test_stale_manifest_never_validates(tmp_path):
    c = ckpt.Checkpointer(str(tmp_path / "ck"))
    g = np.arange(64, dtype=np.float32)
    c.save(1, {"w": g})
    c.save(2, {"w": g + 1})
    shutil.copyfile(os.path.join(c._path(1), MANIFEST_FILE),
                    os.path.join(c._path(2), MANIFEST_FILE))
    assert c.read_manifest(2) is None
    assert c.latest_step(verified=True) == 1
    step, tree = c.restore_latest_verified()
    assert step == 1
    np.testing.assert_array_equal(tree["w"], g)


def test_peer_fetch_bit_exact_any_dtype():
    for arr in (np.arange(257, dtype=np.float32),
                np.arange(-8, 8, dtype=np.int8).reshape(4, 4),
                np.arange(6, dtype=np.int16)):
        landed, wire = peer_fetch(arr)
        np.testing.assert_array_equal(landed, arr)
        assert landed.dtype == arr.dtype and wire == arr.nbytes
        want, jwire = jax_ckpt.peer_fetch(arr)
        assert jwire == wire                  # JAX's byte accounting


class _SimCrash(Exception):
    """The sweep's injected mid-save process death."""


def _sweep_seed(d):
    c = ckpt.Checkpointer(d, shards=4, mirror=True, keep_last=1)
    g1 = np.arange(1024, dtype=np.float32)
    g2 = g1 * 2.0 + 1.0
    L1 = {"layers_order": "plain", "pp": 1}
    L2 = {"layers_order": "interleaved-device-major", "pp": 2}
    c.save(1, {"w": g1}, layout=L1)
    return c, (g1, L1), (g2, L2)


def test_crash_point_sweep_exhaustive(tmp_path):
    """The save of step 2 (over step 1, with a sidecar and retention GC)
    cut at every op prefix: a fresh Checkpointer restores exactly step 1
    or exactly step 2, bit-exact, with the matching sidecar, and a
    following save recovers over the leftovers."""
    ref, _, (g2, L2) = _sweep_seed(str(tmp_path / "ref"))
    kinds = []
    ref.op_hook = lambda i, op: kinds.append(op.kind)
    ref.save(2, {"w": g2}, layout=L2)
    n_ops = len(kinds)
    assert n_ops > 12 and "gc_guard" in kinds
    assert ref.latest_step(verified=True) == 2
    outcomes = set()
    for k in range(n_ops + 1):
        d = str(tmp_path / f"k{k:03d}")
        c, (g1, L1), _ = _sweep_seed(d)

        def hook(i, op, k=k):
            if i == k:
                raise _SimCrash()

        c.op_hook = hook
        try:
            c.save(2, {"w": g2}, layout=L2)
        except _SimCrash:
            pass
        c2 = ckpt.Checkpointer(d, shards=4, mirror=True, keep_last=1)
        step = c2.latest_step(verified=True)
        assert step in (1, 2), f"prefix {k}/{n_ops}: verified={step}"
        golden, layout = ((g1, L1) if step == 1 else (g2, L2))
        assert c2.saved_layout(step) == layout, f"prefix {k}"
        got_step, tree = c2.restore_latest_verified(
            expect_layout=dict(layout))
        assert got_step == step
        np.testing.assert_array_equal(tree["w"], golden)
        if step == 1:
            assert not os.path.isdir(c2._path(2)), f"prefix {k}"
        outcomes.add(step)
        c2.save(3, {"w": g2 + 1.0})
        assert c2.latest_step(verified=True) == 3, f"prefix {k}"
    assert outcomes == {1, 2}


def test_same_step_resave_crash_window_rolls_back(tmp_path):
    d = str(tmp_path / "ck")
    c = ckpt.Checkpointer(d)
    g = np.arange(128, dtype=np.float32)
    c.save(2, {"w": g})
    crash_at = []

    def hook(i, op):
        if op.kind == "replace" and op.path == c._path(2):
            crash_at.append(i)
        if crash_at and i == crash_at[0] + 1:
            raise _SimCrash()

    c.op_hook = hook
    with pytest.raises(_SimCrash):
        c.save(2, {"w": g + 99})
    c.op_hook = None
    assert os.path.isdir(c._path(2) + ".replaced")
    c2 = ckpt.Checkpointer(d)
    assert not os.path.isdir(c2._path(2) + ".replaced")
    assert not os.path.isdir(c2._tmp_path(2))
    step, tree = c2.restore_latest_verified()
    assert step == 2
    np.testing.assert_array_equal(tree["w"], g)
    c.save(2, {"w": g + 7})
    np.testing.assert_array_equal(c.restore(2)["w"], g + 7)


def test_keep_last_gc_bounds_directory(tmp_path):
    c = ckpt.Checkpointer(str(tmp_path / "ck"), keep_last=2)
    g = np.arange(64, dtype=np.float32)
    for s in range(1, 5):
        c.save(s, {"w": g + s})
    assert c._all_steps() == [3, 4]
    np.testing.assert_array_equal(c.restore(4)["w"], g + 4)


def test_gc_never_deletes_newest_verified_step(tmp_path):
    c = ckpt.Checkpointer(str(tmp_path / "ck"))
    g = np.arange(256, dtype=np.float32)
    for s in (1, 2, 3):
        c.save(s, {"w": g + s})
    _flip_data_bit(c._path(2), "leaf_00000.npy")
    _flip_data_bit(c._path(3), "leaf_00000.npy")
    c.keep_last = 1
    assert c.gc() == [2]
    assert c._all_steps() == [1, 3]
    step, tree = c.restore_latest_verified()
    assert step == 1
    np.testing.assert_array_equal(tree["w"], g + 1)


def test_save_time_gc_guard_aborts_on_lying_write(tmp_path):
    c = ckpt.Checkpointer(str(tmp_path / "ck"), keep_last=1)
    g = np.arange(256, dtype=np.float32)
    c.save(1, {"w": g})

    def hook(i, op):
        if op.kind == "gc_guard":
            _flip_data_bit(c._path(2), "leaf_00000.npy")

    c.op_hook = hook
    c.save(2, {"w": g + 2})
    c.op_hook = None
    assert c._all_steps() == [1, 2]
    step, tree = c.restore_latest_verified()
    assert step == 1
    np.testing.assert_array_equal(tree["w"], g)


def test_async_save_encodes_in_background_thread(tmp_path, monkeypatch):
    encode_threads = []
    orig = ckpt.compress_array

    def probe(x, cfg):
        encode_threads.append(threading.get_ident())
        return orig(x, cfg)

    monkeypatch.setattr(ckpt, "compress_array", probe)
    c = ckpt.Checkpointer(str(tmp_path / "ck"), compress=config.BFPConfig(),
                          async_save=True)
    g = np.arange(4096, dtype=np.float32)
    c.save(1, {"w_own": g, "opt_state": {"m": g}, "step": np.int32(1)})
    c.wait_until_finished()
    assert len(encode_threads) == 2
    assert all(t != threading.get_ident() for t in encode_threads)
    assert c.restore(1)["w_own"].shape == g.shape
    encode_threads.clear()
    cs = ckpt.Checkpointer(str(tmp_path / "ck2"), compress=config.BFPConfig())
    cs.save(1, {"w_own": g, "opt_state": {}, "step": np.int32(1)})
    assert encode_threads == [threading.get_ident()]
    assert set(cs.last_save) == {"pull_s", "encode_s", "checksum_s",
                                 "write_s"}


def test_async_save_background_error_reraised_at_sync(tmp_path):
    c = ckpt.Checkpointer(str(tmp_path / "ck"), async_save=True)

    def hook(i, op):
        raise OSError("injected ENOSPC")

    c.op_hook = hook
    c.save(1, {"w": np.arange(8, dtype=np.float32)})
    with pytest.raises(OSError, match="ENOSPC"):
        c.wait_until_finished()
    assert c.latest_step(verified=True) is None


def test_restore_latest_verified_refuses_when_nothing_clean(tmp_path):
    c = ckpt.Checkpointer(str(tmp_path / "ck"))
    c.save(1, {"w": np.arange(64, dtype=np.float32)})
    _flip_data_bit(c._path(1), "leaf_00000.npy")
    with pytest.raises(CheckpointIntegrityError, match="no verified"):
        c.restore_latest_verified()
    with pytest.raises(CheckpointIntegrityError, match="no verified"):
        ckpt.Checkpointer(str(tmp_path / "empty")).restore_latest_verified()


def test_elastic_restore_walks_back_and_repairs(tmp_path):
    tr, state, batch = _dp()
    state, _ = tr.step(state, batch)
    c = ckpt.Checkpointer(str(tmp_path / "ck"), shards=8, mirror=True)
    c.save(1, state)
    golden = state.w_own.reshape(-1).numpy().copy()
    shard = next(f for f in _primary_files(c._path(1)) if ".s" in f)
    _flip_data_bit(c._path(1), shard)
    step, tree = c.restore_latest_verified()
    assert step == 1
    np.testing.assert_array_equal(tree["w_own"], golden)
    restored = tr.restore_state(tree)
    np.testing.assert_array_equal(restored.w_own.reshape(-1).numpy(), golden)


def test_bytes_checksum_is_the_wire_plane_word_sum():
    r = np.random.default_rng(0)
    for n in (0, 1, 3, 4, 5, 1024, 4097):
        buf = r.integers(0, 256, n, dtype=np.uint8).tobytes()
        pad = (-len(buf)) % 4
        words = np.frombuffer(buf + b"\x00" * pad, "<u4")
        assert bytes_checksum(buf) == int(golden_word_checksum(words)), n
        assert bytes_checksum(buf) == jax_ckpt.bytes_checksum(buf), n
    big = r.integers(0, 256, 8 * 1024, dtype=np.uint8)
    whole = ckpt._u8_checksum(big)
    try:
        ckpt._CHK_CHUNK_WORDS = 128
        assert ckpt._u8_checksum(big) == whole
    finally:
        ckpt._CHK_CHUNK_WORDS = 1 << 22
    base = bytearray(r.integers(0, 256, 64, dtype=np.uint8).tobytes())
    ref = bytes_checksum(bytes(base))
    for off in (0, 1, 31, 63):
        for bit in (0, 7):
            mut = bytearray(base)
            mut[off] ^= (1 << bit)
            assert bytes_checksum(bytes(mut)) != ref, (off, bit)


def test_reserved_template_keys_rejected_at_save(tmp_path):
    c = ckpt.Checkpointer(str(tmp_path / "ck"))
    g = np.arange(8, dtype=np.float32)
    with pytest.raises(TypeError, match="reserved"):
        c.save(1, {"a": g, "b": {"__leaf__": 0}})
    with pytest.raises(TypeError, match="reserved"):
        c.save(1, {"nested": {"x": {"__tuple__": []}}})
    assert c.latest_step() is None


def test_one_save_interrupt_per_save(tmp_path):
    plan = chaos.FaultPlan(
        [chaos.FaultSpec("kill", "ckpt.save", step=0, fraction=0.2),
         chaos.FaultSpec("diskfull", "ckpt.save", step=0, fraction=0.2)])
    plan.begin_step(0)
    c = ckpt.Checkpointer(str(tmp_path / "ck"), chaos=plan)
    g = np.arange(64, dtype=np.float32)
    with pytest.raises(chaos.InjectedFault):
        c.save(1, {"w": g})
    assert len(plan.fired) == 1
    with pytest.raises(OSError):
        c.save(1, {"w": g})
    assert len(plan.fired) == 2
    c.save(1, {"w": g})
    np.testing.assert_array_equal(c.restore(1)["w"], g)


# ---------------------------------------------------------------------------
# cross-reads: each package restores the other's steps
# ---------------------------------------------------------------------------

def _files(step_dir):
    out = {}
    for f in sorted(os.listdir(step_dir)):
        with open(os.path.join(step_dir, f), "rb") as fh:
            out[f] = fh.read()
    return out


@pytest.mark.parametrize("layout", ["plain", "sharded_mirrored", "bfp"])
def test_trainer_state_files_equal_jax(tmp_path, layout):
    """The same momentum step's state, saved by each package: the same
    files byte for byte (manifest and its checksum included), and each
    package restores the other's step bit for bit."""
    kw = dict(plain={}, sharded_mirrored=dict(shards=8, mirror=True),
              bfp=dict(compress=True))[layout]
    comp = kw.pop("compress", False)
    jtr, js, jb = _jax_dp()
    # the masters of JAX's state, so both packages save the same values
    tr, st, _ = _dp()
    st = tr.restore_state({"w_own": np.asarray(js.w_own),
                           "opt_state": {"m": np.zeros_like(
                               np.asarray(js.w_own)) + 0.25},
                           "step": np.int32(3)})
    js = js._replace(opt_state={"m": jnp.zeros_like(js.w_own) + 0.25},
                     step=jnp.asarray(3, jnp.int32))
    pc = ckpt.Checkpointer(str(tmp_path / "p"),
                           compress=config.BFPConfig() if comp else None,
                           **kw)
    jc = jax_ckpt.Checkpointer(str(tmp_path / "j"),
                               compress=jcfg.BFPConfig() if comp else None,
                               **kw)
    pc.save(3, st)
    jc.save(3, js)
    pf, jf = _files(pc._path(3)), _files(jc._path(3))
    assert pf == jf
    assert pc.read_manifest(3)["self_checksum"] == \
        jc.read_manifest(3)["self_checksum"]
    # each restores the other's
    from_jax = ckpt.Checkpointer(str(tmp_path / "j"), **kw).restore(3) \
        if not comp else ckpt.Checkpointer(
            str(tmp_path / "j"), compress=config.BFPConfig()).restore(3)
    from_port = jax_ckpt.Checkpointer(str(tmp_path / "p"), **kw).restore(3) \
        if not comp else jax_ckpt.Checkpointer(
            str(tmp_path / "p"), compress=jcfg.BFPConfig()).restore(3)
    for a, b in ((from_jax, from_port),):
        assert a["w_own"].tobytes() == np.asarray(b["w_own"]).tobytes()
        assert a["opt_state"]["m"].tobytes() == \
            np.asarray(b["opt_state"]["m"]).tobytes()
        assert int(a["step"]) == int(b["step"]) == 3
    restored = tr.restore_state(from_jax)
    if not comp:
        assert torch.equal(restored.w_own, st.w_own)


def test_bf16_leaves_stored_as_jax_stores_them(tmp_path):
    """bfloat16 leaves, sharded and mirrored: the same files and manifest
    as JAX's (npy descr '<V2', "bfloat16" in the manifest), and the port
    restores JAX's step as torch.bfloat16, bit-exact.  JAX's own restore
    refuses such a step, its own as the port's, with the same audit
    (np.load reads '<V2' back as |V2: a dtype drift to JAX's audit)."""
    x = np.linspace(-3, 3, 2048).astype(np.float32)
    jtree = {"b": x.astype(ml_dtypes.bfloat16), "w": x.copy(),
             "step": np.int32(4)}
    ptree = {"b": torch.from_numpy(x).to(torch.bfloat16),
             "w": torch.from_numpy(x.copy()), "step": np.int32(4)}
    kw = dict(shards=4, mirror=True)
    jax_ckpt.Checkpointer(str(tmp_path / "j"), **kw).save(4, jtree)
    pc = ckpt.Checkpointer(str(tmp_path / "p"), **kw)
    pc.save(4, ptree)
    assert _files(pc._path(4)) == _files(
        jax_ckpt.Checkpointer(str(tmp_path / "j"))._path(4))
    got = ckpt.Checkpointer(str(tmp_path / "j"), **kw).restore(4)
    assert got["b"].dtype == torch.bfloat16
    assert torch.equal(got["b"].view(torch.int16),
                       ptree["b"].view(torch.int16))
    np.testing.assert_array_equal(got["w"], x)
    verdicts = []
    for d in ("j", "p"):
        rep = jax_ckpt.Checkpointer(str(tmp_path / d), **kw).audit_step(
            4, repair="probe")
        verdicts.append((rep.ok, rep.restorable,
                         sorted(f["reason"].split(" (")[0]
                                for f in rep.failures)))
    assert verdicts[0] == verdicts[1] and verdicts[0][1] is False


# ---------------------------------------------------------------------------
# restore_state on every trainer, against JAX's on the same payload
# ---------------------------------------------------------------------------

def _payload(n_stored, pad_to):
    """A stored dp=n_stored state: the momentum masters of JAX's layout
    at that width (live elements, zero padding), moments and step."""
    jtr, js, _ = _jax_dp(n_stored)
    w = np.asarray(js.w_own)
    m = np.where(np.arange(w.size) < pad_to, w * 0.5, 0).astype(np.float32)
    return {"w_own": w, "opt_state": {"m": m}, "step": np.int32(5)}


@pytest.mark.parametrize("n_stored,n", [(8, 8), (8, 4), (4, 8)])
def test_dp_restore_state_matches_jax(n_stored, n):
    """A checkpoint written at dp=n_stored restores at dp=n
    (``repad_flat``): the masters, moments and working params equal JAX's
    ``restore_state`` on the same payload, and the restored state takes
    a finite step."""
    total = sum(int(np.prod(s)) for s in
                [(16, 32), (32,), (32, 8), (8,)])
    payload = _payload(n_stored, total)
    jtr, _, _ = _jax_dp(n)
    jst = jtr.restore_state(payload)
    tr, _, batch = _dp(n)
    st = tr.restore_state(payload)
    np.testing.assert_array_equal(st.w_own.reshape(-1).numpy(),
                                  np.asarray(jst.w_own))
    np.testing.assert_array_equal(st.opt_state["m"].reshape(-1).numpy(),
                                  np.asarray(jst.opt_state["m"]))
    jp = jax.tree_util.tree_map(np.asarray, jst.params)
    for k in ("w", "b"):
        for a, b in zip(st.params[k], jp[k]):
            np.testing.assert_array_equal(a.numpy(), b)
    assert st.step == int(jst.step) == 5
    new, loss = tr.step(st, batch)
    assert np.isfinite(float(loss)) and new.step == 6


def test_ddp_restore_state_matches_jax():
    jtr, js, _ = _jax_dp(cls=JaxDDPTrainer)
    w = np.asarray(js.w_master) * 0.75
    payload = {"w_master": w, "opt_state": {"m": w * 0.1},
               "step": np.int32(2)}
    jst = jtr.restore_state(payload)
    tr, _, batch = _dp(cls=DDPTrainer)
    st = tr.restore_state(payload)
    for row in range(8):
        np.testing.assert_array_equal(st.w_master[row].numpy(),
                                      np.asarray(jst.w_master))
        np.testing.assert_array_equal(st.opt_state["m"][row].numpy(),
                                      np.asarray(jst.opt_state["m"]))
    jp = jax.tree_util.tree_map(np.asarray, jst.params)
    for k in ("w", "b"):
        for a, b in zip(st.params[k], jp[k]):
            np.testing.assert_array_equal(a.numpy(), b)
    assert st.step == int(jst.step) == 2
    _, loss = tr.step(st, batch)
    assert np.isfinite(float(loss))


@pytest.mark.parametrize("n_stored", [8, 4])
def test_fsdp_restore_state_matches_jax(n_stored):
    payload = _payload(n_stored, 16 * 32 + 32 + 32 * 8 + 8)
    jtr, _, _ = _jax_dp(cls=JaxFSDPTrainer, impl="ring")
    jst = jtr.restore_state(payload)
    tr, _, batch = _dp(cls=FSDPTrainer, impl="ring")
    st = tr.restore_state(payload)
    np.testing.assert_array_equal(st.w_own.reshape(-1).numpy(),
                                  np.asarray(jst.w_own))
    np.testing.assert_array_equal(st.opt_state["m"].reshape(-1).numpy(),
                                  np.asarray(jst.opt_state["m"]))
    assert st.step == int(jst.step) == 5 and st.codec_state is None
    # params_like instead of init_state
    tr2, _, _ = _dp(cls=FSDPTrainer, impl="ring")
    tr2._meta = None
    st2 = tr2.restore_state(payload, params_like=mlp.from_jax_params(
        _jax_params(), CPU))
    assert torch.equal(st2.w_own, st.w_own)
    _, loss = tr.step(st, batch)
    assert np.isfinite(float(loss))


PP_TP = jax_llama.LlamaConfig.tiny(n_layers=2)


def test_sharded_restore_state_matches_jax_tp_pp():
    """ShardedTrainer at dp=2 x tp=2 x pp=2: JAX's state saved by JAX's
    Checkpointer, restored by the port's (its ``P((tp, pp, ep, dp))``
    rows end to end); the masters equal JAX's restore_state's, and the
    whole params tree joined from the shard groups equals JAX's."""
    jc = PP_TP
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(2, 2, 1, 2),
                ("dp", "tp", "sp", "pp"))
    jt_cfg = jcfg.TrainConfig(global_batch=8,
                              mesh=jcfg.MeshConfig(dp=2, tp=2, pp=2),
                              collective=jcfg.CollectiveConfig(impl="xla"),
                              optimizer=jcfg.OptimizerConfig(kind="adamw"))
    jtr = JaxShardedTrainer(None, mesh, jt_cfg,
                            jax_llama.stacked_param_specs(
                                jc, pp_axis="pp", tp_axis="tp", tp_size=2),
                            pp_axis="pp")
    jflat = jax_llama.init(jax.random.PRNGKey(0), jc)
    js = jtr.init_state(jax_llama.stack_params(jflat))
    js = js._replace(opt_state={k: v + 0.5 for k, v in js.opt_state.items()},
                     step=jnp.asarray(7, jnp.int32))
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        jax_ckpt.Checkpointer(d, shards=2, mirror=True).save(7, js)
        payload = ckpt.Checkpointer(d, shards=2, mirror=True).restore(7)
    jst = jtr.restore_state(payload)
    pc = llama.LlamaConfig(**jc.__dict__)
    cfg = config.TrainConfig(global_batch=8,
                             mesh=config.MeshConfig(dp=2, tp=2, pp=2),
                             collective=config.CollectiveConfig(impl="xla"),
                             optimizer=config.OptimizerConfig(kind="adamw"))
    tr = ShardedTrainer(lambda p, b: None, make_ranks(cfg.mesh, "cpu"), cfg,
                        param_specs=llama.stacked_param_specs(
                            pc, tp_axis="tp", tp_size=2))
    params_like = llama.stack_params(llama.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jflat), "cpu"))
    st = tr.restore_state(payload, params_like=params_like)
    np.testing.assert_array_equal(st.w_own.reshape(-1).numpy(),
                                  np.asarray(jst.w_own))
    for k in jst.opt_state:
        np.testing.assert_array_equal(st.opt_state[k].reshape(-1).numpy(),
                                      np.asarray(jst.opt_state[k]))
    assert st.step == int(jst.step) == 7
    got = tr.global_params(st)
    want = jax.tree_util.tree_map(np.asarray, jst.params)
    flat_got = {"/".join(map(str, p)): t for p, t in
                _leaves_with_paths(got)}
    flat_want = {"/".join(map(str, p)): t for p, t in
                 _leaves_with_paths(want)}
    assert flat_got.keys() == flat_want.keys()
    for key, t in flat_got.items():
        np.testing.assert_array_equal(
            t.to(torch.float32).numpy(),
            np.asarray(flat_want[key]).astype(np.float32), err_msg=key)


def _leaves_with_paths(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_paths(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_paths(v, path + (i,))
    else:
        yield path, tree


def test_restore_state_needs_a_layout():
    tr = DPTrainer(lambda p, b: None, VirtualRanks(2, CPU),
                   _tcfg(config, 2))
    with pytest.raises(RuntimeError, match="layout"):
        tr.restore_state({"w_own": np.zeros(8, np.float32),
                          "opt_state": {}, "step": np.int32(0)})


# ---------------------------------------------------------------------------
# the drivers
# ---------------------------------------------------------------------------

def test_train_llama_save_read_by_both_generate_drivers(tmp_path):
    """``train_llama --save=`` on the CPU (dp=2), then JAX's
    ``examples/generate_llama.py --ckpt=`` and the port's on the saved
    step: equal continuations; the audit is clean; a sharded (tp)
    layout and an interleaved sidecar are refused."""
    d = str(tmp_path / "ck")
    out = train_llama.main(["--model=tiny", "--device=cpu",
                            "--model.vocab=384", "--model.attn_block=16",
                            "--seq=32", "--global_batch=4", "--mesh.dp=2",
                            "--iters=2", f"--save={d}"])
    assert out["checkpoint"].endswith("step_00000002")
    assert out["process"]["num_processes"] == 1
    assert ckpt.Checkpointer(d).audit_step(2).ok
    port = generate_llama.main(["--device=cpu", "--new=8",
                                "--prompt=the ring", f"--ckpt={d}"])
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run(
        [sys.executable, os.path.join(repo, "examples", "generate_llama.py"),
         "--new=8", "--prompt=the ring", f"--ckpt={d}"],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=repo))
    assert res.returncode == 0, res.stderr[-2000:]
    want = json.loads(res.stdout.strip().splitlines()[-1])
    assert port["continuation"] == want["continuation"]
    assert port["tokens"] == want["tokens"]
    # the random weights would continue otherwise
    assert port["continuation_ids"] != generate_llama.main(
        ["--device=cpu", "--new=8", "--prompt=the ring"])[
            "continuation_ids"]
    # a tp layout's rows are not the flat forward order: refused
    dt = str(tmp_path / "tp")
    train_llama.main(["--model=tiny", "--device=cpu", "--model.vocab=384",
                      "--model.attn_block=16", "--seq=32",
                      "--global_batch=4", "--mesh.dp=2", "--mesh.tp=2",
                      "--model.dim=256", "--iters=1", f"--save={dt}"])
    with pytest.raises(SystemExit, match="sharded"):
        generate_llama.main(["--device=cpu", "--new=2", f"--ckpt={dt}"])
    di = str(tmp_path / "il")
    out = train_llama.main([
        "--model=tiny", "--device=cpu", "--model.vocab=384",
        "--model.n_layers=4", "--model.attn_block=16", "--seq=32",
        "--global_batch=4", "--mesh.pp=2", "--microbatches=2",
        "--pp_schedule=1f1b-interleaved", "--iters=1", f"--save={di}"])
    assert out["checkpoint_layout"] == {
        "layers_order": "interleaved-device-major", "pp": 2,
        "virtual_stages": 2}
    with pytest.raises(ValueError, match="sidecar"):
        generate_llama.main(["--device=cpu", "--new=2", f"--ckpt={di}",
                             "--model.n_layers=4"])
