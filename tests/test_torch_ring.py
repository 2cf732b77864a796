"""The port's rings over virtual ranks against the bit spec and JAX.

The plain rings (``ops.ring``) and the fused-ring entry points
(``ops.ring_cuda``, which take their plain versions for CPU tensors) must
equal ``ops.ring_golden`` in both block layouts and the JAX ``ops.ring``
run under ``shard_map`` on n CPU devices, bit for bit.  The CUDA kernels
are held against their plain versions in tests/test_torch_cuda.py.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from fpga_ai_nic_tpu.ops import bfp_golden as jax_bfp_golden
from fpga_ai_nic_tpu.ops import ring as jax_ring
from fpga_ai_nic_tpu.ops import ring_golden as jax_ring_golden
from fpga_ai_nic_tpu.utils.config import BFPConfig as JaxBFPConfig
from fpga_ai_nic_tpu_torch import optim
from fpga_ai_nic_tpu_torch.ops import fused_update, ring, ring_cuda, ring_golden
from fpga_ai_nic_tpu_torch.utils.config import (BFPConfig, CollectiveConfig,
                                                OptimizerConfig)

TILE = 16 * 128
LAYOUTS = {"sublane": "pallas", "flat16": "xla"}


def _shards(n, C, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, n * C)) * 3).astype(np.float32)


def _jax_all_reduce(x, codec):
    n = x.shape[0]
    mesh = Mesh(jax.devices()[:n], ("dp",))
    cfg = JaxBFPConfig(codec=codec)
    out = jax.jit(jax.shard_map(
        lambda v: jax_ring.ring_all_reduce(v[0], "dp", compression=cfg)[None],
        mesh=mesh, in_specs=P("dp", None), out_specs=P("dp", None),
        check_vma=False))(jnp.asarray(x))
    return np.asarray(out)


def _jax_reduce_scatter(x, codec):
    n = x.shape[0]
    mesh = Mesh(jax.devices()[:n], ("dp",))
    cfg = JaxBFPConfig(codec=codec)
    out = jax.jit(jax.shard_map(
        lambda v: jax_ring.ring_reduce_scatter(v[0], "dp",
                                               compression=cfg)[None],
        mesh=mesh, in_specs=P("dp", None), out_specs=P("dp", None),
        check_vma=False))(jnp.asarray(x))
    return np.asarray(out)


@pytest.mark.parametrize("layout", ["sublane", "flat16"])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_rings_bitexact_vs_golden_and_jax(n, layout):
    cfg = BFPConfig(codec=LAYOUTS[layout])
    x = _shards(n, TILE, seed=n)
    rs = ring.ring_reduce_scatter(torch.from_numpy(x), cfg).numpy()
    want_rs = ring_golden.ring_reduce_scatter(x, cfg, layout)
    np.testing.assert_array_equal(rs, want_rs)
    np.testing.assert_array_equal(rs, jax_ring_golden.ring_reduce_scatter(
        x, JaxBFPConfig(), layout))
    np.testing.assert_array_equal(rs, _jax_reduce_scatter(x, cfg.codec))

    ag = ring.ring_all_gather(torch.from_numpy(want_rs), cfg).numpy()
    np.testing.assert_array_equal(
        ag, ring_golden.ring_all_gather(want_rs, cfg, layout))
    assert (ag == ag[0]).all()
    ar = ring.ring_all_reduce(torch.from_numpy(x), cfg).numpy()
    np.testing.assert_array_equal(ar, ring_golden.ring_all_reduce(
        x, cfg, layout))
    np.testing.assert_array_equal(ar, _jax_all_reduce(x, cfg.codec))
    if layout == "flat16":
        np.testing.assert_array_equal(ar, jax_ring_golden.ring_all_reduce(
            x, JaxBFPConfig()))


@pytest.mark.parametrize("n", [2, 4, 8])
def test_fused_entry_points_on_cpu_equal_golden(n):
    """ring_cuda's public functions, given CPU tensors, are the plain
    sublane rings whatever BFPConfig.codec says (as the TPU kernels)."""
    cfg = BFPConfig()                      # codec="xla": still sublane
    x = _shards(n, 2 * TILE, seed=10 + n)
    want_rs = ring_golden.ring_reduce_scatter(x, cfg, "sublane")
    got = ring_cuda.ring_reduce_scatter_fused(torch.from_numpy(x),
                                              compression=cfg)
    np.testing.assert_array_equal(got.numpy(), want_rs)
    ag = ring_cuda.ring_all_gather_fused(torch.from_numpy(want_rs),
                                         compression=cfg).numpy()
    np.testing.assert_array_equal(
        ag, ring_golden.ring_all_gather(want_rs, cfg, "sublane"))
    assert (ag == ag[0]).all()
    ar = ring_cuda.ring_all_reduce_fused(torch.from_numpy(x),
                                         compression=cfg).numpy()
    np.testing.assert_array_equal(
        ar, ring_golden.ring_all_reduce(x, cfg, "sublane"))


@pytest.mark.parametrize("kind", ["sgd", "momentum", "adamw"])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_reduce_scatter_update_bitexact_vs_composed_golden(n, kind):
    """fused_update.reduce_scatter_update under the slice's collective
    config == golden sublane ring -> golden_fused_apply, bit for bit."""
    coll = CollectiveConfig(impl="ring", compression=BFPConfig(
        codec="pallas"), fused_kernel=True, fused_optimizer=True)
    opt = OptimizerConfig(kind=kind, learning_rate=0.1, weight_decay=0.01)
    C = 2 * TILE
    x = _shards(n, C, seed=20 + n)
    rng = np.random.default_rng(n)
    w = rng.standard_normal((n, C)).astype(np.float32) * 0.1
    st = {k: np.abs(rng.standard_normal((n, C))).astype(np.float32) * 1e-3
          for k in optim.OptimizerSpec(kind=kind).state_keys}
    g, w2, st2 = fused_update.reduce_scatter_update(
        torch.from_numpy(x), torch.from_numpy(w),
        {k: torch.from_numpy(v) for k, v in st.items()}, 2, coll, opt)
    hyper = optim.fused_hyperparams(opt, 2).numpy()
    g_want = ring_golden.ring_reduce_scatter(x, coll.compression, "sublane")
    np.testing.assert_array_equal(g.numpy(), g_want)
    for i in range(n):
        w_want, st_want = optim.golden_fused_apply(
            kind, w[i], g_want[i], {k: v[i] for k, v in st.items()}, hyper,
            n)
        np.testing.assert_array_equal(w2[i].numpy(), w_want)
        for k in st_want:
            np.testing.assert_array_equal(st2[k][i].numpy(), st_want[k])


def _quad_mask(C, block, tile, quad):
    """Offsets inside a chunk of one quad column (4 lanes x block rows) of
    one (block, 128) tile: one thread's unit in the fused ring kernels."""
    mask = np.zeros(C, bool)
    base = tile * block * 128 + 4 * quad
    for r in range(block):
        mask[base + r * 128:base + r * 128 + 4] = True
    return mask


@pytest.mark.parametrize("collective", ["reduce_scatter", "all_gather"])
@pytest.mark.parametrize("n", [2, 3, 8])
def test_ring_outputs_depend_only_on_their_offset(n, collective):
    """The locality the one-launch ring kernels rest on: changing one quad
    column of one tile of one rank's chunk changes, through the golden and
    through the plain versions, only the outputs at that same offset of
    that chunk (g and w_new of the reduce-scatter + SGD; that slot of every
    replica of the gather), and nothing else.  The JAX package's golden
    gives the same outputs."""
    cfg = BFPConfig(codec="pallas")
    block, C = cfg.block_size, 3 * TILE
    opt = OptimizerConfig(kind="sgd", learning_rate=0.1, weight_decay=0.01)
    hyper = optim.fused_hyperparams(opt, 0)
    rng = np.random.default_rng(40 + n)
    rank, chunk = n - 1, (n + 1) // 2 % n
    mask = _quad_mask(C, block, tile=1, quad=5)

    if collective == "reduce_scatter":
        x = _shards(n, C, seed=30 + n)
        w = (rng.standard_normal((n, C)) * 0.1).astype(np.float32)
        x2 = x.copy()
        part = x2[rank, chunk * C:(chunk + 1) * C]
        part[mask] = part[mask] * 1e3 + 1

        def outs(v):
            g, w_new, _ = ring_cuda.ring_reduce_scatter_update_plain(
                torch.from_numpy(v), torch.from_numpy(w), {}, hyper,
                opt_kind="sgd", compression=cfg)
            want = ring_golden.ring_reduce_scatter(v, cfg, "sublane")
            np.testing.assert_array_equal(g.numpy(), want)
            np.testing.assert_array_equal(
                want, jax_ring_golden.ring_reduce_scatter(
                    v, JaxBFPConfig(), "sublane"))
            return [want, g.numpy(), w_new.numpy()]

        allowed = np.zeros((n, C), bool)
        allowed[chunk] = mask
    else:
        x = (rng.standard_normal((n, C)) * 3).astype(np.float32)
        x2 = x.copy()
        x2[rank, mask] = x2[rank, mask] * 1e3 + 1

        def outs(v):
            ag = ring_cuda.ring_all_gather_plain(torch.from_numpy(v), cfg)
            want = ring_golden.ring_all_gather(v, cfg, "sublane")
            np.testing.assert_array_equal(ag.numpy(), want)
            # the JAX golden's gather is flat16 only; its sublane bit spec
            # is each chunk's codec roundtrip in every replica
            slots = [jax_bfp_golden.bfp_decode(
                *jax_bfp_golden.bfp_encode(v[j], block, layout="sublane"),
                block, layout="sublane") for j in range(n)]
            np.testing.assert_array_equal(
                want, np.tile(np.concatenate(slots), (n, 1)))
            return [want, ag.numpy()]

        allowed = np.zeros((n, n, C), bool)
        allowed[:, rank] = mask
        allowed = allowed.reshape(n, n * C)

    for a, b in zip(outs(x), outs(x2)):
        changed = a != b
        assert not (changed & ~allowed).any()
        assert changed[allowed].any()
        if collective == "all_gather":
            assert (b == b[0]).all()


def test_sliced_hops_bitexact_vs_whole():
    """Slicing a hop changes the schedule only, never the bits."""
    cfg = BFPConfig(codec="pallas")
    x = torch.from_numpy(_shards(4, 4 * TILE, seed=3))
    whole = ring.ring_reduce_scatter(x, cfg)
    for s in (TILE, 2 * TILE, 3 * TILE, 16):   # 3*TILE, 16: not sliceable
        np.testing.assert_array_equal(
            ring.ring_reduce_scatter(x, cfg, slice_elems=s).numpy(),
            whole.numpy())
    assert ring_cuda.pick_slice_elems(4 * TILE, 8192, 16) == 4 * TILE
    assert ring_cuda.pick_slice_elems(6 * TILE, 8192, 16) == 3 * TILE
    assert ring_cuda.pick_slice_elems(7 * TILE, 8192, 16) == TILE


def test_padding_and_wire_bytes_match_jax():
    """For dp=8 at full width the flat MLP vector pads to the JAX
    package's length, and the declared wire bytes agree."""
    from fpga_ai_nic_tpu.ops import fused_update as jax_fu
    from fpga_ai_nic_tpu.utils.config import CollectiveConfig as JaxColl
    coll = CollectiveConfig(impl="ring", compression=BFPConfig(
        codec="pallas"), fused_kernel=True, fused_optimizer=True)
    jcoll = JaxColl(impl="ring", compression=JaxBFPConfig(codec="pallas"),
                    fused_kernel=True, fused_optimizer=True)
    tree = {"w": [np.empty((2048, 2048), np.float32)] * 10,
            "b": [np.empty((2048,), np.float32)] * 10}
    meta = fused_update.flat_meta(tree, coll, 8)
    assert sum(meta.sizes) == 41_963_520
    assert meta.padded_len == 41_975_808
    assert meta.padded_len // 8 == 5_246_976
    assert fused_update.pad_multiple(coll, 8) == jax_fu.pad_multiple(jcoll, 8)
    assert meta.keys[0] == ("b", 0) and meta.keys[10] == ("w", 0)
    for L, n in ((meta.padded_len, 8), (4 * TILE * 4, 4)):
        assert fused_update.wire_bytes_for(coll, L, n) == \
            jax_fu.wire_bytes_for(jcoll, L, n)
        assert fused_update.wire_bytes_for(coll, L, n, codec=None) == \
            jax_fu.wire_bytes_for(jcoll, L, n, codec=None)


def test_flatten_roundtrip_in_jax_order():
    coll = CollectiveConfig(impl="ring", compression=BFPConfig(),
                            fused_kernel=True)
    tree = {"w": [torch.arange(6.0).reshape(2, 3)], "b": [torch.ones(3)]}
    meta = fused_update.flat_meta(tree, coll, 2)
    flat = fused_update.flatten_tree(tree, meta)
    assert flat.shape == (2 * 16 * 128,) and flat[:4].tolist() == [1, 1, 1, 0]
    back = fused_update.unflatten_tree(flat, meta)
    assert torch.equal(back["w"][0], tree["w"][0])
    assert torch.equal(back["b"][0], tree["b"][0])
