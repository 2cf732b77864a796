"""The port's public helpers of ported modules against the JAX package's:

- ``ops/bfp.py``: ``bfp_ste`` (forward bit-equal to JAX's, gradient the
  incoming one; JAX's ``tests/test_bfp.py`` identity-gradient check) and
  ``pad_to_block``;
- ``ops/bfp_golden.py``: ``max_abs_error_bound`` bit-equal to JAX's golden,
  and the roundtrip bound of ``tests/test_bfp.py`` / ``test_runtime.py``;
- ``ops/bucketed.py``: ``all_reduce_bucketed`` is the dp mean
  (``tests/test_bert.py``'s atol), each leaf bit-equal to its segment of
  ``all_reduce_bucketed_flat`` cast to the leaf dtype, and equal to JAX's
  under ``shard_map`` on the 8-device CPU mesh;
- ``ops/fused_update.py``: ``all_reduce_mean`` and ``shard_slice`` against
  JAX's under ``shard_map`` on the 8-device CPU mesh;
- ``ops/ring_golden.py``: ``fused_allreduce_sgd`` bit-equal to JAX's;
- ``utils/observability.py``: ``CollectiveStats.record_latency``.
"""

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

from fpga_ai_nic_tpu.ops import bfp as jbfp
from fpga_ai_nic_tpu.ops import bfp_golden as jgolden
from fpga_ai_nic_tpu.ops import bucketed as jbucketed
from fpga_ai_nic_tpu.ops import fused_update as jfused
from fpga_ai_nic_tpu.ops import ring_golden as jring_golden
from fpga_ai_nic_tpu.parallel import make_mesh
from fpga_ai_nic_tpu.utils import config as jconfig
from fpga_ai_nic_tpu_torch.ops import bfp, bfp_golden, bucketed, fused_update
from fpga_ai_nic_tpu_torch.ops import ring_golden
from fpga_ai_nic_tpu_torch.utils.config import BFPConfig, CollectiveConfig
from fpga_ai_nic_tpu_torch.utils.observability import CollectiveStats


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _sample(rng, n=4096):
    x = (rng.standard_normal(n) * 3.0).astype(np.float32)
    x[::97] = 0.0
    x[5::131] *= np.float32(1e-39)          # subnormals
    x[11::103] = -np.float32(3.3e38)        # near fp32 max (finite)
    return x


# -- bfp_ste, pad_to_block --------------------------------------------------

@pytest.mark.parametrize("shape", [(4096,), (8, 512), (3, 5, 64)])
@pytest.mark.parametrize("mantissa_bits", [8, 4])
def test_bfp_ste_forward_equals_jax(rng, shape, mantissa_bits):
    x = _sample(rng, int(np.prod(shape))).reshape(shape)
    got = bfp.bfp_ste(torch.from_numpy(x), 16, mantissa_bits)
    want = np.asarray(jbfp.bfp_ste(jnp.asarray(x), 16, mantissa_bits))
    np.testing.assert_array_equal(got.numpy(), want)
    if mantissa_bits == 8:
        np.testing.assert_array_equal(
            got.numpy(),
            bfp.bfp_roundtrip(torch.from_numpy(x), BFPConfig()).numpy())


def test_bfp_ste_gradient_is_identity(rng):
    x = torch.from_numpy(rng.standard_normal(64).astype(np.float32))
    x.requires_grad_(True)
    q = bfp.bfp_ste(x)
    (q ** 2).sum().backward()
    # gradient flows straight through: d/dx sum(q(x)^2) == 2*q(x)
    np.testing.assert_array_equal(x.grad.numpy(), 2 * q.detach().numpy())
    jg = jax.grad(lambda v: jnp.sum(jbfp.bfp_ste(v) ** 2))(
        jnp.asarray(x.detach().numpy()))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg), rtol=1e-6)
    g_in = torch.from_numpy(rng.standard_normal(64).astype(np.float32))
    y = torch.zeros(64, requires_grad=True)
    bfp.bfp_ste(y).backward(g_in)
    assert torch.equal(y.grad, g_in)


def test_bfp_ste_bf16(rng):
    x = rng.standard_normal(256).astype(np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = bfp.bfp_ste(xt)
    assert got.dtype == torch.bfloat16
    want = jbfp.bfp_ste(jnp.asarray(x, jnp.bfloat16))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def test_pad_to_block():
    flat, pad = bfp.pad_to_block(torch.ones((7, 3)), 16)
    assert flat.shape[0] == 32 and pad == 11
    jflat, jpad = jbfp.pad_to_block(jnp.ones((7, 3)), 16)
    assert pad == jpad
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))
    flat, pad = bfp.pad_to_block(torch.arange(32.), 16)
    assert pad == 0 and flat.shape == (32,)


# -- max_abs_error_bound ------------------------------------------------------

@pytest.mark.parametrize("rounding", ["nearest", "rtz"])
@pytest.mark.parametrize("mantissa_bits", [8, 4])
def test_golden_roundtrip_error_bound(rng, rounding, mantissa_bits):
    x = _sample(rng)
    mant, se = bfp_golden.bfp_encode(x, 16, mantissa_bits, rounding)
    xhat = bfp_golden.bfp_decode(mant, se, 16)
    grid = bfp_golden.max_abs_error_bound(x, 16, mantissa_bits)
    np.testing.assert_array_equal(
        grid, jgolden.max_abs_error_bound(x, 16, mantissa_bits))
    factor = 0.5 if rounding == "nearest" else 1.0
    assert np.all(np.abs(x - xhat) <= (factor + 1.0) * grid + 1e-45)


def test_error_bound_covers_large_roundtrip(rng):
    x = rng.standard_normal(1 << 16).astype(np.float32)
    xhat = bfp.bfp_roundtrip(torch.from_numpy(x), BFPConfig()).numpy()
    assert np.all(np.abs(x - xhat) <= bfp_golden.max_abs_error_bound(x))


# -- all_reduce_bucketed -------------------------------------------------------

def _tree(rng, dtype=torch.float32):
    return {"a": torch.from_numpy(rng.standard_normal((8, 40, 7))
                                  .astype(np.float32)).to(dtype),
            "b": [torch.from_numpy(rng.standard_normal((8, 333))
                                   .astype(np.float32)).to(dtype),
                  torch.from_numpy(rng.standard_normal((8, 2, 3))
                                   .astype(np.float32)).to(dtype)]}


def _jax_tree(tree):
    return fused_update.tree_map(
        lambda t: jnp.asarray(t.float().numpy(),
                              jnp.bfloat16 if t.dtype == torch.bfloat16
                              else jnp.float32), tree)


def _shard_mapped(fn, tree, varying_out):
    mesh = make_mesh(jconfig.MeshConfig(dp=8))

    def run(t):
        out = fn(t)
        if varying_out:
            out = jax.tree_util.tree_map(
                lambda x: lax.pcast(x, "dp", to="varying"), out)
        return out

    return jax.jit(jax.shard_map(run, mesh=mesh, in_specs=(P("dp"),),
                                 out_specs=P("dp")))(tree)


def _leaves_np(tree):
    return [np.asarray(x, np.float32) for x in jax.tree_util.tree_leaves(tree)]


@pytest.mark.parametrize("impl", ["xla", "ring"])
def test_bucketed_all_reduce_is_mean(rng, impl):
    tree = _tree(rng)
    coll = CollectiveConfig(impl=impl, bucket_elems=500)
    got = bucketed.all_reduce_bucketed(tree, coll)
    for g, x in zip(fused_update.tree_leaves(got),
                    fused_update.tree_leaves(tree)):
        assert g.shape == x.shape and g.dtype == x.dtype
        want = np.broadcast_to(x.numpy().mean(axis=0, keepdims=True),
                               x.shape)
        np.testing.assert_allclose(g.numpy(), want, atol=1e-6)
    jcoll = jconfig.CollectiveConfig(impl=impl, bucket_elems=500)
    jgot = _shard_mapped(
        lambda t: jbucketed.all_reduce_bucketed(t, "dp", jcoll),
        _jax_tree(tree), impl == "xla")
    for g, w in zip(fused_update.tree_leaves(got), _leaves_np(jgot)):
        np.testing.assert_allclose(g.numpy(), w.reshape(g.shape), atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("compression", [None, BFPConfig(codec="pallas")])
def test_bucketed_leaves_are_flat_segments(rng, dtype, compression):
    tree = _tree(rng, dtype)
    coll = CollectiveConfig(impl="ring", bucket_elems=256,
                            compression=compression,
                            fused_kernel=compression is not None)
    plan = bucketed.plan_buckets(fused_update.per_rank_tree(tree), coll, 8)
    got = bucketed.all_reduce_bucketed(tree, coll, plan)
    leaves = fused_update.tree_leaves(tree)
    rows = bucketed.bucket_rows(plan, 8, "cpu")
    for r in range(8):
        bucketed.bucket_locals([leaf[r] for leaf in leaves], plan,
                               [row[r] for row in rows])
    flat = bucketed.all_reduce_bucketed_flat(rows, coll, plan)
    assert flat.dtype == torch.float32
    off = 0
    for g, x in zip(fused_update.tree_leaves(got), leaves):
        size = x[0].numel()
        want = flat[:, off:off + size].reshape(x.shape).to(dtype)
        assert g.dtype == dtype and torch.equal(g, want)
        off += size
    if dtype == torch.bfloat16 and compression is None:
        # the flat path is the more precise of the two (a BFP sum carries
        # 7 significant bits and /8 is exact, so bf16 holds it whole)
        assert not torch.equal(flat, fused_update.flatten_rows(
            got, fused_update.flat_meta(fused_update.per_rank_tree(tree),
                                        coll, 8))[:, :flat.shape[1]])


# -- all_reduce_mean, shard_slice ----------------------------------------------

@pytest.mark.parametrize("impl,compression", [
    ("xla", None), ("ring", None), ("ring", BFPConfig())])
def test_all_reduce_mean_equals_jax(rng, impl, compression):
    tree = _tree(rng)
    coll = CollectiveConfig(impl=impl, compression=compression)
    got = fused_update.all_reduce_mean(tree, coll)
    jcoll = jconfig.CollectiveConfig(
        impl=impl, compression=None if compression is None
        else jconfig.BFPConfig())
    jgot = _shard_mapped(lambda t: jfused.all_reduce_mean(t, "dp", jcoll),
                         _jax_tree(tree), impl == "xla")
    for g, x, w in zip(fused_update.tree_leaves(got),
                       fused_update.tree_leaves(tree), _leaves_np(jgot)):
        assert g.shape == x.shape and g.dtype == x.dtype
        assert bool((g == g[0]).all())          # every rank's row the same
        if impl == "ring":
            np.testing.assert_array_equal(g.numpy(), w.reshape(g.shape))
        else:
            np.testing.assert_allclose(g.numpy(), w.reshape(g.shape),
                                       atol=1e-6)
        if compression is None:
            np.testing.assert_allclose(
                g.numpy(), np.broadcast_to(x.numpy().mean(0, keepdims=True),
                                           x.shape), atol=1e-6)


def test_all_reduce_mean_fused_route_is_the_sublane_golden(rng):
    """With the fused BFP ring (the card's route, its plain versions
    here) the mean is the numpy ring golden's, sublane layout, / n."""
    cfg = BFPConfig(codec="pallas")
    coll = CollectiveConfig(impl="ring", compression=cfg, fused_kernel=True,
                            fused_optimizer=True)
    tree = {"w": torch.from_numpy(rng.standard_normal((8, 64, 256))
                                  .astype(np.float32))}
    got = fused_update.all_reduce_mean(tree, coll)
    meta = fused_update.flat_meta(fused_update.per_rank_tree(tree), coll, 8)
    rows = fused_update.flatten_rows(tree, meta).numpy()
    want = ring_golden.ring_all_reduce(rows, cfg, layout="sublane") / 8
    np.testing.assert_array_equal(
        got["w"].reshape(8, -1).numpy(), want[:, :64 * 256])


def test_shard_slice_equals_jax(rng):
    x = rng.standard_normal((8, 64)).astype(np.float32)
    got = fused_update.shard_slice(torch.from_numpy(x))
    mesh = make_mesh(jconfig.MeshConfig(dp=8))
    want = jax.jit(jax.shard_map(
        lambda v: jfused.shard_slice(v.reshape(-1), "dp")[None],
        mesh=mesh, in_specs=(P("dp"),), out_specs=P("dp")))(jnp.asarray(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.shape == (8, 8)


# -- fused_allreduce_sgd ----------------------------------------------------------

@pytest.mark.parametrize("compression", [None, BFPConfig()])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_fused_allreduce_sgd_equals_jax(rng, n, compression):
    L = n * 64
    g = rng.standard_normal((n, L)).astype(np.float32)
    w = rng.standard_normal(L).astype(np.float32)
    got = ring_golden.fused_allreduce_sgd(g, w, 0.1, compression)
    jcomp = None if compression is None else jconfig.BFPConfig()
    want = jring_golden.fused_allreduce_sgd(g, w, 0.1, jcomp)
    np.testing.assert_array_equal(got, want)
    assert (got == got[0]).all()


def test_fused_allreduce_sgd_sublane_is_the_update_of_the_ring(rng):
    cfg = BFPConfig(codec="pallas")
    g = rng.standard_normal((4, 4 * 2048)).astype(np.float32)
    w = rng.standard_normal(4 * 2048).astype(np.float32)
    got = ring_golden.fused_allreduce_sgd(g, w, 0.5, cfg, layout="sublane")
    owned = ring_golden.ring_reduce_scatter(g, cfg, "sublane")
    new = w.reshape(4, -1) - np.float32(0.5) * owned
    np.testing.assert_array_equal(
        got, ring_golden.ring_all_gather(new, cfg, "sublane"))


# -- record_latency --------------------------------------------------------------

def test_record_latency():
    s = CollectiveStats()
    s.record_latency(0.25)
    s.record_latency(0.5)
    s.record_latency(0.125)
    assert s.latency_sum_s == 0.875 and s.latency_max_s == 0.5
    assert s.completed == 0
    assert s.as_dict()["max_latency_ms"] == 500.0
