"""The auto codecs on the port: ``BFPConfig(codec="auto")`` and
``Int8Codec(backend="auto")`` against the JAX package's rule.

* The dispatch: the sublane kernels for a CUDA payload of whole (block,
  128)-lane tiles, flat16 otherwise and always on the CPU.  With JAX's
  ``_is_tpu`` forced true, JAX's ``use_pallas`` and ``sliceable`` on the
  same sizes are those of the port's codec pinned on a CUDA device; on
  the CPU JAX's and the port's both say flat16.
* ``for_payload`` pins one rank's payload, once a collective
  (``as_codec``); unpinned, auto encodes only on the CPU.  Auto pads a
  flat vector as flat16 does (JAX's ``pad_multiple``), so the payloads it
  decides on are JAX's.
* On the CPU auto's bits are "xla"'s: a codec roundtrip, the rings, and
  ``DPTrainer`` steps (separate-op and fused routes), for BFP and int8.
"""

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from fpga_ai_nic_tpu.compress import bfp as jax_cbfp
from fpga_ai_nic_tpu.compress import int8 as jax_cint8
from fpga_ai_nic_tpu.ops import bfp_pallas as jax_bfp_pl
from fpga_ai_nic_tpu.ops import fused_update as jax_fused
from fpga_ai_nic_tpu.utils import config as jcfg
from fpga_ai_nic_tpu_torch import compress
from fpga_ai_nic_tpu_torch.compress import bfp as cbfp
from fpga_ai_nic_tpu_torch.models import mlp
from fpga_ai_nic_tpu_torch.ops import fused_update, ring
from fpga_ai_nic_tpu_torch.parallel.mesh import VirtualRanks
from fpga_ai_nic_tpu_torch.parallel.train import DPTrainer
from fpga_ai_nic_tpu_torch.utils import config as tcfg

CUDA, CPU = torch.device("cuda"), torch.device("cpu")
SIZES = [16, 32, 1024, 2048, 2064, 4096, 6144, 8192, 10240, 20480]


def test_bfp_dispatch_at_tiling_and_other_sizes():
    cfg = tcfg.BFPConfig(codec="auto")
    assert cbfp.use_pallas(cfg, 2048)
    assert cbfp.use_pallas(cfg, 4096 * 5)
    assert not cbfp.use_pallas(cfg, 2064)
    assert not cbfp.use_pallas(cfg, 1024)
    assert cbfp.use_pallas(tcfg.BFPConfig(codec="pallas"), 16)
    assert not cbfp.use_pallas(tcfg.BFPConfig(codec="xla"), 2048)
    c = cbfp.BFPCodec(cfg)
    assert c.for_payload(2048, CUDA).cfg.codec == "pallas"
    assert c.for_payload(2064, CUDA).cfg.codec == "xla"
    assert c.for_payload(2048, CPU).cfg.codec == "xla"
    assert c.for_payload(2048, CUDA).unit_elems(2048) == 2048
    assert c.unit_elems(2048) == 16       # flat16's padding, JAX's
    # a collective pins once, on one rank's chunk; unpinned, "auto"
    # encodes only on the CPU
    assert compress.as_codec(cfg, 2048, CUDA).cfg.codec == "pallas"
    assert compress.as_codec(cfg).cfg.codec == "auto"
    assert c._layout(CPU).codec == "xla"
    with pytest.raises(ValueError, match="pin it"):
        c._layout(CUDA)


def test_int8_dispatch_at_tiling_and_other_sizes():
    c = compress.Int8Codec(backend="auto", rounding="nearest")
    assert c.for_payload(2048, CUDA).backend == "pallas"
    assert c.for_payload(2048 * 3, CUDA).backend == "pallas"
    assert c.for_payload(2064, CUDA).backend == "xla"
    assert c.for_payload(2048, CPU).backend == "xla"
    assert c.for_payload(2048, CUDA).rounding == "nearest"
    assert c.unit_elems(2048) == 16
    with pytest.raises(ValueError, match="pin it"):
        compress.base.check_pinned(c.name, CUDA)
    compress.base.check_pinned(c.name, CPU)


def test_dispatch_and_slicing_match_jax_rule(monkeypatch):
    """With JAX's ``_is_tpu`` forced true, JAX's auto rule is the port's on
    a CUDA device; off a TPU JAX's is flat16, as the port's on the CPU."""
    jb = jax_cbfp.BFPCodec(jcfg.BFPConfig(codec="auto"))
    ji = jax_cint8.Int8Codec(backend="auto")
    pb = cbfp.BFPCodec(tcfg.BFPConfig(codec="auto"))
    pi = compress.Int8Codec(backend="auto")
    for n in SIZES:
        assert not jax_cbfp.use_pallas(jb.cfg, n)
        assert pb.for_payload(n, CPU).cfg.codec == "xla"
        assert not ji._use_pallas(n)
        assert pi.for_payload(n, CPU).backend == "xla"
        for sl in SIZES:
            assert jb.sliceable(n, sl) == pb.for_payload(
                n, CPU).sliceable(n, sl), (n, sl)
            assert ji.sliceable(n, sl) == pi.for_payload(
                n, CPU).sliceable(n, sl), (n, sl)
    monkeypatch.setattr(jax_bfp_pl, "_is_tpu", lambda: True)
    for n in SIZES:
        assert jax_cbfp.use_pallas(jb.cfg, n) == (
            pb.for_payload(n, CUDA).cfg.codec == "pallas"), n
        assert ji._use_pallas(n) == (
            pi.for_payload(n, CUDA).backend == "pallas"), n
        # pinned on the chunk, its slices take the chunk's layout, and
        # they slice where JAX's per-slice rule does
        for sl in SIZES:
            assert jb.sliceable(n, sl) == pb.for_payload(
                n, CUDA).sliceable(n, sl), (n, sl)
            assert ji.sliceable(n, sl) == pi.for_payload(
                n, CUDA).sliceable(n, sl), (n, sl)


@pytest.mark.parametrize("n", [8, 2])
@pytest.mark.parametrize("codec", ["bfp", "int8"])
def test_auto_pads_as_jax_flat_route(n, codec):
    kw = (dict(compression=tcfg.BFPConfig(codec="auto")) if codec == "bfp"
          else dict(codec="int8", codec_opts=(("backend", "auto"),)))
    jkw = (dict(compression=jcfg.BFPConfig(codec="auto")) if codec == "bfp"
           else dict(codec="int8", codec_opts=(("backend", "auto"),)))
    pc = tcfg.CollectiveConfig(impl="ring", **kw)
    jc = jcfg.CollectiveConfig(impl="ring", **jkw)
    assert fused_update.pad_multiple(pc, n) == jax_fused.pad_multiple(jc, n)
    if codec == "bfp":
        pf = tcfg.CollectiveConfig(impl="ring", fused_kernel=True, **kw)
        jf = jcfg.CollectiveConfig(impl="ring", fused_kernel=True, **jkw)
        assert fused_update.pad_multiple(pf, n) == \
            jax_fused.pad_multiple(jf, n)


@pytest.mark.parametrize("codec", ["bfp", "int8"])
def test_cpu_auto_bits_equal_xla_codec_and_rings(codec):
    rng = np.random.default_rng(0)
    n, C = 4, 4096
    x = torch.from_numpy(rng.standard_normal((n, n * C)).astype(np.float32))
    if codec == "bfp":
        auto = cbfp.BFPCodec(tcfg.BFPConfig(codec="auto"))
        xla = cbfp.BFPCodec(tcfg.BFPConfig(codec="xla"))
    else:
        auto = compress.Int8Codec(backend="auto")
        xla = compress.Int8Codec(backend="xla")
    flat = x.reshape(-1)
    for a, b in zip(auto.encode(flat), xla.encode(flat)):
        assert torch.equal(a, b)
    assert torch.equal(auto.roundtrip(flat), xla.roundtrip(flat))
    assert torch.equal(ring.ring_all_reduce(x, auto, slice_elems=1024),
                       ring.ring_all_reduce(x, xla, slice_elems=1024))
    assert torch.equal(ring.ring_all_gather(x[:, :C], auto),
                       ring.ring_all_gather(x[:, :C], xla))


MCFG = tcfg.MLPConfig(layer_sizes=(64, 128, 128, 32))


def _train(coll, n=4, steps=2):
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((32, 64)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 32, 32))
    cfg = tcfg.TrainConfig(global_batch=32, mesh=tcfg.MeshConfig(dp=n),
                           collective=coll, optimizer=tcfg.OptimizerConfig(
                               kind="sgd", learning_rate=0.1))
    tr = DPTrainer(lambda p, b: mlp.loss_fn(p, b, MCFG),
                   VirtualRanks(n, CPU), cfg)
    st = tr.init_state(mlp.init(torch.Generator().manual_seed(0), MCFG,
                                "cpu"))
    for _ in range(steps):
        st, _ = tr.step(st, tr.shard_batch((x, y)))
    return st.w_own


@pytest.mark.parametrize("route", ["ring", "fused"])
def test_cpu_dp_trainer_auto_equals_xla(route):
    kw = (dict(fused_kernel=True, fused_optimizer=True) if route == "fused"
          else {})
    a = _train(tcfg.CollectiveConfig(
        impl="ring", compression=tcfg.BFPConfig(codec="auto"), **kw))
    b = _train(tcfg.CollectiveConfig(
        impl="ring", compression=tcfg.BFPConfig(codec="xla"), **kw))
    assert torch.equal(a, b)
    if route == "ring":
        ia = _train(tcfg.CollectiveConfig(
            impl="ring", codec="int8", codec_opts=(("backend", "auto"),)))
        ib = _train(tcfg.CollectiveConfig(
            impl="ring", codec="int8", codec_opts=(("backend", "xla"),)))
        assert torch.equal(ia, ib)
