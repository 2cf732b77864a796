"""The model drivers with their ranks as processes, on the CPU: three
processes over gloo (``CUDA_VISIBLE_DEVICES=""``, the CPU asked for, one
intra-op thread each as in this process), the hops' plain versions.

- (a) the shared-buffer ring (``ops.ring_procs``) through ``LoopbackPorts``:
  the all-reduce (the reduce-scatter without an update, then the
  all-gather of the owned sum) bit-equal to
  ``ring_cuda.ring_all_reduce_fused``'s plain route, and two wires of
  different chunks over one pair of buffers, each equal to the golden;
- (b) one spawn of three processes runs every driver's path
  (``procs.drivers``): ``train_bert``'s ``DDPTrainer`` (tiny BERT, BFP
  buckets of two sizes, AdamW), ``train_llama``'s ``ShardedTrainer``
  (tiny Llama, BFP, SGD) and ``train_resnet``'s sync-BN ``DPTrainer``
  (tiny ResNet, BFP, fused momentum SGD) bit-equal to the one-process
  trainer at dp=3 (losses, every master and replica row's sha256 after
  every step; sync-BN's tolerance is 0: both pool in rank order), and
  sync-BN's fault control (each process its own moments) above it;
  ``ShardedTrainer(loss_and_grads_fn=)`` across processes bit-equal to
  the autograd route in one process; the
  same three with the raw f32 ring from JAX's weights against JAX's
  trainers on the CPU mesh at dp=3, at the tolerances of
  ``test_torch_ddp.py``, ``test_torch_resnet.py`` and
  ``test_torch_llama_train.py``;
- (c) each driver's ``main`` under the group: every process's JSON
  carries ``process`` and the losses agree.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import jax
import jax.numpy as jnp

from fpga_ai_nic_tpu.models import bert as jax_bert
from fpga_ai_nic_tpu.models import llama as jax_llama
from fpga_ai_nic_tpu.models import resnet as jax_resnet
from fpga_ai_nic_tpu.parallel import DDPTrainer as JaxDDPTrainer
from fpga_ai_nic_tpu.parallel import DPTrainer as JaxDPTrainer
from fpga_ai_nic_tpu.parallel import ShardedTrainer as JaxShardedTrainer
from fpga_ai_nic_tpu.parallel import make_mesh
from fpga_ai_nic_tpu.utils import config as jcfg
from fpga_ai_nic_tpu_torch import train_bert, train_llama, train_resnet
from fpga_ai_nic_tpu_torch.ops import ring_cuda, ring_golden, ring_procs
from fpga_ai_nic_tpu_torch.parallel import procs
from fpga_ai_nic_tpu_torch.utils.config import BFPConfig

W = 3
SUBLANE = BFPConfig(codec="pallas")
ENV = {"CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1"}
TIMEOUT_S = 240.0
# sync-BN across processes against one process: both sum the pooled
# moments' cotangents in rank order (resnet.RankMoments, ProcessMoments),
# so the masters agree bit for bit (while one graph's autograd summed them,
# 1.2e-7 apart at |w| < 2); each process's own moments move them 0.24
SYNC_BN_ATOL = 0.0
SYNC_BN_CONTROL_MIN = 1e-3

BERT_BFP = ["--model=tiny", "--seq=32", "--pad-min=16", "--bfp=1",
            f"--mesh.dp={W}", f"--global_batch={2 * W}",
            "--collective.bucket_elems=4096"]
RESNET_BFP = ["--model=tiny", "--image-size=16", f"--mesh.dp={W}",
              f"--global_batch={2 * W}", "--bfp=1",
              "--collective.fused_optimizer=true",
              "--optimizer.kind=momentum", "--optimizer.learning_rate=0.1",
              "--optimizer.momentum=0.9", "--optimizer.weight_decay=1e-4"]
LLAMA_BFP = ["--model=tiny", "--model.attn_block=16", "--seq=32",
             f"--global_batch={W}", f"--mesh.dp={W}", "--collective.impl=ring",
             "--collective.compression.codec=pallas",
             "--collective.fused_kernel=true", "--optimizer.kind=sgd",
             "--optimizer.learning_rate=0.1"]
# the JAX comparisons: the raw f32 ring, JAX's weights, the tests' models
BERT_F32 = ["--model=tiny", "--seq=32", "--pad-min=28",
            f"--mesh.dp={W}", f"--global_batch={2 * W}",
            "--collective.impl=ring", "--collective.bucket_elems=4096",
            "--optimizer.kind=sgd", "--optimizer.learning_rate=0.1",
            "--optimizer.weight_decay=0.0"]
RESNET_F32 = [a for a in RESNET_BFP if a != "--bfp=1"] + [
    "--collective.impl=ring"]
LLAMA_F32 = ["--model=tiny", "--model.attn_block=128",
             "--model.attn_impl=pallas", "--seq=128",
             f"--global_batch={W}", f"--mesh.dp={W}", "--collective.impl=ring",
             "--optimizer.kind=sgd", "--optimizer.learning_rate=0.1"]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _jax_weights():
    return {"bert": _np(jax_bert.init(jax.random.PRNGKey(0),
                                      jax_bert.BertConfig.tiny())),
            "resnet": _np(jax_resnet.init(jax.random.PRNGKey(0),
                                          jax_resnet.ResNetConfig.tiny())),
            "llama": _np(jax_llama.init(jax.random.PRNGKey(2), dataclasses.
                                        replace(jax_llama.LlamaConfig.tiny(),
                                                attn_block=128)))}


def _specs():
    w = _jax_weights()
    cpu = {"device": "cpu"}
    return {
        "bert": dict(cpu, driver="bert", argv=BERT_BFP),
        "resnet": dict(cpu, driver="resnet", argv=RESNET_BFP, masters=True),
        "resnet_control": dict(cpu, driver="resnet", argv=RESNET_BFP,
                               masters=True, sync_bn=False),
        "llama": dict(cpu, driver="llama", argv=LLAMA_BFP),
        "llama_explicit": dict(cpu, driver="llama", argv=LLAMA_BFP,
                               explicit_grads=True),
        "bert_jax": dict(cpu, driver="bert", argv=BERT_F32, masters=True,
                         params=w["bert"]),
        "resnet_jax": dict(cpu, driver="resnet", argv=RESNET_F32,
                           masters=True, params=w["resnet"]),
        "llama_jax": dict(cpu, driver="llama", argv=LLAMA_F32, masters=True,
                          params=w["llama"], steps=2)}


@pytest.fixture(scope="module")
def runs():
    """Every spec across W processes (one spawn) and in this process."""
    specs = _specs()
    names = list(specs)
    res = procs.spawn(procs.drivers, W, ([specs[k] for k in names],),
                      timeout=TIMEOUT_S, env=ENV)
    return {k: ([r[i] for r in res], procs.driver_run(0, 1, specs[k]))
            for i, k in enumerate(names)}


# -- (a) the shared-buffer ring ------------------------------------------------

def _loopback_all_reduce(rings, x, wire):
    """Every rank's all-reduce through loopback ports, a launch of every
    rank before the next launch."""
    n = len(rings)
    g = [None] * n
    for k in range(n):
        for r in range(n):
            out = rings[r].rs_launch(k, x[r], wire=wire)
            if out is not None:
                g[r] = out[0]
    reps = [torch.empty(n * wire.C) for _ in range(n)]
    for k in range(n):
        for r in range(n):
            rings[r].ag_launch(k, g[r], reps[r], wire=wire)
    return torch.stack(reps)


@pytest.mark.parametrize("cfg", [SUBLANE, None], ids=["bfp", "f32"])
def test_all_reduce_equals_fused_plain_route(cfg):
    C = 16 * 128 * 2
    rng = np.random.default_rng(3)
    x = torch.from_numpy((rng.standard_normal((W, W * C)) * 3)
                         .astype(np.float32))
    wire = ring_procs.wire_for(C, cfg)
    ports = ring_procs.LoopbackPorts(W, wire.frame_bytes)
    rings = [ring_procs.ProcRing(r, W, wire, ports.port(r))
             for r in range(W)]
    got = _loopback_all_reduce(rings, x, wire)
    if cfg is None:
        want = torch.from_numpy(ring_golden.ring_all_gather(
            ring_golden.ring_reduce_scatter(x.numpy(), None, "sublane"),
            None, "sublane"))
    else:
        want = ring_cuda.ring_all_reduce_fused(x, compression=cfg)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("cfg", [SUBLANE, None], ids=["bfp", "f32"])
def test_two_bucket_sizes_over_one_buffer(cfg):
    """A small and a large wire through ports sized once for the larger
    frame, in both orders: each all-reduce equals the golden
    composition; a frame larger than the buffers is refused."""
    small = ring_procs.wire_for(16 * 128, cfg)
    large = ring_procs.wire_for(16 * 128 * 5, cfg)
    ports = ring_procs.LoopbackPorts(W, large.frame_bytes)
    rings = [ring_procs.ProcRing(r, W, small, ports.port(r))
             for r in range(W)]
    rng = np.random.default_rng(4)
    for wire in (small, large, small):
        x = (rng.standard_normal((W, W * wire.C)) * 2).astype(np.float32)
        got = _loopback_all_reduce(rings, torch.from_numpy(x), wire)
        want = ring_golden.ring_all_gather(
            ring_golden.ring_reduce_scatter(x, cfg, "sublane"), cfg,
            "sublane")
        np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="does not fit"):
        rings[0].all_reduce(torch.zeros(W * 16 * 128 * 6),
                            ring_procs.wire_for(16 * 128 * 6, cfg))


# -- (b) the drivers across processes ------------------------------------------

@pytest.mark.parametrize("name", ["bert", "llama", "resnet"])
def test_driver_bitequal_to_one_process(runs, name):
    got, want = runs[name]
    assert want["rows"] == W
    for r, g in enumerate(got):
        assert g["device"] == "cpu" and g["rows"] == 1
        assert g["losses"] == want["losses"]
        assert g["masters"] == [[d[r]] for d in want["masters"]]
        assert g["replicas"] == [[d[r]] for d in want["replicas"]]
        assert set(g["launches"].values()) == {0}      # plain versions
        if name != "resnet":
            assert g["exchanges"] == [0] * len(want["losses"])


def test_explicit_grads_across_processes(runs):
    """``ShardedTrainer(loss_and_grads_fn=)`` at dp across processes (the
    hook a rank at a time) bit-equal to the autograd route in one
    process."""
    got, _ = runs["llama_explicit"]
    _, want = runs["llama"]
    for r, g in enumerate(got):
        assert g["losses"] == want["losses"]
        assert g["masters"] == [[d[r]] for d in want["masters"]]
        assert g["replicas"] == [[d[r]] for d in want["replicas"]]


def _bn_layers(stage_sizes=(1, 1)):
    """BN layers a forward: the stem's, three a block, a projection's on
    each stage's first block."""
    return 1 + sum(3 * n + 1 for n in stage_sizes)


def test_sync_bn_within_tolerance_control_above(runs):
    """The masters within SYNC_BN_ATOL (0) of one process's, two exchanges
    a BN layer and step; each process's own moments (the control) change
    the first forward and land above SYNC_BN_CONTROL_MIN."""
    got, want = runs["resnet"]
    ctl, _ = runs["resnet_control"]
    w_ref = np.concatenate(want["w_final"])
    for g in got:
        assert g["exchanges"] == [2 * _bn_layers()] * len(want["losses"])
    w_got = np.concatenate([g["w_final"][0] for g in got])
    w_ctl = np.concatenate([g["w_final"][0] for g in ctl])
    assert np.abs(w_got - w_ref).max() <= SYNC_BN_ATOL
    assert np.abs(w_ctl - w_ref).max() > SYNC_BN_CONTROL_MIN
    assert all(g["exchanges"] == [0] * 3 for g in ctl)
    assert ctl[0]["losses"][0] != want["losses"][0]


def test_bert_ddp_matches_jax(runs):
    """``test_torch_ddp.py``'s tolerance: losses within rtol 1e-5, the
    masters within rtol 2e-4 / atol 2e-5 of JAX's ``DDPTrainer`` (the raw
    f32 ring, 3 ranks, SGD lr 0.1)."""
    got, _ = runs["bert_jax"]
    mcfg, cfg, run = train_bert.parse(BERT_F32)
    jc = jcfg.TrainConfig(
        global_batch=cfg.global_batch, mesh=jcfg.MeshConfig(dp=W),
        collective=jcfg.CollectiveConfig(impl="ring", bucket_elems=4096),
        optimizer=jcfg.OptimizerConfig(kind="sgd", learning_rate=0.1))
    jm = jax_bert.BertConfig.tiny()
    jtr = JaxDDPTrainer(lambda p, b: jax_bert.loss_fn(p, b, jm, dp_axis="dp"),
                        make_mesh(jc.mesh), jc)
    js = jtr.init_state(jax.tree_util.tree_map(jnp.asarray,
                                               _jax_weights()["bert"]))
    for step, (b, _) in enumerate(train_bert.batches(mcfg, cfg, run, 3)):
        js, jl = jtr.step(js, jtr.shard_batch((jnp.asarray(b[0].numpy()),
                                               jnp.asarray(b[1].numpy()))))
        for g in got:
            np.testing.assert_allclose(g["losses"][step], float(jl),
                                       rtol=1e-5)
    for g in got:
        np.testing.assert_allclose(g["w_final"][0], np.asarray(js.w_master),
                                   rtol=2e-4, atol=2e-5)


def test_resnet_sync_bn_matches_jax(runs):
    """``test_torch_resnet.py``'s tolerance: losses within rtol 1e-5, the
    masters within 1e-6 of JAX's sync-BN ``DPTrainer`` (the raw f32 ring,
    the fused momentum update, 3 ranks)."""
    got, _ = runs["resnet_jax"]
    mcfg, cfg, size, _ = train_resnet.parse(RESNET_F32)
    jc = jcfg.TrainConfig(
        global_batch=cfg.global_batch, mesh=jcfg.MeshConfig(dp=W),
        collective=jcfg.CollectiveConfig(impl="ring", fused_optimizer=True),
        optimizer=jcfg.OptimizerConfig(kind="momentum", learning_rate=0.1,
                                       momentum=0.9, weight_decay=1e-4))
    jm = jax_resnet.ResNetConfig.tiny()
    jtr = JaxDPTrainer(lambda p, b: jax_resnet.loss_fn(p, b, jm,
                                                       bn_axis="dp"),
                       make_mesh(jc.mesh), jc)
    js = jtr.init_state(jax.tree_util.tree_map(jnp.asarray,
                                               _jax_weights()["resnet"]))
    for step, (x, y) in enumerate(train_resnet.batches(mcfg, cfg, size, 3)):
        js, jl = jtr.step(js, jtr.shard_batch(
            (jnp.asarray(x.numpy()), jnp.asarray(y.numpy()))))
        for g in got:
            np.testing.assert_allclose(g["losses"][step], float(jl),
                                       rtol=1e-5)
    jw = np.asarray(js.w_own).reshape(W, -1)
    for r, g in enumerate(got):
        np.testing.assert_allclose(g["w_final"][0], jw[r], rtol=0, atol=1e-6)


def test_llama_sharded_matches_jax(runs):
    """``test_torch_llama_train.py``'s tolerance: two steps, losses within
    rtol 1e-5, the masters within 1e-6 of JAX's ``ShardedTrainer``
    (``impl="xla"``: its exact sums; the port's raw f32 ring sums in ring
    order)."""
    got, _ = runs["llama_jax"]
    mcfg, cfg, seq, _ = train_llama.parse(LLAMA_F32)
    jm = dataclasses.replace(jax_llama.LlamaConfig.tiny(), attn_block=128,
                             attn_impl="xla")
    jc = jcfg.TrainConfig(global_batch=cfg.global_batch,
                          mesh=jcfg.MeshConfig(dp=W),
                          collective=jcfg.CollectiveConfig(impl="xla"),
                          optimizer=jcfg.OptimizerConfig(kind="sgd",
                                                         learning_rate=0.1))
    jtr = JaxShardedTrainer(
        lambda p, b: jax_llama.loss_fn(p, b, jm, dp_axis="dp"),
        make_mesh(jc.mesh), jc, jax_llama.param_specs(jm, tp_axis=None))
    js = jtr.init_state(jax.tree_util.tree_map(jnp.asarray,
                                               _jax_weights()["llama"]))
    for step, (t, lab) in enumerate(train_llama.batches(mcfg, cfg, seq, 2)):
        js, jl = jtr.step(js, jtr.shard_batch((jnp.asarray(t.numpy()),
                                               jnp.asarray(lab.numpy()))))
        for g in got:
            np.testing.assert_allclose(g["losses"][step], float(jl),
                                       rtol=1e-5)
    jw = np.concatenate([np.asarray(t, np.float32).reshape(-1) for t in
                         jax.tree_util.tree_leaves(js.params)])
    w = np.concatenate([g["w_final"][0] for g in got])[:jw.size]
    np.testing.assert_allclose(w, jw, rtol=0, atol=1e-6)


# -- (c) the drivers' main under the group -------------------------------------

MAINS = {"train_bert": BERT_BFP + ["--iters=1"],
         "train_resnet": RESNET_BFP + ["--iters=1"],
         "train_llama": LLAMA_BFP + ["--iters=1"]}


@pytest.mark.parametrize("module", sorted(MAINS))
def test_driver_main_across_processes(module):
    res = procs.spawn(procs.run_main, W, (f"fpga_ai_nic_tpu_torch.{module}",
                                          MAINS[module] + ["--device=cpu"]),
                      timeout=TIMEOUT_S, env=ENV)
    assert [r["process"]["process_id"] for r in res] == list(range(W))
    assert all(r["process"]["num_processes"] == W for r in res)
    assert all(r["loss_last"] == res[0]["loss_last"] for r in res)
    assert all(np.isfinite(r["loss_first"]) for r in res)
