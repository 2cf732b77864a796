"""The fused BFP ring with its ranks as processes (``ops.ring_procs``) and
``DPTrainer`` across processes, on the CPU.

- (a) the hop functions driven over n ranks in one process
  (``LoopbackPorts``: each rank's sends land in the next rank's buffers)
  equal ``ring_golden``'s sublane reduce-scatter composed with
  ``optim.golden_fused_apply`` (SGD, momentum, AdamW) and its all-gather,
  bit for bit, with BFP and without a codec;
- (b) a frame is the loopback kernels' wire: slice by slice, the
  golden's int8 mantissas then its int8 scales;
- (c) three processes over gloo (``CUDA_VISIBLE_DEVICES=""``, the CPU
  asked for): the ring, with BFP and raw f32 frames, against the
  one-process route on the stacked rows and two ``DPTrainer``
  steps of a tiny MLP bit-equal to ``DPTrainer(dp=3)`` in this process
  (masters, replicas, losses), with BFP and SGD and without a codec and
  AdamW; each run under a 180-s limit of its own;
- (d) what stays refused at W > 1 raises ``NotImplementedError`` naming
  A.11 (the world size patched to 2: the checks run before any process
  group is used), and what spans processes since (``DDPTrainer``,
  sync-BN's loss, ``ShardedTrainer`` at dp) is taken there; the run
  takes the card unless asked for the CPU.  The drivers across processes
  are ``tests/test_torch_procs_drivers.py``'s.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from fpga_ai_nic_tpu_torch import optim
from fpga_ai_nic_tpu_torch.models import llama, mlp, resnet
from fpga_ai_nic_tpu_torch.ops import bfp_golden, ring_golden, ring_procs
from fpga_ai_nic_tpu_torch.parallel import multihost, procs
from fpga_ai_nic_tpu_torch.parallel.ddp import DDPTrainer
from fpga_ai_nic_tpu_torch.parallel.fsdp import FSDPTrainer
from fpga_ai_nic_tpu_torch.parallel.mesh import VirtualRanks
from fpga_ai_nic_tpu_torch.parallel.queued import QueuedDDPTrainer
from fpga_ai_nic_tpu_torch.parallel.sharded import ShardedTrainer
from fpga_ai_nic_tpu_torch.parallel.train import DPTrainer
from fpga_ai_nic_tpu_torch.utils.config import (
    BFPConfig, CollectiveConfig, MeshConfig, MLPConfig, OptimizerConfig,
    TrainConfig)

SUBLANE = BFPConfig(codec="pallas")
PROCS_TIMEOUT_S = 180.0


def _rows(n, C, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, n * C)) * 3).astype(np.float32)
    x[:, ::97] = 0
    return x, (rng.standard_normal((n, C)) * 0.1).astype(np.float32), rng


@pytest.mark.parametrize("cfg", [SUBLANE, None], ids=["bfp", "f32"])
@pytest.mark.parametrize("kind", ["sgd", "momentum", "adamw"])
def test_hops_in_one_process_equal_golden(cfg, kind):
    n, C = 3, 16 * 128 * 3
    x, w, rng = _rows(n, C, 1)
    opt = OptimizerConfig(kind=kind, learning_rate=0.01, weight_decay=0.01)
    keys = optim.OptimizerSpec.from_optimizer(opt).state_keys
    st = {k: np.abs(rng.standard_normal((n, C))).astype(np.float32) * 0.01
          for k in keys}
    hyper = optim.fused_hyperparams(opt, 3)
    wire = ring_procs.wire_for(C, cfg)
    ports = ring_procs.LoopbackPorts(n, wire.frame_bytes)
    rings = [ring_procs.ProcRing(r, n, wire, ports.port(r)) for r in range(n)]
    res = [None] * n
    for k in range(n):                 # launch k of every rank, then k + 1
        for r in range(n):
            out = rings[r].rs_launch(
                k, torch.from_numpy(x[r]), torch.from_numpy(w[r]),
                {q: torch.from_numpy(v[r]) for q, v in st.items()}, hyper,
                kind)
            if out is not None:
                res[r] = out
    g = ring_golden.ring_reduce_scatter(x, cfg, "sublane")
    wg, sg = optim.golden_fused_apply(kind, w, g, st, hyper.numpy(), n)
    for r in range(n):
        np.testing.assert_array_equal(res[r][0].numpy(), g[r])
        np.testing.assert_array_equal(res[r][1].numpy(), wg[r])
        for q in keys:
            np.testing.assert_array_equal(res[r][2][q].numpy(), sg[q][r])
    reps = [torch.empty(n * C) for _ in range(n)]
    for k in range(n):
        for r in range(n):
            rings[r].ag_launch(k, torch.from_numpy(wg[r]), reps[r])
    want = ring_golden.ring_all_gather(wg, cfg, "sublane")
    for r in range(n):
        np.testing.assert_array_equal(reps[r].numpy(), want[r])


def test_frame_is_the_loopback_wire():
    C = 16 * 128 * 6
    wire = ring_procs.wire_for(C, SUBLANE)
    se = wire.slice_elems
    assert C % se == 0 and wire.frame_bytes == C + C // 16
    x = np.random.default_rng(2).standard_normal(C).astype(np.float32)
    frame = torch.empty(wire.frame_bytes, dtype=torch.uint8)
    ring_procs.encode_frame(torch.from_numpy(x), wire, frame)
    want = []
    for s in range(C // se):          # ring_golden.ring_reduce_scatter_pair
        mant, scale = bfp_golden.bfp_encode(x[s * se:(s + 1) * se], 16, 8,
                                            "nearest", layout="sublane")
        want += [mant.reshape(-1).view(np.uint8),
                 scale.reshape(-1).view(np.uint8)]
    np.testing.assert_array_equal(frame.numpy(), np.concatenate(want))
    np.testing.assert_array_equal(
        ring_procs.decode_frame(frame, wire).numpy(),
        ring_golden._roundtrip(x, SUBLANE, "sublane"))


def _one_process(spec):
    """``DPTrainer(dp=3)`` in this process on the spec's model and batch."""
    spec = dict(procs.DEFAULT_SPEC, **spec)
    mcfg = MLPConfig(layer_sizes=tuple(spec["layer_sizes"]))
    cfg = TrainConfig(global_batch=spec["global_batch"],
                      mesh=MeshConfig(dp=3), collective=procs._coll(spec),
                      optimizer=procs._opt(spec["opt"], spec["lr"]))
    tr = DPTrainer(lambda p, b: mlp.loss_fn(p, b, mcfg),
                   VirtualRanks(3, torch.device("cpu")), cfg)
    st = tr.init_state(mlp.init(torch.Generator().manual_seed(spec["seed"]),
                                mcfg, "cpu"))
    batch = tr.shard_batch(procs.global_batch(spec, "cpu"))
    out = {"losses": [], "w_own": [], "replicas": []}
    for _ in range(spec["steps"]):
        st, loss = tr.step(st, batch)
        out["losses"].append(float(loss))
        out["w_own"].append([procs.digest(st.w_own[r]) for r in range(3)])
        out["replicas"].append([procs.digest(st.replicas[r])
                                for r in range(3)])
    return out


@pytest.mark.parametrize("spec", [{"device": "cpu", "codec": "bfp",
                                   "opt": "sgd"},
                                  {"device": "cpu", "codec": None,
                                   "opt": "adamw", "lr": 1e-2}],
                         ids=["bfp_sgd", "f32_adamw"])
def test_three_processes_bitequal_to_one(spec):
    res = procs.spawn(procs.ring_and_steps, 3, (spec,),
                      timeout=PROCS_TIMEOUT_S,
                      env={"CUDA_VISIBLE_DEVICES": ""})
    want = _one_process(spec)
    for r, got in enumerate(res):
        assert got["device"] == "cpu"
        assert set(got["ring"]["equal"]) == {
            f"{c} {k}" for c in ("bfp", "f32")
            for k in procs.DEFAULT_SPEC["opt_kinds"]}
        assert all(got["ring"]["equal"].values()), got["ring"]
        assert got["losses"] == want["losses"]
        assert got["w_own"] == [d[r] for d in want["w_own"]]
        assert got["replica"] == [d[r] for d in want["replicas"]]
        assert got["launches"] == {"ring_hop_rs": 0, "ring_hop_ag": 0}


@pytest.fixture
def two_processes(monkeypatch):
    monkeypatch.setattr(multihost, "world_size", lambda: 2)
    monkeypatch.setattr(multihost, "process_index", lambda: 0)


def _dp(coll, loss=None, **kw):
    cfg = TrainConfig(global_batch=8, mesh=MeshConfig(dp=2),
                      collective=coll, **kw)
    return DPTrainer(loss or (lambda p, b: None),
                     VirtualRanks(2, torch.device("cpu")), cfg)


BFP_RING = CollectiveConfig(impl="ring", compression=SUBLANE,
                            fused_kernel=True, fused_optimizer=True)


def _on(cls, coll=BFP_RING, mesh=None, loss=None, accum_steps=1, **kw):
    """A trainer of ``cls`` on 2 CPU ranks (``mesh``: its axes, dp=2)."""
    mesh = mesh or MeshConfig(dp=2)
    ranks = VirtualRanks(mesh.dp, torch.device("cpu"), mesh.sp, mesh.ep,
                         mesh.pp, mesh.tp)
    return cls(loss or (lambda p, b: None), ranks,
               TrainConfig(global_batch=8, mesh=mesh, collective=coll,
                           accum_steps=accum_steps), **kw)


TINY = llama.LlamaConfig.tiny()


@pytest.mark.parametrize("make", [
    lambda: _dp(CollectiveConfig(impl="ring", codec="int8")),
    lambda: _dp(CollectiveConfig(impl="ring", codec="topk")),
    lambda: _dp(CollectiveConfig(impl="ring", codec="bfp",
                                 codec_opts=(("error_feedback", True),),
                                 compression=SUBLANE)),
    lambda: _dp(dataclasses.replace(BFP_RING, fused_optimizer=False)),
    lambda: _dp(dataclasses.replace(BFP_RING, integrity_check=True)),
    lambda: _dp(BFP_RING, accum_steps=2),
    lambda: _dp(BFP_RING, loss=llama.dp_loss_fn(TINY, 2, 1)),
    lambda: _dp(CollectiveConfig(impl="xla")),
    lambda: _dp(CollectiveConfig(impl="ring", compression=BFPConfig())),
    lambda: _on(DDPTrainer, CollectiveConfig(impl="ring", codec="int8")),
    lambda: FSDPTrainer(lambda p, b: None, VirtualRanks(
        2, torch.device("cpu")), TrainConfig(mesh=MeshConfig(fsdp=2))),
    lambda: _on(ShardedTrainer, mesh=MeshConfig(dp=2, tp=2),
                param_specs=llama.param_specs(TINY, "tp", tp_size=2)),
    lambda: _on(ShardedTrainer, mesh=MeshConfig(dp=2, sp=2)),
    lambda: _on(QueuedDDPTrainer),
    lambda: _on(DDPTrainer, accum_steps=2),
    lambda: _on(ShardedTrainer, CollectiveConfig(
        impl="ring", compression=SUBLANE, fused_kernel=True),
        loss=llama.dp_loss_fn(TINY, 2, 1))],
    ids=["int8", "topk", "error_feedback", "unfused", "integrity", "accum",
         "joint_loss", "xla", "bfp_flat16", "ddp_int8", "fsdp", "sharded_tp",
         "sharded_sp", "queued", "ddp_accum", "sharded_joint_loss"])
def test_refusals_across_processes(two_processes, make):
    with pytest.raises(NotImplementedError, match="A.11"):
        make()


@pytest.mark.parametrize("make", [
    lambda: _on(DDPTrainer),
    lambda: _dp(BFP_RING, loss=resnet.dp_loss_fn(resnet.ResNetConfig.tiny())),
    lambda: _on(ShardedTrainer, CollectiveConfig(
        impl="ring", compression=SUBLANE, fused_kernel=True))],
    ids=["ddp", "sync_bn", "sharded"])
def test_spans_processes(two_processes, make):
    """What spans processes since: its construction under a group of 2
    checks what it is given and keeps its rank."""
    tr = make()
    assert (tr.world, tr.rank) == (2, 0)


def test_world_must_be_dp(two_processes):
    with pytest.raises(ValueError, match="one rank a process"):
        DPTrainer(lambda p, b: None, VirtualRanks(4, torch.device("cpu")),
                  TrainConfig(mesh=MeshConfig(dp=4), collective=BFP_RING))
    # the main path's config is taken
    assert _dp(BFP_RING).world == 2


def test_processes_default_to_the_card(monkeypatch):
    """The run takes the card unless the caller asks for the CPU: without
    CUDA the default spec's device raises, never falls back."""
    assert procs.DEFAULT_SPEC["device"] == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        procs.ring_and_steps(0, 2, {})
    assert ring_procs.proc_device(0, 2, "cpu").type == "cpu"


def test_process_rows_cut_counted_batches():
    """A process's rows of a host global batch: rows ``rank B / W`` on, a
    ``CountedBatch``'s count leaf cut to that rank's entries (its mark
    kept); one process gets the batch as it is; rows that do not split
    raise."""
    from fpga_ai_nic_tpu_torch.parallel.mesh import CountedBatch
    x = torch.arange(12).reshape(6, 2)
    count = torch.tensor([7, 7, 7, 8, 8, 8])      # 3 ranks x 2 microbatches
    got = multihost.process_rows(CountedBatch((x, x + 1, count)), 1, 3)
    assert isinstance(got, CountedBatch)
    assert torch.equal(got[0], x[2:4]) and torch.equal(got[1], x[2:4] + 1)
    assert torch.equal(got[2], count[2:4])
    plain = multihost.process_rows((x,), 2, 3)
    assert type(plain) is tuple and torch.equal(plain[0], x[4:])
    assert multihost.process_rows((x,), 0, 1)[0] is x
    with pytest.raises(ValueError, match="does not split"):
        multihost.process_rows((x,), 0, 4)
