"""The port's control plane (``parallel/multihost.py``) against the JAX
package's: JAX's three single-process cases (``initialize`` a no-op,
``process_info``, ``local_batch_to_global`` equal to the trainer's
``shard_batch``, the barrier), and two processes over gloo on the CPU,
marked slow as JAX's two-process test is."""

import json
import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from fpga_ai_nic_tpu.parallel import multihost as jax_multihost
from fpga_ai_nic_tpu_torch.models import mlp
from fpga_ai_nic_tpu_torch.parallel import multihost
from fpga_ai_nic_tpu_torch.parallel.mesh import VirtualRanks
from fpga_ai_nic_tpu_torch.parallel.train import DPTrainer
from fpga_ai_nic_tpu_torch.utils import config


def test_initialize_single_process_is_noop():
    for mod in (multihost, jax_multihost):
        mod.initialize()          # no coordinator, no env: must not raise
    info, want = multihost.process_info(), jax_multihost.process_info()
    assert info["num_processes"] == want["num_processes"] == 1
    assert info["process_id"] == want["process_id"] == 0
    assert info["global_devices"] == info["local_devices"] == 1
    assert not torch.distributed.is_initialized()


def test_local_batch_to_global_matches_shard_batch():
    m = config.MLPConfig(layer_sizes=(4, 8, 2))
    tr = DPTrainer(lambda p, b: mlp.loss_fn(p, b, m),
                   VirtualRanks(8, torch.device("cpu")),
                   config.TrainConfig(global_batch=16,
                                      mesh=config.MeshConfig(dp=8)))
    x = np.random.default_rng(0).standard_normal((16, 4)).astype(np.float32)
    got = multihost.local_batch_to_global((torch.from_numpy(x),), tr)
    want = tr.shard_batch((torch.from_numpy(x),))
    assert got[0].shape == want[0].shape == (8, 2, 4)
    assert torch.equal(got[0], want[0])
    assert float(got[0].sum()) == pytest.approx(float(x.sum()), rel=1e-6)


def test_barrier_single_process():
    multihost.barrier("test")       # must return, not hang


def test_initialize_refuses_a_partial_environment(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    with pytest.raises(ValueError, match="rank"):
        multihost.initialize()


_WORKER_SRC = r"""
import json, os, sys
import torch
import torch.distributed as dist
sys.path.insert(0, os.environ["_MH_REPO"])
from fpga_ai_nic_tpu_torch.parallel import multihost

multihost.initialize()          # torchrun's MASTER_*/WORLD_SIZE/RANK
multihost.initialize()          # idempotent
info = multihost.process_info()
rank = info["process_id"]
# each process holds its half of a 16 x 4 batch; an all-reduce sees both
local = torch.arange(64, dtype=torch.float32).reshape(16, 4)[
    rank * 8:(rank + 1) * 8]
total = local.sum()
dist.all_reduce(total)
multihost.barrier("test-two-proc")
print(json.dumps({"rank": rank, "n": info["num_processes"],
                  "total": float(total)}), flush=True)
dist.destroy_process_group()
"""


@pytest.mark.slow
def test_two_process_distributed_cpu():
    """Two CPU processes join one gloo group through ``initialize`` from
    torchrun's environment variables, all-reduce their local halves of a
    batch and meet at the barrier."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = []
    for rank in range(2):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), WORLD_SIZE="2", RANK=str(rank),
                   CUDA_VISIBLE_DEVICES="", _MH_REPO=repo)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER_SRC], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise AssertionError("two-process run timed out")
        assert p.returncode == 0, f"worker failed:\n{err[-2000:]}"
        m = re.search(r'\{"rank".*?\}', out)
        assert m, f"no result JSON in worker stdout:\n{out}"
        outs.append(json.loads(m.group(0)))
    want = float(np.arange(64, dtype=np.float32).sum())
    assert {o["rank"] for o in outs} == {0, 1}
    assert all(o["n"] == 2 and o["total"] == want for o in outs), outs
