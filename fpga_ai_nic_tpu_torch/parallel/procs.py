"""The port's data-parallel path across processes, one rank a process:
a launcher and the run it launches.

``spawn(fn, world, args)`` starts ``world`` processes (``spawn`` context),
each joining a gloo group at ``tcp://localhost:<free port>``
(``multihost.initialize``) and calling ``fn(rank, world, *args)``; it
returns their results in rank order, and kills every process and raises
when one fails or the run outlasts ``timeout``.

``ring_and_steps(rank, world, spec)`` is the run the tests and
``chip_smoke.py`` launch: the cross-process ring (``ops.ring_procs``) on
``spec["L"]``-element rows drawn from a seed, with BFP frames and with raw
f32 frames (``RING_CODECS``), under each optimizer of
``spec["opt_kinds"]``, its owned chunk, masters, moments and replica held
bit for bit against the one-process route on the stacked rows
(``fused_update.reduce_scatter_update`` / ``all_gather_flat``: the
loopback kernels on a card, their plain versions on the CPU); then
``spec["steps"]`` steps of ``DPTrainer`` on an MLP of
``spec["layer_sizes"]`` over this process's rows of a seeded global batch
(``multihost.local_batch_to_global``), returning each step's loss and the
sha256 of its master and replica rows, for the caller to hold against
``DPTrainer(dp=world)`` in one process.

``driver_run(rank, world, spec)`` is one of the model drivers' paths
(``spec["driver"]``: ``train_bert``'s ``DDPTrainer``, ``train_resnet``'s
sync-BN ``DPTrainer`` or ``train_llama``'s ``ShardedTrainer``, built by
the driver's own ``parse`` and ``build`` from ``spec["argv"]``, each
process feeding its rows of the driver's seeded batches) for
``spec["steps"]`` steps: each step's loss, the sha256 of every master and
replica row this process holds (after each step, or the last only),
the launches of the hop kernels and of the tensor-core flash kernels,
step, ring and sync-BN exchange times, the flat row's length (and a
DDP trainer's buckets'), and peak GB; with ``spec["masters"]`` the
master rows themselves, before the first step and after the last;
with ``spec["cudnn_deterministic"]`` cuDNN's deterministic algorithms
for the run (a convolution's weight gradient may otherwise add in
another order from run to run).  In one process (no group) the same
function runs the one-process trainer at the same dp over virtual ranks:
the reference the caller holds the processes against.  ``drivers(rank, world, specs)`` runs
several back to back in one spawn.

The processes run on the card (``spec["device"]`` "cuda": CUDA IPC peer
buffers) unless the caller asks for the CPU (gloo sends):

    python -m fpga_ai_nic_tpu_torch.parallel.procs --nproc=3 --device=cpu
    torchrun --nproc_per_node=3 -m fpga_ai_nic_tpu_torch.parallel.procs \\
        --device=cpu

(the first spawns the processes itself; under torchrun each process reads
its rank from the environment).  Each prints one JSON line.
"""

from __future__ import annotations

import contextlib
import gc
import hashlib
import json
import os
import queue as queue_lib
import socket
import sys
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from . import multihost

DEFAULT_SPEC = {"device": "cuda", "L": 3 * 16 * 128 * 4, "seed": 0,
                "codec": "bfp", "opt_kinds": ("sgd", "momentum", "adamw"),
                "layer_sizes": (32, 48, 48, 16), "global_batch": 24,
                "steps": 2, "opt": "sgd", "lr": 0.1}
RING_CODECS = ("bfp", None)     # the wires ring_check holds


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def _environ(env: Dict[str, str]):
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _child(fn: Callable, rank: int, world: int, port: int,
           args: Sequence[Any], queue) -> None:
    import torch.distributed as dist
    try:
        multihost.initialize(f"tcp://localhost:{port}", world, rank)
        queue.put((rank, True, fn(rank, world, *args)))
    except Exception:             # noqa: BLE001  (reported to the parent)
        queue.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, world: int, args: Sequence[Any] = (),
          timeout: float = 180.0,
          env: Optional[Dict[str, str]] = None) -> List[Any]:
    """``fn(rank, world, *args)`` in ``world`` processes of one gloo group
    (``env`` added to their environment); the results in rank order."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = free_port()
    with _environ(env or {}):
        procs = [ctx.Process(target=_child, args=(fn, r, world, port, args,
                                                  queue), daemon=True)
                 for r in range(world)]
        for p in procs:
            p.start()
    results: Dict[int, Any] = {}
    deadline = time.monotonic() + timeout
    try:
        while len(results) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{world - len(results)} of {world} "
                                   f"processes still running after "
                                   f"{timeout} s")
            try:
                rank, ok, res = queue.get(timeout=min(left, 5.0))
            except queue_lib.Empty:
                dead = [r for r, p in enumerate(procs)
                        if not p.is_alive() and r not in results]
                if dead and queue.empty():
                    raise RuntimeError(f"processes {dead} exited without a "
                                       "result")
                continue
            if not ok:
                raise RuntimeError(f"process {rank} failed:\n{res}")
            results[rank] = res
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
    return [results[r] for r in range(world)]


def digest(t: torch.Tensor) -> str:
    """The sha256 of a tensor's bytes (any dtype, bf16 included)."""
    b = t.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy()
    return hashlib.sha256(b).hexdigest()


def digests(ts) -> List[str]:
    """``digest`` of each tensor, a thread each (the copy to the host and
    sha256 run without the interpreter lock: a Llama-3-8B-width row is
    3.8 GB)."""
    from concurrent.futures import ThreadPoolExecutor
    ts = list(ts)
    with ThreadPoolExecutor(max(1, len(ts))) as pool:
        return list(pool.map(digest, ts))


def _coll(spec: dict):
    from ..utils.config import BFPConfig, CollectiveConfig
    if spec["codec"] == "bfp":
        return CollectiveConfig(impl="ring",
                                compression=BFPConfig(codec="pallas"),
                                fused_kernel=True, fused_optimizer=True)
    return CollectiveConfig(impl="ring", fused_optimizer=True)


def _opt(kind: str, lr: float):
    from ..utils.config import OptimizerConfig
    return OptimizerConfig(kind=kind, learning_rate=lr, weight_decay=0.01
                           if kind == "adamw" else 0.0)


def ring_check(rank: int, world: int, spec: dict, device) -> dict:
    """The ring on seeded rows against the one-process route, under each
    wire of ``RING_CODECS`` and each optimizer of ``spec["opt_kinds"]``
    (results keyed ``"<codec> <kind>"``, f32 the raw wire)."""
    out: Dict[str, Dict[str, Any]] = {"equal": {}, "ms": {}}
    for codec in RING_CODECS:
        _ring_check(rank, world, dict(spec, codec=codec), device, out)
    return out


def _ring_check(rank: int, world: int, spec: dict, device, out: dict
                ) -> None:
    from .. import optim
    from ..ops import fused_update, ring_procs
    coll = _coll(spec)
    cfg = coll.compression
    L = spec["L"]
    C = L // world
    gen = torch.Generator(device=device).manual_seed(spec["seed"])
    x = torch.randn((world, L), generator=gen, device=device) * 3
    ring = ring_procs.open_ring(rank, world, C, cfg, device)
    wire = spec["codec"] or "f32"
    try:
        for kind in spec["opt_kinds"]:
            opt = _opt(kind, 1e-2)
            keys = optim.OptimizerSpec.from_optimizer(opt).state_keys
            w = torch.randn((world, C), generator=gen, device=device) * 0.1
            st = {k: torch.rand((world, C), generator=gen, device=device)
                  * 0.01 for k in keys}
            hyper = optim.fused_hyperparams(opt, 3, device=device)
            t0 = time.perf_counter()
            g, w_new, st_new = ring.reduce_scatter_update(
                x[rank], w[rank], {k: v[rank] for k, v in st.items()},
                hyper, kind)
            replica = ring.all_gather(w_new)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            out["ms"][f"{wire} {kind}"] = 1e3 * (time.perf_counter() - t0)
            rg, rw, rst = fused_update.reduce_scatter_update(
                x, w, st, 3, coll, opt)
            rrep = fused_update.all_gather_flat(rw, coll)
            pairs = [(g, rg[rank]), (w_new, rw[rank]), (replica, rrep[rank])]
            pairs += [(st_new[k], rst[k][rank]) for k in keys]
            out["equal"][f"{wire} {kind}"] = all(bool(torch.equal(a, b))
                                                 for a, b in pairs)
            del rg, rw, rst, rrep, g, w_new, st_new, replica
    finally:
        ring.close()


def trainer_steps(rank: int, world: int, spec: dict, device) -> dict:
    """``spec["steps"]`` DPTrainer steps across the processes."""
    from ..models import mlp
    from ..ops import ring_procs
    from .mesh import VirtualRanks
    from .train import DPTrainer
    from ..utils.config import MeshConfig, MLPConfig, TrainConfig
    mcfg = MLPConfig(layer_sizes=tuple(spec["layer_sizes"]))
    cfg = TrainConfig(global_batch=spec["global_batch"],
                      mesh=MeshConfig(dp=world), collective=_coll(spec),
                      optimizer=_opt(spec["opt"], spec["lr"]))
    tr = DPTrainer(lambda p, b: mlp.loss_fn(p, b, mcfg),
                   VirtualRanks(world, device), cfg)
    state = tr.init_state(mlp.init(torch.Generator().manual_seed(
        spec["seed"]), mcfg, device))
    bx, by = global_batch(spec, device)
    rows = slice(rank * bx.shape[0] // world,
                 (rank + 1) * bx.shape[0] // world)
    batch = multihost.local_batch_to_global((bx[rows], by[rows]), tr)
    kernels = {"ring_hop_rs": ring_procs.RING_HOP_RS,
               "ring_hop_ag": ring_procs.RING_HOP_AG}
    for k in kernels.values():
        k.launches = 0
    out: Dict[str, Any] = {"losses": [], "w_own": [], "replica": [],
                           "step_ms": []}
    try:
        for _ in range(spec["steps"]):
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            multihost.barrier()
            t0 = time.perf_counter()
            state, loss = tr.step(state, batch)
            loss = float(loss)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            out["step_ms"].append(1e3 * (time.perf_counter() - t0))
            out["losses"].append(loss)
            out["w_own"].append(digest(state.w_own[0]))
            out["replica"].append(digest(state.replicas[0]))
        out["launches"] = {n: k.launches for n, k in kernels.items()}
        out["padded_len"] = state.replicas.shape[1]
    finally:
        tr.close()
    return out


def global_batch(spec: dict, device):
    """The seeded global batch ``(x [B, d], y [B])`` of ``spec``."""
    sizes = spec["layer_sizes"]
    g = torch.Generator().manual_seed(spec["seed"] + 1)
    bx = torch.randn((spec["global_batch"], sizes[0]), generator=g)
    by = torch.randint(0, sizes[-1], (spec["global_batch"],), generator=g)
    return bx.to(device), by.to(device)


def ring_and_steps(rank: int, world: int, spec: dict) -> dict:
    """This process's part of the run (the module docstring)."""
    from ..ops import ring_procs
    spec = dict(DEFAULT_SPEC, **spec)
    device = ring_procs.proc_device(rank, world, spec["device"])
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
    out = {"device": str(device), "ring": ring_check(rank, world, spec,
                                                     device)}
    out.update(trainer_steps(rank, world, spec, device))
    return out


DRIVER_SPEC = {"device": "cuda", "steps": 3, "digest": "each",
               "params": None, "sync_bn": True, "masters": False,
               "cudnn_deterministic": False, "explicit_grads": False}


def explicit_grads(loss_fn: Callable) -> Callable:
    """``loss_fn(params, batch)`` as JAX's explicit-gradient hook,
    ``(params, batch) -> (loss, grads)``: autograd of it, written out."""
    from ..ops import fused_update

    def loss_and_grads(params, batch):
        pairs = fused_update._leaves(params)
        leaves = [t.detach().requires_grad_() for _, t in pairs]
        keys = tuple(p for p, _ in pairs)
        loss = loss_fn(fused_update.tree_from_leaves(keys, leaves), batch)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), fused_update.tree_from_leaves(keys, list(grads))
    return loss_and_grads


def _session(spec: dict):
    """``(trainer, state, host batches)`` of ``spec["driver"]`` built by the
    driver's own functions from ``spec["argv"]`` on ``spec["device"]``;
    ``spec["params"]`` (a numpy tree in the JAX package's layout) in place
    of the seeded weights when given; with ``spec["explicit_grads"]``
    (Llama) the trainer takes the loss through ``loss_and_grads_fn``
    (``explicit_grads``) from the same weights."""
    argv = list(spec["argv"]) + [f"--device={spec['device']}"]
    name, steps, params = spec["driver"], spec["steps"], spec["params"]
    if name == "bert":
        from .. import train_bert as d
        from ..models import bert as model
        mcfg, cfg, run = d.parse(argv)
        tr, state = d.build(mcfg, cfg, run)
        host = [b for b, _ in d.batches(mcfg, cfg, run, steps)]
        port = model.from_jax_params
    elif name == "resnet":
        from .. import train_resnet as d
        from ..models import resnet as model
        mcfg, cfg, size, device = d.parse(argv)
        tr, state = d.build(mcfg, cfg, device, spec["sync_bn"])
        host = list(d.batches(mcfg, cfg, size, steps))
        port = model.from_jax_params
    elif name == "llama":
        from .. import train_llama as d
        from ..models import llama as model
        mcfg, cfg, seq, device = d.parse(argv)
        if spec["explicit_grads"]:
            from .mesh import make_ranks
            from .sharded import ShardedTrainer
            ranks = make_ranks(cfg.mesh, multihost.process_device(device))
            tr = ShardedTrainer(None, ranks, cfg, loss_and_grads_fn=(
                explicit_grads(lambda p, b: model.loss_fn(p, b, mcfg))))
            state = tr.init_state(model.init(torch.Generator(
                device=ranks.device).manual_seed(cfg.seed), mcfg,
                ranks.device))
        else:
            tr, state = d.build(mcfg, cfg, device)
        host = list(d.batches(mcfg, cfg, seq, steps))
        port = model.params_from_jax
    else:
        raise ValueError(f"unknown driver {name!r}")
    if params is not None:
        del state
        state = tr.init_state(port(params, tr.ranks.device))
    return tr, state, host


def _masters(state) -> torch.Tensor:
    """The f32 master rows: ``DDPState.w_master`` or ``TrainState.w_own``."""
    return state.w_master if hasattr(state, "w_master") else state.w_own


def driver_run(rank: int, world: int, spec: dict) -> dict:
    """This process's run of one driver's path (the module docstring)."""
    from ..ops import flash_attention, ring_procs
    spec = dict(DRIVER_SPEC, **spec)
    dev = multihost.process_device(spec["device"])
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = spec["cudnn_deterministic"]
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    tr, state, host = _session(spec)
    batches = [multihost.local_batch_to_global(multihost.process_rows(b), tr)
               for b in host]
    del host
    kernels = {"ring_hop_rs": ring_procs.RING_HOP_RS,
               "ring_hop_ag": ring_procs.RING_HOP_AG,
               "flash_fwd": flash_attention.FLASH_FWD,
               "flash_dq": flash_attention.FLASH_DQ,
               "flash_dkv": flash_attention.FLASH_DKV}
    ring, ex = tr._ring, ring_procs.RANK_GATHERS
    out: Dict[str, Any] = {"driver": spec["driver"], "device": str(dev),
                           "rows": _masters(state).shape[0],
                           "row_len": state.replicas.shape[1], "losses": [],
                           "masters": [], "replicas": [], "step_ms": [],
                           "ring_ms": [], "exchanges": [], "exchange_ms": []}
    if hasattr(tr, "plan"):
        out["buckets"] = [b.padded_len for b in tr.plan.buckets]
    if spec["masters"]:
        out["w_initial"] = [w.cpu().numpy() for w in _masters(state)]
    for k in kernels.values():
        k.launches = 0
    for i, b in enumerate(batches):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        multihost.barrier()
        r0, e0, s0 = (ring.seconds if ring else 0.0), ex.calls, ex.seconds
        t0 = time.perf_counter()
        state, loss = tr.step(state, b)
        loss = float(loss)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        out["step_ms"].append(1e3 * (time.perf_counter() - t0))
        out["ring_ms"].append(1e3 * ((ring.seconds if ring else 0.0) - r0))
        out["exchanges"].append(ex.calls - e0)
        out["exchange_ms"].append(1e3 * (ex.seconds - s0))
        out["losses"].append(loss)
        if spec["digest"] == "each" or i == len(batches) - 1:
            out["masters"].append(digests(_masters(state)))
            out["replicas"].append(digests(state.replicas))
    out["launches"] = {n: k.launches for n, k in kernels.items()}
    if spec["masters"]:
        out["w_final"] = [w.cpu().numpy() for w in _masters(state)]
    if dev.type == "cuda":
        out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    tr.close()
    del tr, state, batches
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = deterministic
    return out


def drivers(rank: int, world: int, specs: Sequence[dict]) -> List[dict]:
    """``driver_run`` of each spec, back to back."""
    return [driver_run(rank, world, s) for s in specs]


def run_main(rank: int, world: int, module: str,
             argv: Sequence[str]) -> Any:
    """A driver module's ``main(argv)`` (e.g.
    ``"fpga_ai_nic_tpu_torch.train_bert"``) in this process of the group:
    what a launcher's process runs."""
    import importlib
    return importlib.import_module(module).main(list(argv))


def main(argv: Sequence[str]) -> None:
    spec = dict(DEFAULT_SPEC)
    nproc = 3
    for a in argv:
        key, _, val = a.partition("=")
        if key == "--device":
            spec["device"] = val
        elif key == "--nproc":
            nproc = int(val)
    if "WORLD_SIZE" in os.environ:       # under torchrun: one rank here
        multihost.initialize()
        res = ring_and_steps(multihost.process_index(),
                             multihost.world_size(), spec)
        print(json.dumps(dict(res, rank=multihost.process_index())))
        return
    for r, res in enumerate(spawn(ring_and_steps, nproc, (spec,))):
        print(json.dumps(dict(res, rank=r)))


if __name__ == "__main__":
    main(sys.argv[1:])
