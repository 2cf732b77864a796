#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. the card (``nvidia-smi`` name and power limit) and the kernel build
     (``nvcc`` for sm_90a, one process per source, all started together);
  2. every CUDA kernel against its plain PyTorch version on the same card
     tensors, bit for bit, with ms per call: bfp_encode / bfp_decode on 2^24
     elements and at the main path's shapes, ring_rs_update (SGD) and
     ring_ag at n=8 for a small payload (<= 4 MiB) and at full width;
  3. a small reference: a 3-layer MLP, 4 ranks, 3 steps on the card against
     the same steps on the CPU (plain versions);
  4. the main path: ``DPTrainer`` on the canonical MLP (10 x 2048x2048, f32),
     global batch 5376, dp=8 virtual ranks, BFP ring with fused kernel and
     fused SGD — 1 warm-up and 5 timed steps, launch counts checked — then
     one more step whose gradients also go through the plain collectives,
     whose masters must be bit-equal to the kernels';
  5. two more main-path steps under torch.profiler: device time by group
     (the port's kernels, GEMMs, the rest) and the device's idle share;
  6. the ``kernels`` line, then the last line
     ``{"ok": true, "device": {...}}``.

TF32 is off for matmuls and cuDNN, so the GEMMs run in full float32.  Any
failed phase raises and the script exits nonzero; without CUDA, or without
the rest of the repository beside it, it exits nonzero and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
F32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(bytes_moved: float, ops: float):
    b, o = bytes_moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return 1e3 * max(b, o), ("bytes" if b >= o else "operations")


def max_err(pairs) -> float:
    return max(float((a.double() - b.double()).abs().max()) for a, b in pairs)


def require_equal(name: str, pairs) -> None:
    for a, b in pairs:
        if a.shape != b.shape or not bool((a == b).all()):
            raise AssertionError(f"{name}: kernel differs from plain "
                                 f"(max abs err {max_err([(a, b)])})")


PORT = "fpga_ai_nic_tpu_torch"
REF = PORT.removesuffix("_torch")     # the JAX package's directory
PORT_KERNELS = ("bfp_encode_kernel", "bfp_decode_kernel",
                "ring_rs_hop_kernel", "ring_ag_hop_kernel")


def profile_steps(tr, state, batch, steps: int = 2) -> None:
    """Device time of a few main-path steps by group (the port's kernels,
    GEMMs, the rest) and the device's idle share, from torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            state, _ = tr.step(state, batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    groups = {"port_kernels": 0.0, "gemm": 0.0, "other": 0.0}
    by_name = {}
    for ev in prof.events():                  # device-side events only:
        if ev.device_type != DeviceType.CUDA:  # CPU ops would count their
            continue                           # kernels a second time
        ms, cnt = by_name.get(ev.name, (0.0, 0))
        by_name[ev.name] = (ms + ev.device_time_total / 1e3, cnt + 1)
    top = []
    for name, (ms, cnt) in by_name.items():
        low = name.lower()
        if any(k in name for k in PORT_KERNELS):
            groups["port_kernels"] += ms
        elif any(k in low for k in ("gemm", "cutlass", "xmma", "sm90_")):
            groups["gemm"] += ms
        else:
            groups["other"] += ms
        top.append((ms, name[:80], cnt))
    busy = sum(groups.values())
    top.sort(reverse=True)
    emit(phase="profile", steps=steps, wall_ms=wall_ms,
         device_ms=busy if busy else "not measured",
         device_ms_by_group=groups,
         idle_share=(1 - busy / wall_ms) if busy else "not measured",
         top=[{"ms": t, "name": nm, "count": c} for t, nm, c in top[:12]])


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from fpga_ai_nic_tpu_torch import optim
        from fpga_ai_nic_tpu_torch.models import mlp
        from fpga_ai_nic_tpu_torch.ops import _build, bfp_cuda, ring_cuda
        from fpga_ai_nic_tpu_torch.parallel.mesh import VirtualRanks
        from fpga_ai_nic_tpu_torch.parallel.train import DPTrainer
        from fpga_ai_nic_tpu_torch.utils.config import (
            BFPConfig, CollectiveConfig, MeshConfig, MLPConfig,
            OptimizerConfig, TrainConfig)
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script: {e}",
              file=sys.stderr)
        return 3

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # -- 1. card and build ----------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit(phase="build", seconds=_build.timed_build(),
         sources=list(_build.SOURCES), flags=list(_build.NVCC_FLAGS))

    cfg = BFPConfig(codec="pallas")
    B = cfg.block_size
    sgd = OptimizerConfig(kind="sgd", learning_rate=0.1)
    gen = torch.Generator(device=dev).manual_seed(0)
    n = 8
    L_full = 41_975_808                   # canonical MLP, padded for dp=8
    C_full = L_full // n
    results = {}

    def rec(name, **kw):
        results.setdefault(name, {"max_abs_err": 0.0})
        r = results[name]
        r["max_abs_err"] = max(r["max_abs_err"], kw.pop("max_abs_err"))
        r.update(kw)

    # -- 2. kernels against their plain versions --------------------------------
    for label, N in (("2^24", 1 << 24), ("main path encode", L_full),
                     ("main path decode", C_full)):
        x = torch.randn(N, generator=gen, device=dev) * 3
        x[::97] = 0
        x[5::131] *= 1e-39                # subnormals
        m, s = bfp_cuda.bfp_encode(x)
        pm, ps = bfp_cuda.bfp_encode_plain(x)
        require_equal("bfp_encode", [(m, pm), (s, ps)])
        d = bfp_cuda.bfp_decode(m, s)
        pd = bfp_cuda.bfp_decode_plain(pm, ps)
        require_equal("bfp_decode", [(d, pd)])
        enc_ms = cuda_ms(lambda: bfp_cuda.bfp_encode(x), 20, 3)
        dec_ms = cuda_ms(lambda: bfp_cuda.bfp_decode(m, s), 20, 3)
        enc_plain = cuda_ms(lambda: bfp_cuda.bfp_encode_plain(x), 3)
        dec_plain = cuda_ms(lambda: bfp_cuda.bfp_decode_plain(m, s), 3)
        emit(phase="kernel_check", kernel="bfp_encode/bfp_decode", shape=label,
             elems=N, bitexact=True, encode_ms=enc_ms, decode_ms=dec_ms,
             encode_plain_ms=enc_plain, decode_plain_ms=dec_plain)
        if label == "main path encode":
            rec("bfp_encode", max_abs_err=0.0, ms=enc_ms, plain_ms=enc_plain,
                bound=bound(N * (4 + 1 + 1 / B), 8 * N))
        if label == "main path decode":
            rec("bfp_decode", max_abs_err=0.0, ms=dec_ms, plain_ms=dec_plain,
                bound=bound(N * (1 + 1 / B + 4), 2 * N))
        del x, m, s, pm, ps, d, pd

    hyper = optim.fused_hyperparams(sgd, 0, device=dev)
    for label, L in (("small", n * 2048 * 64), ("full", L_full)):
        C = L // n
        x = torch.randn((n, L), generator=gen, device=dev)
        w = torch.randn((n, C), generator=gen, device=dev) * 0.02
        g_k, w_k, _ = ring_cuda.ring_reduce_scatter_update_fused(
            x, w, {}, hyper, opt_kind="sgd", compression=cfg)
        g_p, w_p, _ = ring_cuda.ring_reduce_scatter_update_plain(
            x, w, {}, hyper, opt_kind="sgd", compression=cfg)
        require_equal("ring_rs_update", [(g_k, g_p), (w_k, w_p)])
        rs_ms = cuda_ms(lambda: ring_cuda.ring_reduce_scatter_update_fused(
            x, w, {}, hyper, opt_kind="sgd", compression=cfg), 10)
        rs_plain = cuda_ms(lambda: ring_cuda.ring_reduce_scatter_update_plain(
            x, w, {}, hyper, opt_kind="sgd", compression=cfg), 2)
        del g_p, w_p
        ag_k = ring_cuda.ring_all_gather_fused(w_k, compression=cfg)
        ag_p = ring_cuda.ring_all_gather_plain(w_k, cfg)
        require_equal("ring_ag", [(ag_k, ag_p)])
        if not bool((ag_k == ag_k[0]).all()):
            raise AssertionError("ring_ag: replicas differ")
        ag_ms = cuda_ms(lambda: ring_cuda.ring_all_gather_fused(
            w_k, compression=cfg), 10)
        ag_plain = cuda_ms(lambda: ring_cuda.ring_all_gather_plain(w_k, cfg),
                           2)
        # the whole reduce-scatter + update: x, w read; g, w_new written
        # (per element and hop: decode, add, encode); the whole gather:
        # owned chunks read, n replicas written
        rs_bound = bound(4 * (n * L + 3 * n * C), 11 * n * L + 5 * n * C)
        ag_bound = bound(4 * (n * C + n * n * C), 8 * n * C + 2 * n * n * C)
        emit(phase="kernel_check", kernel="ring_rs_update(sgd)/ring_ag",
             payload=label, n=n, L=L, payload_bytes_per_rank=4 * L,
             bitexact=True, replicas_equal=True, rs_ms=rs_ms,
             rs_plain_ms=rs_plain, rs_bound_ms=rs_bound[0], ag_ms=ag_ms,
             ag_plain_ms=ag_plain, ag_bound_ms=ag_bound[0])
        if label == "full":
            rec("ring_rs_update", max_abs_err=0.0, ms=rs_ms,
                plain_ms=rs_plain, bound=rs_bound)
            rec("ring_ag", max_abs_err=0.0, ms=ag_ms, plain_ms=ag_plain,
                bound=ag_bound)
        del x, w, g_k, w_k, ag_k, ag_p
        torch.cuda.empty_cache()

    # -- 3. small reference: card against CPU -----------------------------------
    coll = CollectiveConfig(impl="ring", compression=cfg, fused_kernel=True,
                            fused_optimizer=True)
    small = MLPConfig(layer_sizes=(256,) * 4)
    scfg = TrainConfig(global_batch=64, mesh=MeshConfig(dp=4), collective=coll,
                       optimizer=sgd)
    p0 = mlp.init(torch.Generator().manual_seed(1), small, "cpu")
    xs = torch.randn((64, 256), generator=torch.Generator().manual_seed(2))
    ys = torch.randint(0, 256, (64,), generator=torch.Generator().manual_seed(3))
    runs = {}
    for d in ("cpu", "cuda"):
        tr = DPTrainer(lambda p, b: mlp.loss_fn(p, b, small),
                       VirtualRanks(4, torch.device(d)), scfg)
        st = tr.init_state(p0)
        b = tr.shard_batch((xs, ys))
        losses, gmax = [], 0.0
        for _ in range(3):
            g, loss = tr.grads(st, b)
            gmax = max(gmax, float(g.abs().max()))
            st = tr.apply_grads(st, g)
            losses.append(float(loss))
        runs[d] = (losses, st.w_own.cpu(), gmax)
    # one BFP grid step (2^-6 of a block max) may flip per step where the
    # GEMMs' summation order moves a value across a rounding boundary
    atol = 3 * 0.1 * 2.0 ** -6 * runs["cpu"][2]
    werr = float((runs["cpu"][1] - runs["cuda"][1]).abs().max())
    lerr = max(abs(a - b) / abs(a) for a, b in zip(runs["cpu"][0],
                                                   runs["cuda"][0]))
    emit(phase="small_reference", losses_cpu=runs["cpu"][0],
         losses_card=runs["cuda"][0], loss_rel_err=lerr,
         master_max_abs_err=werr, master_atol=atol)
    if not (lerr <= 1e-4 and werr <= atol):
        raise AssertionError("small reference: card and CPU disagree")

    # -- 4. the main path ---------------------------------------------------------
    mcfg = MLPConfig()
    cfg_main = TrainConfig(global_batch=5376, mesh=MeshConfig(dp=n),
                           collective=coll, optimizer=sgd)
    ranks = VirtualRanks(n, dev)
    tr = DPTrainer(lambda p, b: mlp.loss_fn(p, b, mcfg), ranks, cfg_main)
    state = tr.init_state(mlp.init(torch.Generator().manual_seed(0), mcfg,
                                   dev))
    if state.w_own.shape != (n, C_full):
        raise AssertionError(f"unexpected padding {tuple(state.w_own.shape)}")
    gx = torch.Generator(device=dev).manual_seed(4)
    batch = tr.shard_batch((
        torch.randn((cfg_main.global_batch, 2048), generator=gx, device=dev),
        torch.randint(0, 2048, (cfg_main.global_batch,), generator=gx,
                      device=dev)))
    kernels = {"bfp_encode": bfp_cuda.ENCODE, "bfp_decode": bfp_cuda.DECODE,
               "ring_rs_update": ring_cuda.RING_RS, "ring_ag": ring_cuda.RING_AG}
    per_step = {"bfp_encode": 1, "bfp_decode": n, "ring_rs_update": n,
                "ring_ag": n - 1}
    for k in kernels.values():
        k.launches = 0
    state, loss = tr.step(state, batch)           # warm-up
    losses = [float(loss)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps = 5
    for _ in range(steps):
        state, loss = tr.step(state, batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernels.items()}
    losses.append(float(loss))
    for name, k in launches.items():
        if k != (steps + 1) * per_step[name]:
            raise AssertionError(f"{name}: {k} launches, expected "
                                 f"{(steps + 1) * per_step[name]}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite loss {losses}")
    reps = state.replicas
    if not bool((reps == reps[0]).all()):
        raise AssertionError("replicas differ after the main path")
    emit(phase="main_path", model="MLP 10x2048x2048 f32", dp=n,
         global_batch=cfg_main.global_batch, steps=steps, wall_s=wall,
         ms_per_step=1e3 * wall / steps,
         samples_per_sec=steps * cfg_main.global_batch / wall,
         loss_first=losses[0], loss_last=losses[-1], launches=launches,
         padded_len=L_full, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)

    # one more step: the same gradients through kernels and plain versions
    g, _ = tr.grads(state, batch)
    new = tr.apply_grads(state, g)
    h = optim.fused_hyperparams(sgd, state.step, device=dev)
    _, w_plain, _ = ring_cuda.ring_reduce_scatter_update_plain(
        g, state.w_own, state.opt_state, h, opt_kind="sgd", compression=cfg)
    require_equal("main path masters", [(new.w_own, w_plain)])
    rep_plain = ring_cuda.ring_all_gather_plain(w_plain, cfg)
    require_equal("main path replicas", [(new.replicas, rep_plain)])
    emit(phase="plain_step", masters_bitequal=True, replicas_bitequal=True)
    del g, new, w_plain, rep_plain
    profile_steps(tr, state, batch)

    # -- 5. the kernels line and the result ------------------------------------------
    meta = {
        "bfp_encode": (PORT + "/csrc/bfp_codec.cu",
                       REF + "/ops/bfp_pallas.py:55"),
        "bfp_decode": (PORT + "/csrc/bfp_codec.cu",
                       REF + "/ops/bfp_pallas.py:76"),
        "ring_rs_update": (PORT + "/csrc/ring_rs.cu",
                           REF + "/ops/ring_pallas.py:777"),
        "ring_ag": (PORT + "/csrc/ring_ag.cu",
                    REF + "/ops/ring_pallas.py:1301"),
    }
    also = {"ring_rs_update": REF + "/ops/ring_pallas.py:397",
            "ring_ag": REF + "/ops/ring_pallas.py:1144"}
    out = []
    for name, (src, repl) in meta.items():
        r = results[name]
        bound_ms, bound_by = r["bound"]
        row = {"name": name, "route": "cuda", "source": src,
               "replaces": repl, "launches": launches[name],
               "max_abs_err": r["max_abs_err"], "ms": r["ms"],
               "plain_ms": r["plain_ms"], "bound_ms": bound_ms,
               "bound_by": bound_by, "library_ms": None}
        if name in also:
            row["also_replaces"] = also[name]
        out.append(row)
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
