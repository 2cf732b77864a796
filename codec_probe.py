#!/usr/bin/env python3
"""Device time of the port's codec kernels on one NVIDIA card.

    python3 codec_probe.py [--root DIR] [--control] [--step] [--flash]
                           [--flash64]
    python3 codec_probe.py --ring [--root DIR]

Times ``int8_encode`` (both roundings), ``int8_decode``, ``bfp_encode`` and
``bfp_decode`` at the main paths' shapes (``chip_smoke.py``'s), each by the
kernel's device time (torch.profiler, ``chip_smoke.device_ms``), the same
with the L2 cache flushed before each call, and the CUDA-event time of
whole calls (host work included), and counts the
conversion, MUFU and call instructions and the registers of
``int8_encode_kernel<16>`` in its SASS.  ``--root`` times the port of
another checkout (a parent commit unpacked with ``git archive``) with this
script's helpers, so two commits compare in one process order on one card.
``--control`` adds a copy-only control with ``int8_encode``'s access
pattern (float4 loads of 16 rows, char4 stores and one 8-byte scale store a
thread), the floor that pattern reaches; ``--step`` times the int8 MLP
step of ``chip_smoke.py``'s ``int8_train_path`` (dp=2, 1 warm-up and 10
timed steps).  ``--flash`` times the tensor-core flash kernels without a
key bias (``flash_fwd``, ``flash_dq``, ``flash_dkv``, by device time) at
``chip_smoke.py``'s two shapes and prints a sha256 digest of their
outputs on numpy-seeded inputs, so two checkouts' bias-free kernels
compare bit for bit, the same digest of the head_dim-64 forward and dq
at BERT-base's shape with and without a key bias, and the SASS
instruction count and registers of the head_dim-128 tensor-core kernels
with and without the key bias and of the paged prefill (named as either
checkout builds them).  ``--flash64``
builds the head_dim-64 forward, dq and dk/dv for other blocks an SM than
``csrc/`` does (copies of the sources with another ``FWD_BLOCKS<64>`` /
``DQ_BLOCKS<64>`` / ``DKV_BLOCKS<64>``, compiled beside the port's
libraries) and times each
build's launch at BERT-base's attention shape with the key bias (device
time), beside its registers and spills.  ``--ring`` alone (no codec
timing) reads the ring reduce-scatter kernel of the checkout at
``--root``: the SASS instructions, registers and local bytes of its B=16
instantiations without and with the checksum pair (named as either tree
builds them: ``...ELi127EE`` since the ablate= stage parameter, ``...EEv``
before it), sha256 digests of its outputs on seeded inputs
(``chip_smoke.ring_rs_digests``) and its device time at 4 MiB a rank and at
the MLP's shape (SGD); run it on the parent and this tree in one call.
Each result is one JSON line; the last line sums them up.  Without a card
it exits nonzero.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

CONTROL_SRC = r"""
#include <cstdint>
#include <cuda_runtime.h>
constexpr int LANES = 128, QUADS = 32, THREADS = 256, B = 16;
// int8_encode_kernel<16>'s indexing, loads and stores, with no arithmetic
// but what keeps every loaded word alive
__global__ void __launch_bounds__(THREADS)
copy_control_kernel(const float* __restrict__ x, signed char* __restrict__ q,
                    unsigned short* __restrict__ scale, long long n_threads) {
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= n_threads) return;
  const long long t = gid / QUADS;
  const int qd = (int)(gid % QUADS);
  const long long base = t * (long long)(B * LANES) + 4 * qd;
  float4 v[B];
#pragma unroll
  for (int r = 0; r < B; ++r)
    v[r] = *reinterpret_cast<const float4*>(x + base + r * LANES);
  uint32_t acc = 0;
#pragma unroll
  for (int r = 0; r < B; ++r) {
    const uint32_t a = __float_as_uint(v[r].x), b = __float_as_uint(v[r].y);
    const uint32_t c = __float_as_uint(v[r].z), d = __float_as_uint(v[r].w);
    acc ^= a ^ b ^ c ^ d;
    *reinterpret_cast<char4*>(q + base + r * LANES) =
        make_char4(a >> 24, b >> 24, c >> 24, d >> 24);
  }
  *reinterpret_cast<uint2*>(scale + t * LANES + 4 * qd) = make_uint2(acc, acc);
}
extern "C" int copy_control_launch(const float* x, signed char* q,
                                   unsigned short* scale, long long n_elems,
                                   cudaStream_t stream) {
  const long long n_threads = n_elems / (4LL * B);
  copy_control_kernel<<<(unsigned)((n_threads + THREADS - 1) / THREADS),
                        THREADS, 0, stream>>>(x, q, scale, n_threads);
  return (int)cudaGetLastError();
}
"""


def load_chip_smoke():
    """This checkout's chip_smoke.py, for its timing helpers and shapes."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build_control(build_mod):
    """Compile CONTROL_SRC with the port's flags into its build directory."""
    out_dir = build_mod.BUILD_DIR
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "copy_control.cu"
    src.write_text(CONTROL_SRC)
    lib = out_dir / f"copy_control.{os.getpid()}.so"
    subprocess.run([build_mod.nvcc_path(), *build_mod.NVCC_FLAGS, "-o",
                    str(lib), str(src)], check=True, timeout=300)
    fn = ctypes.CDLL(str(lib)).copy_control_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def time_row(cs, fn, names, reps=20) -> dict:
    """Per call of ``fn``: the kernels' device time, the same with the L2
    cache flushed (a 256 MB write) before each call, and CUDA-event time
    of whole calls."""
    import torch
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")

    def cold():
        flush.zero_()
        fn()

    return {"device_ms": cs.device_ms(fn, reps, names),
            "cold_device_ms": cs.device_ms(cold, reps, names),
            "event_ms": cs.cuda_ms(fn, reps, 3)}


def int8_step(cs, dev, steps=10):
    """ms per int8 MLP step (CUDA events), as ``int8_train_path`` builds it."""
    import torch
    from fpga_ai_nic_tpu_torch.models import mlp
    from fpga_ai_nic_tpu_torch.parallel.mesh import VirtualRanks
    from fpga_ai_nic_tpu_torch.parallel.train import DPTrainer
    from fpga_ai_nic_tpu_torch.utils.config import (
        CollectiveConfig, MeshConfig, MLPConfig, OptimizerConfig,
        TrainConfig)
    mcfg = MLPConfig()
    cfg = TrainConfig(global_batch=5376, mesh=MeshConfig(dp=cs.INT8_DP),
                      optimizer=OptimizerConfig(kind="sgd",
                                                learning_rate=0.1),
                      collective=CollectiveConfig(
                          impl="ring", codec="int8",
                          codec_opts=cs.INT8_OPTS, fused_optimizer=True))
    tr = DPTrainer(lambda p, b: mlp.loss_fn(p, b, mcfg),
                   VirtualRanks(cs.INT8_DP, dev), cfg)
    state = tr.init_state(mlp.init(torch.Generator().manual_seed(0), mcfg,
                                   dev))
    gx = torch.Generator(device=dev).manual_seed(4)
    bx = torch.randn((cfg.global_batch, 2048), generator=gx, device=dev)
    by = torch.randint(0, 2048, (cfg.global_batch,), generator=gx,
                       device=dev)
    batch = tr.shard_batch((bx, by))
    state, _ = tr.step(state, batch)
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    torch.cuda.synchronize()
    marks[0].record()
    for mark in marks[1:]:
        state, loss = tr.step(state, batch)
        mark.record()
    torch.cuda.synchronize()
    step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    return {"step_ms": step_ms, "median_step_ms": sorted(step_ms)[steps // 2],
            "loss_last": float(loss)}


def flash_case(cs, dev, si):
    """``cs.FLASH_SHAPES[si]``'s bf16 inputs on the card (drawn with numpy
    from seed ``300 + si``, so no torch version changes them), the
    bias-free tensor-core kernels' outputs on them, and the sha256 digest
    of out, lse, dq, dk and dv: ``(name, digest, (q, k, v), args, kw)``."""
    import hashlib
    import numpy as np
    import torch
    from fpga_ai_nic_tpu_torch.ops import flash_attention as fa
    name, B, H, n_kv, S, causal = cs.FLASH_SHAPES[si]
    rng = np.random.default_rng(300 + si)

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
            dev).to(torch.bfloat16)

    q, k, v = rand(B, H, S, 128), rand(B, n_kv, S, 128), rand(B, n_kv, S,
                                                              128)
    do = rand(B, H, S, 128)
    kw = dict(causal=causal, sm_scale=128 ** -0.5)
    out, lse = fa.flash_fwd_cuda(q, k, v, **kw)
    delta = (do.float() * out.float()).sum(-1)
    args = (q, k, v, do, lse, delta)
    h = hashlib.sha256()
    for t in (out, lse, fa.flash_dq_cuda(*args, **kw),
              *fa.flash_dkv_cuda(*args, **kw)):
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return name, h.hexdigest(), (q, k, v), args, kw


def flash_rows(cs, dev) -> dict:
    """The bias-free tensor-core flash kernels at ``cs.FLASH_SHAPES``:
    device ms a call and the digest of their outputs (seeded inputs on
    the card; the kernels are deterministic)."""
    import torch
    from fpga_ai_nic_tpu_torch.ops import flash_attention as fa
    rows = {}
    for si in range(len(cs.FLASH_SHAPES)):
        name, digest, (q, k, v), args, kw = flash_case(cs, dev, si)
        rows[name] = {"digest": digest, "device_ms": {
            "flash_fwd": cs.device_ms(lambda: fa.flash_fwd_cuda(
                q, k, v, **kw), 10, ("flash_fwd_kernel",)),
            "flash_dq": cs.device_ms(lambda: fa.flash_dq_cuda(*args, **kw),
                                     10, ("flash_dq_kernel",)),
            "flash_dkv": cs.device_ms(lambda: fa.flash_dkv_cuda(
                *args, **kw), 10, ("flash_dkv_kernel",))}}
        del q, k, v, args
    torch.cuda.empty_cache()
    return rows


def flash64_digests(cs, dev) -> dict:
    """sha256 of the head_dim-64 tensor-core forward's out and lse and of
    dq, with and without a padding mask as key bias, at BERT-base's
    attention shape on inputs and valid lengths drawn with numpy (seed
    400), so two checkouts' head_dim-64 forward and dq compare bit for
    bit.  dk/dv is left out: a tree from before its head_dim-64 kernel
    has none."""
    import hashlib
    import numpy as np
    import torch
    from fpga_ai_nic_tpu_torch.ops import flash_attention as fa
    B, H, S, hd = cs.BERT_SHAPE
    rng = np.random.default_rng(400)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (B, H, S, hd), np.float32)).to(dev).to(torch.bfloat16)
        for _ in range(4))
    lens = torch.from_numpy(rng.integers(cs.BERT_PAD_MIN, S + 1, B)).to(dev)
    bias = torch.where(torch.arange(S, device=dev)[None, :] < lens[:, None],
                       0.0, -1e30).to(torch.float32).contiguous()
    digests = {}
    for name, b in (("bias", bias), ("no_bias", None)):
        kw = dict(causal=False, sm_scale=hd ** -0.5, key_bias=b)
        out, lse = fa.flash_fwd_cuda(q, k, v, **kw)
        delta = (do.float() * out.float()).sum(-1)
        h = hashlib.sha256()
        for t in (out, lse, fa.flash_dq_cuda(q, k, v, do, lse, delta, **kw)):
            h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
        digests[name] = h.hexdigest()
    return digests


# (source, kernel): the head_dim-128 kernels whose SASS must not move
FLASH_SASS = (("flash_attn.cu", "flash_fwd_kernel"),
              ("flash_bwd.cu", "flash_dq_kernel"),
              ("flash_bwd.cu", "flash_dkv_kernel"))


def flash_sass(cs) -> dict:
    """SASS instructions, registers and local bytes of the head_dim-128
    tensor-core flash kernels, without (``ILb0``) and with (``ILb1``) the
    key bias, and of the paged prefill.  This tree names the
    instantiations ``...ILb0ELi128ELb0E`` (the last flag: the q/k offsets;
    their ``ELb1E`` instantiations are reported apart, as
    ``..._offsets``); a tree from before the offsets ``...ILb0ELi128E``,
    and one from before a kernel's head-dim parameter ``...ILb0EE``
    (dk/dv gained it after the forward and dq).  A function takes the
    first pattern its name holds."""
    out = {}
    for src, name in FLASH_SASS:
        for flag in ("ILb0", "ILb1"):
            offs = name + flag + "ELi128ELb1E"
            pats = (name + flag + "ELi128ELb0E", offs,
                    name + flag + "ELi128E", name + flag + "EE")
            st = cs.sass_stats(src, pats)
            hit = [p for p in pats if p != offs and st[p]["instructions"]]
            if len(hit) != 1:
                raise RuntimeError(f"{src}: {len(hit)} kernels match {pats}")
            out[name + flag] = dict(st[hit[0]], matched=hit[0])
            if st[offs]["instructions"]:
                out[name + flag + "_offsets"] = dict(st[offs], matched=offs)
    out.update(cs.sass_stats("paged_attend.cu", ("paged_prefill_kernel",)))
    return out


# (source, C entry, the constant's text and the blocks an SM to try)
FLASH64_BLOCKS = (
    ("flash_attn.cu", "flash_fwd", "FWD_BLOCKS = D == 128 ? 1 : ", (1, 2)),
    ("flash_bwd.cu", "flash_dq", "DQ_BLOCKS = D == 128 ? 2 : ", (2, 3, 4)),
    ("flash_bwd.cu", "flash_dkv", "DKV_BLOCKS = D == 128 ? 2 : ",
     (2, 3, 4)))


def flash64_blocks(cs, dev) -> dict:
    """The head_dim-64 forward, dq and dk/dv built for each blocks-an-SM
    count of
    ``FLASH64_BLOCKS`` (the source's own among them): device ms a call at
    BERT-base's attention shape with the key bias, registers, local bytes
    and SASS instructions of the bias instantiation, and whether the
    outputs equal the port's build bit for bit."""
    import re
    import torch
    from fpga_ai_nic_tpu_torch.ops import _build
    from fpga_ai_nic_tpu_torch.ops import flash_attention as fa
    from fpga_ai_nic_tpu_torch.ops._build import ptr
    B, H, S, hd = cs.BERT_SHAPE
    g = torch.Generator(device=dev).manual_seed(500)
    q, k, v, do = (torch.randn((B, H, S, hd), generator=g, device=dev).to(
        torch.bfloat16) for _ in range(4))
    bias, _ = cs.padding_bias(dev, B, S, cs.BERT_PAD_MIN, 501)
    kw = dict(causal=False, sm_scale=hd ** -0.5, key_bias=bias)
    ref_out, lse = fa.flash_fwd_cuda(q, k, v, **kw)
    delta = (do.float() * ref_out.float()).sum(-1)
    ref_dq = fa.flash_dq_cuda(q, k, v, do, lse, delta, **kw)
    ref_dkv = torch.cat(fa.flash_dkv_cuda(q, k, v, do, lse, delta, **kw))
    out = torch.empty_like(q)
    lse2 = torch.empty_like(lse)
    dq = torch.empty_like(q)
    dkv = torch.empty_like(ref_dkv)   # dk, then dv
    head = (B * H, 1, H, S, S, 0, hd ** -0.5, hd, 0, 0)   # ..., offsets
    launch_args = {
        "flash_fwd": ((ptr(q), ptr(k), ptr(v), ptr(bias), ptr(out),
                       ptr(lse2)) + head, (out, ref_out)),
        "flash_dq": ((ptr(q), ptr(k), ptr(v), ptr(do), ptr(lse),
                      ptr(delta), ptr(bias), ptr(dq)) + head, (dq, ref_dq)),
        "flash_dkv": ((ptr(q), ptr(k), ptr(v), ptr(do), ptr(lse),
                       ptr(delta), ptr(bias), ptr(dkv[:B]), ptr(dkv[B:]))
                      + head, (dkv, ref_dkv))}
    kernels = {"flash_fwd": fa.FLASH_FWD, "flash_dq": fa.FLASH_DQ,
               "flash_dkv": fa.FLASH_DKV}
    rows = {}
    for src, name, text, counts in FLASH64_BLOCKS:
        code = (_build.CSRC / src).read_text()
        m = re.search(re.escape(text) + r"(\d+);", code)
        if m is None:
            raise RuntimeError(f"{src}: no '{text}N;' to vary")
        for n in counts:
            var = _build.BUILD_DIR / f"{name}_blocks{n}.cu"
            var.write_text(code.replace(m.group(0), f"{text}{n};"))
            lib = _build.BUILD_DIR / f"{name}_blocks{n}.{os.getpid()}.so"
            subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I",
                            str(_build.CSRC), "-o", str(lib), str(var)],
                           check=True, timeout=600)
            fn = getattr(ctypes.CDLL(str(lib)), name + "_launch")
            fn.argtypes = kernels[name].argtypes
            fn.restype = ctypes.c_int
            args, (got, ref) = launch_args[name]

            def call():
                err = fn(*args, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name} ({n} blocks) launch: {err}")

            call()
            torch.cuda.synchronize()
            kern = name + "_kernelILb1ELi64ELb0E"
            rows[f"{name} {n} blocks"] = dict(
                cs.sass_stats(src, (kern,), lib=lib)[kern],
                device_ms=cs.device_ms(call, 10, (name + "_kernel",)),
                source_default=n == int(m.group(1)),
                bits_equal_port=bool(torch.equal(got, ref)))
    del q, k, v, do, out, dq, dkv, ref_out, ref_dq, ref_dkv
    torch.cuda.empty_cache()
    return rows


def ring_rows(cs, dev) -> dict:
    """The ring reduce-scatter kernel of the imported tree: SASS of its B=16
    instantiations, output digests, device time (SGD) at two shapes."""
    import torch
    from fpga_ai_nic_tpu_torch import optim
    from fpga_ai_nic_tpu_torch.ops import _build, ring_cuda
    from fpga_ai_nic_tpu_torch.utils.config import BFPConfig, OptimizerConfig
    _build.build(("ring_rs.cu",))
    out = {"sass": cs.ring_rs_sass(hasattr(ring_cuda, "ABLATE_MASKS")),
           "digests": cs.ring_rs_digests(dev)}
    hyper = optim.fused_hyperparams(
        OptimizerConfig(kind="sgd", learning_rate=0.1), 0, device=dev)
    for label, L in (("4MiB", 1 << 20), ("mlp", 41_975_808)):
        g = torch.Generator(device=dev).manual_seed(11)
        x = torch.randn((8, L), generator=g, device=dev)
        w = torch.randn((8, L // 8), generator=g, device=dev) * 0.02
        out[label + "_device_ms"] = cs.device_ms(
            lambda: ring_cuda.ring_reduce_scatter_update_fused(
                x, w, {}, hyper, opt_kind="sgd",
                compression=BFPConfig(codec="pallas")), 20,
            ("ring_rs_kernel",))
        del x, w
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose port is timed")
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--step", action="store_true")
    ap.add_argument("--flash", action="store_true")
    ap.add_argument("--flash64", action="store_true")
    ap.add_argument("--ring", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("codec_probe: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    cs = load_chip_smoke()
    from fpga_ai_nic_tpu_torch.ops import _build, bfp_cuda, int8_cuda
    if not _build.__file__.startswith(root + os.sep):
        raise RuntimeError(f"imported {_build.__file__}, not under {root}")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[0]
    out = {"root": root, "card": smi}
    if args.ring:
        out["ring"] = ring_rows(cs, dev)
        cs.emit(phase="probe_ring", **out["ring"])
        print(json.dumps(out), flush=True)
        return 0
    _build.build(("int8_codec.cu", "bfp_codec.cu"))
    cs.emit(phase="probe_start", **out)

    N = cs.INT8_PATH_ELEMS
    g = torch.Generator(device=dev).manual_seed(1)
    data = {"chip_smoke": cs.int8_inputs(dev, N, N % 1000),
            "normal": torch.randn(N, generator=g, device=dev) * torch.pow(
                10.0, torch.randint(-3, 3, (N,), generator=g,
                                    device=dev).float())}
    enc_names = ("int8_encode_kernel",)
    for label, x in data.items():
        for rounding in int8_cuda.ROUNDINGS:
            out[f"int8_encode {rounding} {label}"] = time_row(
                cs, lambda: int8_cuda.int8_encode(x, 16, rounding, 0),
                enc_names)
    x = data["chip_smoke"]
    q, s = int8_cuda.int8_encode(x)
    out["int8_decode"] = time_row(cs, lambda: int8_cuda.int8_decode(q, s),
                                  ("int8_decode_kernel",))
    if args.control:
        launch = build_control(_build)
        q2 = torch.empty_like(q)
        s2 = torch.empty_like(s)
        stream = torch.cuda.current_stream().cuda_stream

        def control():
            if launch(x.data_ptr(), q2.data_ptr(), s2.data_ptr(), N, stream):
                raise RuntimeError("copy control launch failed")

        out["copy_control"] = time_row(cs, control, ("copy_control_kernel",))
        del q2, s2
    del data, x, q, s
    for label, n_el in (("bfp_encode", 41_975_808), ("bfp_decode",
                                                     41_975_808 // 8)):
        gb = torch.Generator(device=dev).manual_seed(0)
        xb = torch.randn(n_el, generator=gb, device=dev) * 3
        xb[::97] = 0
        xb[5::131] *= 1e-39
        m, e = bfp_cuda.bfp_encode(xb)
        fn = ((lambda: bfp_cuda.bfp_encode(xb)) if label == "bfp_encode"
              else (lambda: bfp_cuda.bfp_decode(m, e)))
        out[label] = dict(time_row(cs, fn, (label + "_kernel",)),
                          elems=n_el)
        del xb, m, e
    torch.cuda.empty_cache()
    for name, row in out.items():
        if isinstance(row, dict):
            cs.emit(phase="probe_time", kernel=name, **row)
    # the parent's encode takes the rounding at run time (one instantiation,
    # ILi16EEv); this one as a template argument (Lb0E stochastic, Lb1E
    # nearest)
    out["sass"] = cs.sass_stats("int8_codec.cu", cs.INT8_SASS_KERNELS
                                + ("int8_encode_kernelILi16EEv",),
                                cs.CONVERT_OPS)
    cs.emit(phase="probe_sass", sass=out["sass"])
    if args.step:
        out["int8_step"] = int8_step(cs, dev)
        cs.emit(phase="probe_step", **out["int8_step"])
    if args.flash:
        _build.build(("flash_attn.cu", "flash_bwd.cu"))
        out["flash"] = flash_rows(cs, dev)
        cs.emit(phase="probe_flash", **out["flash"])
        out["flash64_digests"] = flash64_digests(cs, dev)
        cs.emit(phase="probe_flash64_digests", **out["flash64_digests"])
        out["flash_sass"] = flash_sass(cs)
        cs.emit(phase="probe_flash_sass", sass=out["flash_sass"])
    if args.flash64:
        _build.build(("flash_attn.cu", "flash_bwd.cu"))
        out["flash64_blocks"] = flash64_blocks(cs, dev)
        cs.emit(phase="probe_flash64_blocks", **out["flash64_blocks"])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
