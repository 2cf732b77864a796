"""Fused BFP ring collectives over virtual ranks on one card — the port of
the JAX package's ``ops/ring_pallas.py``.

The n ranks are the rows of a stacked ``[n, L]`` tensor in one device's
memory.  Each collective is one launch (``csrc/ring_rs.cu``,
``csrc/ring_ag.cu``): with the sublane BFP block inside one tile, every
output element depends only on the inputs at the same offset of each
rank's chunks, so one thread runs the whole ring for its quad and the
frames a hop would put on the wire stay in its registers, with the same
bits.  The TPU kernels come in VMEM-resident and HBM-streaming twins that
compute the same function bit for bit; residency is a VMEM concern Hopper
does not share, so each pair is one CUDA kernel here.  Wire frames use
the "sublane" BFP layout whatever ``BFPConfig.codec`` says, as the TPU
kernels do.

Bit spec: ``ops.ring_golden`` with ``layout="sublane"``, composed with
``optim.golden_fused_apply`` for the fused update.  Each public function
takes the plain version (``*_plain``: the ``ops.ring`` rings with the
plain sublane codec and ``optim.fused_apply_flat``) for a tensor on the
CPU and launches the kernels for a tensor on CUDA; there is no fallback
between the two.  ``RING_RS.launches`` / ``RING_AG.launches`` count
kernel launches, one per call.

``integrity=True`` on the reduce-scatter adds the checksum pair of the TPU
kernel's ``integrity`` output: ``pair [n, 2]`` (int64 holding uint32), each
rank's weighted frame checksums of what it sent and what it received,
defined in ``csrc/ring_rs.cu`` with a frame of ``slice_elems`` elements
(``pick_slice_elems``, as the fused route picks it).  The plain version
computes the same pair through ``ops.ring.ring_reduce_scatter_pair``, the
numpy twin is ``ops.ring_golden.ring_reduce_scatter_pair``, and
``ops.integrity.conservation_ok(pair[:, 0], pair[:, 1])`` is the verdict.
The gradient, master and moment bits are those of integrity off.

``loopback_microbench`` / ``loopback_update_microbench`` are the TPU
module's stage-attribution instruments: with ``ablate=`` one stage of the
reduce-scatter's chain walk is compiled in (``csrc/ring_rs.cu``, the
stage mask its last template parameter; ``ABLATE_MASKS``), and
``ops.ring_cost.decompose`` combines the variants' times.  Their outputs
are garbage by design, so they launch on a CUDA tensor only; each ablated
launch counts on ``RING_RS_ABLATE.launches`` and on ``ABLATE_LAUNCHES``
by (form, stage).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Optional, Tuple

import torch

from . import bfp_cuda
from . import integrity as integrity_lib
from . import ring as ring_ops
from ._build import Kernel, ptr
from .. import optim
from ..utils.config import BFPConfig, CollectiveConfig, OptimizerSpec

LANES = bfp_cuda.LANES
OPT_CODES = {None: 0, "sgd": 1, "momentum": 2, "adamw": 3}
# the frame size the checksum pair falls back to, as a target for
# pick_slice_elems: the collective's default slice
DEFAULT_SLICE = CollectiveConfig.slice_elems

RING_RS = Kernel("ring_rs_update", "ring_rs.cu", "ring_rs_launch",
                 [ctypes.c_void_p] * 9
                 + [ctypes.c_int, ctypes.c_longlong] + [ctypes.c_int] * 4
                 + [ctypes.c_void_p, ctypes.c_longlong])
RING_AG = Kernel("ring_ag", "ring_ag.cu", "ring_ag_launch",
                 [ctypes.c_void_p] * 2
                 + [ctypes.c_int, ctypes.c_longlong] + [ctypes.c_int] * 3)
RING_RS_ABLATE = Kernel("ring_rs_ablate", "ring_rs.cu",
                        "ring_rs_ablate_launch",
                        [ctypes.c_void_p] * 9
                        + [ctypes.c_int, ctypes.c_longlong]
                        + [ctypes.c_int] * 5)

# csrc/ring_rs.cu's Stage flags, and each ablate= stage as a mask of them.
# Streaming: JAX's _rs_stream_kernel do_* sets (encode = ld + enc, decode =
# stld + dec + wb, hbm = ld + stld + wb).  Resident: the TPU's resident
# kernel moves x in and g out through the pallas_call's own DMAs whatever
# ablate says, so each of its stages carries ld, stld and wb.
ST_LD, ST_ENC, ST_RDMA, ST_STLD, ST_DEC, ST_WB, ST_UPD = (
    1, 2, 4, 8, 16, 32, 64)
_IO = ST_LD | ST_STLD | ST_WB
ABLATE_MASKS = {
    True: {"skeleton": 0, "encode": ST_LD | ST_ENC, "rdma": ST_RDMA,
           "decode": ST_STLD | ST_DEC | ST_WB, "hbm": _IO,
           "update": ST_UPD},
    False: {"skeleton": _IO, "encode": _IO | ST_ENC,
            "rdma": _IO | ST_RDMA, "decode": _IO | ST_DEC,
            "update": _IO | ST_UPD},
}
# launches of each ablated instantiation, by (streaming, stage)
ABLATE_LAUNCHES: Dict[Tuple[bool, str], int] = {}


def _cfg(compression: Optional[BFPConfig]) -> BFPConfig:
    return compression or BFPConfig()


def _plain_codec(cfg: BFPConfig):
    """The sublane codec pinned to its plain torch version."""
    from ..compress.bfp import BFPCodec
    return BFPCodec(dataclasses.replace(cfg, codec="pallas"), plain=True)


def _check_chunk(C: int, cfg: BFPConfig) -> None:
    tile = cfg.block_size * LANES
    if C % tile:
        raise ValueError(f"fused ring needs chunk {C} % {tile} == 0 "
                         "(whole (block, 128)-lane tiles per rank)")


def pick_slice_elems(C: int, target: int, block_size: int) -> int:
    """Largest divisor of chunk C that is a multiple of block_size*128 and
    <= target (at least one tile).  Slicing at block boundaries never
    changes the block partition: a schedule choice, not a numerics one."""
    tile = block_size * LANES
    if C % tile:
        raise ValueError((C, tile))
    k = C // tile
    best, d = 1, 1
    while d * d <= k:
        if k % d == 0:
            for c in (d, k // d):
                if c * tile <= target and c > best:
                    best = c
        d += 1
    return best * tile


def _frame_slice(C: int, cfg: BFPConfig, slice_elems: Optional[int]) -> int:
    """The pair's frame: ``slice_elems`` when given (whole tiles dividing C),
    else ``pick_slice_elems(C, DEFAULT_SLICE)``."""
    if slice_elems is None:
        return pick_slice_elems(C, DEFAULT_SLICE, cfg.block_size)
    if C % slice_elems or slice_elems % (cfg.block_size * LANES):
        raise ValueError(f"slice_elems {slice_elems} must be whole "
                         f"(block, 128)-lane tiles dividing the chunk {C}")
    return slice_elems


def frame_checksums(wire) -> torch.Tensor:
    """[n]: each rank's frame checksum as ``csrc/ring_rs.cu`` defines it,
    over the sublane codec's (mantissa [n, S], scale [n, S/B]) rows: the
    mantissa bytes then the scale bytes, one zero-extended word each.  In
    plain torch on any device (part of the kernel's plain version)."""
    mant, scale = wire
    return integrity_lib.row_checksums_plain([torch.cat(
        [mant.view(torch.uint8), scale.view(torch.uint8)], dim=1)])


# -- plain versions -----------------------------------------------------------

def ring_reduce_scatter_update_plain(
        x: torch.Tensor, w_own: Optional[torch.Tensor],
        opt_state: Dict[str, torch.Tensor], hyper: Optional[torch.Tensor],
        *, opt_kind: Optional[str], compression: Optional[BFPConfig] = None,
        slice_elems: Optional[int] = None, integrity: bool = False):
    """``(g_own_sum [n, C], w_new, new_state)``, and the checksum pair
    ``[n, 2]`` last with ``integrity``; w_new and new_state are None / {}
    when ``opt_kind`` is None."""
    n, L = x.shape
    cfg = _cfg(compression)
    codec = _plain_codec(cfg)
    if integrity:
        slice_elems = _frame_slice(L // n, cfg, slice_elems)
        g, sa, ra = ring_ops.ring_reduce_scatter_pair(
            x, codec, slice_elems, frame_checksums)
        tail = (torch.stack([sa, ra], dim=1),)
    else:
        g = ring_ops.ring_reduce_scatter(x, codec, slice_elems=slice_elems)
        tail = ()
    if opt_kind is None:
        return (g, None, {}) + tail
    w_new, st = optim.fused_apply_flat(OptimizerSpec(kind=opt_kind), w_own,
                                       g, opt_state, hyper, n)
    return (g, w_new, st) + tail


def ring_all_gather_plain(owned: torch.Tensor,
                          compression: Optional[BFPConfig] = None
                          ) -> torch.Tensor:
    return ring_ops.ring_all_gather(owned, _plain_codec(_cfg(compression)))


# -- kernel launches ----------------------------------------------------------

def _launch_rs(x: torch.Tensor, cfg: BFPConfig, opt_kind: Optional[str],
               w_own: Optional[torch.Tensor],
               state: Tuple[torch.Tensor, ...],
               hyper: Optional[torch.Tensor],
               pair_slice: Optional[int] = None,
               ablate: Optional[Tuple[bool, str]] = None):
    """One launch; ``pair_slice`` (a frame's elements) adds the checksum
    pair as a fourth output; ``ablate`` ((streaming, stage)) launches
    that stage's instantiation instead (``ABLATE_MASKS``)."""
    n, L = x.shape
    C = L // n
    B = cfg.block_size
    bfp_cuda.check_kernel_block(B)
    bfp_cuda.check_cuda(x, torch.float32, "x")
    dev = x.device
    g_out = torch.empty((n, C), dtype=torch.float32, device=dev)
    w_out = None
    outs: Tuple[torch.Tensor, ...] = ()
    if opt_kind is not None:
        bfp_cuda.check_cuda(w_own, torch.float32, "w_own")
        bfp_cuda.check_cuda(hyper, torch.float32, "hyper")
        if hyper.numel() != optim.HYPER_LEN:
            raise ValueError(f"hyper must hold {optim.HYPER_LEN} values")
        for t in (w_own,) + state:
            bfp_cuda.check_cuda(t, torch.float32, "optimizer shard")
            if t.shape != (n, C):
                raise ValueError(f"shards must be {(n, C)}, got "
                                 f"{tuple(t.shape)}")
        w_out = torch.empty_like(w_own)
        outs = tuple(torch.empty_like(s) for s in state)
    m_in, v_in = (state + (None, None))[:2]
    m_out, v_out = (outs + (None, None))[:2]

    def p(t):
        return None if t is None else ptr(t)

    if ablate is not None:
        streaming, stage = ablate
        RING_RS_ABLATE(ptr(x), ptr(g_out), p(w_own), p(w_out), p(m_in),
                       p(m_out), p(v_in), p(v_out), p(hyper), n, C, B,
                       cfg.mantissa_bits, int(cfg.rounding == "rtz"),
                       OPT_CODES[opt_kind], ABLATE_MASKS[streaming][stage])
        ABLATE_LAUNCHES[ablate] = ABLATE_LAUNCHES.get(ablate, 0) + 1
        return g_out, w_out, outs
    pair = tps = None
    if pair_slice is not None:
        if n > 6144:
            raise ValueError("the checksum pair's per-block table holds at "
                             "most 6144 ranks")
        pair = torch.zeros((n, 2), dtype=torch.int32, device=dev)
        tps = pair_slice // (B * LANES)
    RING_RS(ptr(x), ptr(g_out), p(w_own), p(w_out), p(m_in), p(m_out),
            p(v_in), p(v_out), p(hyper), n, C, B, cfg.mantissa_bits,
            int(cfg.rounding == "rtz"), OPT_CODES[opt_kind], p(pair), tps or 0)
    if pair is None:
        return g_out, w_out, outs
    return g_out, w_out, outs, pair.to(torch.int64) & integrity_lib.MASK32


def _launch_ag(owned: torch.Tensor, cfg: BFPConfig) -> torch.Tensor:
    n, C = owned.shape
    bfp_cuda.check_kernel_block(cfg.block_size)
    bfp_cuda.check_cuda(owned, torch.float32, "owned")
    out = torch.empty((n, n * C), dtype=torch.float32, device=owned.device)
    RING_AG(ptr(owned), ptr(out), n, C, cfg.block_size, cfg.mantissa_bits,
            int(cfg.rounding == "rtz"))
    return out


# -- public entry points ------------------------------------------------------

def ring_reduce_scatter_update_fused(
        x: torch.Tensor, w_own: torch.Tensor,
        opt_state: Dict[str, torch.Tensor], hyper: torch.Tensor, *,
        opt_kind: str, compression: Optional[BFPConfig] = None,
        slice_elems: Optional[int] = None, integrity: bool = False):
    """Fused ring reduce-scatter + ZeRO-1 optimizer update on the final
    hop.  x: [n, L] gradients, rank i's in row i; w_own and each state
    shard: [n, C] owned shards (C = L/n); hyper: ``optim.fused_hyperparams``.
    Returns ``(g_own_sum [n, C], w_new [n, C], new_state)`` with new
    tensors (nothing is updated in place), and with ``integrity`` the
    checksum pair ``[n, 2]`` of ``slice_elems``-element frames last."""
    cfg = _cfg(compression)
    spec = OptimizerSpec(kind=opt_kind)
    n, L = x.shape
    if n < 2 or L % n:
        raise ValueError(f"need n >= 2 ranks and L % n == 0, got {x.shape}")
    _check_chunk(L // n, cfg)
    if x.device.type == "cpu":
        return ring_reduce_scatter_update_plain(
            x, w_own, opt_state, hyper, opt_kind=opt_kind, compression=cfg,
            slice_elems=slice_elems, integrity=integrity)
    state = tuple(opt_state[k] for k in spec.state_keys)
    res = _launch_rs(x, cfg, opt_kind, w_own, state, hyper,
                     _frame_slice(L // n, cfg, slice_elems) if integrity
                     else None)
    return (res[0], res[1], dict(zip(spec.state_keys, res[2]))) + res[3:]


def ring_reduce_scatter_fused(x: torch.Tensor, *,
                              compression: Optional[BFPConfig] = None,
                              slice_elems: Optional[int] = None,
                              integrity: bool = False):
    """Fused BFP ring reduce-scatter: [n, L] -> [n, L/n] sums; with
    ``integrity``, ``(sums, pair [n, 2])``."""
    cfg = _cfg(compression)
    n, L = x.shape
    if L % n:
        raise ValueError(f"need L % n == 0, got {x.shape}")
    _check_chunk(L // n, cfg)
    if n == 1:
        return (x, torch.zeros((1, 2), dtype=torch.int64,
                               device=x.device)) if integrity else x
    if x.device.type == "cpu":
        res = ring_reduce_scatter_update_plain(
            x, None, {}, None, opt_kind=None, compression=cfg,
            slice_elems=slice_elems, integrity=integrity)
    else:
        res = _launch_rs(x, cfg, None, None, (), None,
                         _frame_slice(L // n, cfg, slice_elems) if integrity
                         else None)
    return (res[0], res[3]) if integrity else res[0]


def ring_all_gather_fused(owned: torch.Tensor, *,
                          compression: Optional[BFPConfig] = None
                          ) -> torch.Tensor:
    """Fused BFP ring all-gather: [n, C] owned chunks -> [n, n*C], every
    rank's replica, all bitwise equal.  n == 1 is the codec roundtrip."""
    cfg = _cfg(compression)
    _check_chunk(owned.shape[1], cfg)
    if owned.device.type == "cpu":
        return ring_all_gather_plain(owned, cfg)
    return _launch_ag(owned, cfg)


def ring_all_reduce_fused(x: torch.Tensor, *,
                          compression: Optional[BFPConfig] = None
                          ) -> torch.Tensor:
    """Fused all-reduce = fused reduce-scatter + fused all-gather."""
    return ring_all_gather_fused(
        ring_reduce_scatter_fused(x, compression=compression),
        compression=compression)


# -- stage attribution (ablate=) ----------------------------------------------

def _check_loopback(x: torch.Tensor, virtual_n: int, cfg: BFPConfig,
                    slice_elems: int, streaming: bool,
                    ablate: Optional[str]) -> int:
    """JAX's loopback validation; returns the chunk C."""
    if x.dim() != 2 or x.shape[0] != virtual_n or x.shape[1] % virtual_n:
        raise ValueError(f"x must be [virtual_n={virtual_n}, L] with L % "
                         f"virtual_n == 0, got {tuple(x.shape)}")
    C = x.shape[1] // virtual_n
    if C % slice_elems or slice_elems % (cfg.block_size * LANES):
        raise ValueError((C, slice_elems, cfg.block_size * LANES))
    if ablate == "hbm" and not streaming:
        raise ValueError("'hbm' ablates the streaming kernel's slice "
                         "load/store stages; the resident kernel has none")
    if ablate is not None and ablate not in ABLATE_MASKS[streaming]:
        raise ValueError(f"unknown ablate stage {ablate!r}")
    if ablate is not None and x.device.type != "cuda":
        raise ValueError("ablate= variants are timing instruments of the "
                         "CUDA kernel (their outputs are garbage by design): "
                         "give them a CUDA tensor")
    return C


def loopback_microbench(x: torch.Tensor, virtual_n: int = 4, *,
                        compression: Optional[BFPConfig] = None,
                        slice_elems: int = 8192, streaming: bool = False,
                        ablate: Optional[str] = None) -> torch.Tensor:
    """The fused reduce-scatter of ``virtual_n`` ranks on one card, for
    timing: x [virtual_n, L] (the ranks' gradient rows; JAX's takes one
    device's [L] and addresses every hop to itself) -> [virtual_n, L /
    virtual_n].  ``ablate=None`` is the kernel itself (``ring_rs_kernel``,
    its plain version on a CPU tensor); ``ablate=`` one of
    ``ops.ring_cost.stages_for(streaming)`` but "update" compiles in that
    stage alone (``ABLATE_MASKS``), with a garbage result.
    ``streaming`` picks JAX's HBM-streaming stage sets ("hbm" exists only
    there); the card runs one kernel for both forms.  ``slice_elems`` is
    validated as JAX's (whole tiles dividing the chunk) and changes nothing
    here: the kernel's frames never leave a thread's registers."""
    cfg = _cfg(compression)
    if ablate == "update":
        raise ValueError("ablate='update' needs a fused optimizer "
                         "(loopback_update_microbench)")
    _check_loopback(x, virtual_n, cfg, slice_elems, streaming, ablate)
    if ablate is None:
        return ring_reduce_scatter_fused(x, compression=cfg)
    return _launch_rs(x, cfg, None, None, (), None,
                      ablate=(streaming, ablate))[0]


def loopback_update_microbench(x: torch.Tensor, virtual_n: int = 4, *,
                               opt_kind: str = "adamw",
                               hyper: Optional[torch.Tensor] = None,
                               compression: Optional[BFPConfig] = None,
                               slice_elems: int = 8192,
                               streaming: bool = False,
                               ablate: Optional[str] = None
                               ) -> torch.Tensor:
    """``loopback_microbench`` with the fused optimizer: zero master and
    state shards [virtual_n, C] updated where each chunk's sum completes;
    returns the updated masters (garbage when ablated).  ``ablate`` adds
    "update", the optimizer stage alone.  ``hyper`` defaults to JAX's
    (``optim.fused_hyperparams`` at lr 1e-3, step 0)."""
    cfg = _cfg(compression)
    spec = OptimizerSpec(kind=opt_kind)
    C = _check_loopback(x, virtual_n, cfg, slice_elems, streaming, ablate)
    if hyper is None:
        from ..utils.config import OptimizerConfig
        hyper = optim.fused_hyperparams(
            OptimizerConfig(kind=opt_kind, learning_rate=1e-3), 0,
            device=x.device)
    w = torch.zeros((virtual_n, C), dtype=torch.float32, device=x.device)
    st = {k: torch.zeros_like(w) for k in spec.state_keys}
    if ablate is None:
        return ring_reduce_scatter_update_fused(
            x, w, st, hyper, opt_kind=opt_kind, compression=cfg)[1]
    return _launch_rs(x, cfg, opt_kind, w,
                      tuple(st[k] for k in spec.state_keys), hyper,
                      ablate=(streaming, ablate))[1]


def _rs_op_stream(n: int, S: int, depth: Optional[int]):
    """The flat ring reduce-scatter's op stream and slot window, from the
    one emitter (``verify.opstream.rs_op_stream``, at the JAX package's
    Pallas ring's default depth)."""
    from ..verify import opstream as _opstream
    return _opstream.rs_op_stream(n, S, depth)


def simulate_rs_protocol(n: int, S: int, depth: Optional[int] = None,
                         seed: int = 0, max_events: int = 2_000_000) -> int:
    """Race/deadlock check of the ring's credit protocol at model level:
    the RS op stream on n simulated nodes under a randomized scheduler
    with blocking semaphores and asynchronous wire transfers (a started
    transfer lands at an arbitrary later scheduler event).  Fails with a
    ``verify.mc.Violation`` (an AssertionError) on deadlock, a recv- or
    send-slot overwrite, or a decode that finds another emission than the
    schedule expects; returns the number of scheduler events on success.

    The randomized mode of the model checker (``verify.mc.run_random``),
    with the JAX package's legacy settings: no credit-bound assert and no
    at-exit strictness (the exhaustive checker owns boundedness and
    leaks).  The protocol is the JAX package's Pallas ring's: this card's
    loopback ring keeps each frame in a thread's registers and runs no
    slot window."""
    from ..verify import mc as _mc
    from ..verify import opstream as _opstream
    ops, n_slots = _rs_op_stream(n, S, depth)
    model = _opstream.RingModel(
        n, ops, n_slots,
        meta={"n": n, "S": S, "depth": depth, "seed": seed})
    model.credit_bound = len(ops)
    model.strict_terminal = False
    return _mc.run_random(model, seed=seed, max_events=max_events)
