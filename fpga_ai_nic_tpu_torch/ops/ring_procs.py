"""The fused BFP ring with its ranks as processes — the port of the JAX
package's cross-device ring (``ops/ring_pallas.py``: a rank a device, each
hop a ``make_async_remote_copy`` to ``device_id=right``).

Each process holds one rank's ``[L]`` row.  The reduce-scatter runs
``ops.ring_golden.ring_reduce_scatter(layout="sublane")``'s schedule, one
launch a hop: rank i's launch k works on chunk ``(i - k - 1) mod n``,
launch 0 encodes x's chunk and sends it, launches 1 .. n-2 add the frame
that arrived from rank i-1 into x's chunk (``x + decode(frame)``) and send
the encoded sum, launch n-1 lands on the owned chunk i, whose sum is the
reduced gradient, and runs the fused update there
(``optim.golden_fused_apply``).  The all-gather encodes the owned chunk
once, forwards each frame verbatim and decodes frame j into slot j of the
replica (``ring_all_gather(layout="sublane")``).  A frame is the loopback
kernels' wire (``csrc/ring_rs.cu``'s checksum frame): slice s of the chunk
(``ring_cuda.pick_slice_elems``) as its int8 mantissas then its int8 scale
exponents; without a codec the chunk's raw f32 bytes.

The hop functions ``rs_hop`` / ``ag_hop`` launch ``csrc/ring_hop.cu`` on a
CUDA row (``RING_HOP_RS`` / ``RING_HOP_AG`` count the launches) and take
their plain versions (``*_plain``) on a CPU row; there is no fallback
between the two.  The transport is chosen by the row's device, never by
fallback:

- ``GlooPort`` (CPU rows, the plain version): the frame is sent with
  ``torch.distributed.isend`` / ``irecv`` over a gloo group.
- ``IpcPort`` (CUDA rows): each rank allocates two receive buffers, the
  handles go round the gloo group (``torch.multiprocessing.reductions.
  reduce_tensor`` through ``all_gather_object``), and a hop's kernel
  stores its frame straight into the right neighbour's buffer.  A hop is
  synchronous: launch, synchronise the stream, then a barrier on the gloo
  group, so the frame a launch reads was written whole; the buffers
  alternate by hop parity, since rank i writes hop k's frame while rank
  i+1 still reads hop k-1's, and a collective ends with one more barrier
  so the next one's first frame overwrites nothing still being read.
  Every rank keeps its buffers until ``close``'s final barrier, after
  which no peer holds a handle.
- ``LoopbackPorts`` (tests): n ranks in one process, each rank's sends
  writing into the next rank's buffers, the caller stepping every rank
  through launch k before launch k+1.

A port's buffers are sized once, for the largest frame its ring will
carry (``open_ring(max_frame=)``): every collective of a ``ProcRing``
takes its own ``Wire`` (a DDP bucket's chunk), its frames the first
``frame_bytes`` of those buffers, so the handles go round once for all
the buckets.  ``ProcRing.all_reduce`` is the reduce-scatter without an
update, then the all-gather of the owned sum:
``ring_cuda.ring_all_reduce_fused`` as 2n hops.

``rank_gather`` is the small exchange of sync-BN's moments: every
process's tensor, stacked in rank order, over the gloo group on CPU
copies (``RANK_GATHERS`` counts the calls and their host seconds).

``proc_device`` places process i on ``cuda:i`` when the host has n cards
(peer access between them), else every process on ``cuda:0``; only the
one-card form has run (an H100 host with one card): the form with a card
a process is unverified.  NCCL is not used.  Overlapping hops (the slot
and credit discipline of ``verify/opstream.py``) is later work.
"""

from __future__ import annotations

import ctypes
import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import torch

from . import bfp_cuda
from ._build import Kernel, ptr
from .ring_cuda import DEFAULT_SLICE, LANES, OPT_CODES, pick_slice_elems
from .. import optim
from ..utils.config import BFPConfig, OptimizerSpec

RING_HOP_RS = Kernel("ring_hop_rs", "ring_hop.cu", "ring_hop_rs_launch",
                     [ctypes.c_void_p] * 11
                     + [ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong]
                     + [ctypes.c_int] * 4)
RING_HOP_AG = Kernel("ring_hop_ag", "ring_hop.cu", "ring_hop_ag_launch",
                     [ctypes.c_void_p] * 4
                     + [ctypes.c_longlong, ctypes.c_longlong]
                     + [ctypes.c_int] * 3)


@dataclasses.dataclass(frozen=True)
class Wire:
    """A ring's chunk and frame: ``C`` elements a chunk, ``cfg`` the BFP
    codec (None: raw f32), ``slice_elems`` a frame slice."""

    C: int
    cfg: Optional[BFPConfig]

    @property
    def slice_elems(self) -> int:
        if self.cfg is None:
            return self.C
        return pick_slice_elems(self.C, DEFAULT_SLICE, self.cfg.block_size)

    @property
    def frame_bytes(self) -> int:
        if self.cfg is None:
            return 4 * self.C
        return self.C + self.C // self.cfg.block_size


def wire_for(C: int, cfg: Optional[BFPConfig]) -> Wire:
    if cfg is not None:
        bfp_cuda.check_kernel_block(cfg.block_size)
        if C % (cfg.block_size * LANES):
            raise ValueError(f"the ring's chunk {C} is not whole "
                             f"({cfg.block_size}, 128)-lane tiles")
    return Wire(C, cfg)


# -- frames (plain) -----------------------------------------------------------

def encode_frame(x: torch.Tensor, wire: Wire, out: torch.Tensor) -> None:
    """The frame of a [C] f32 chunk into ``out`` (uint8 [frame_bytes])."""
    if wire.cfg is None:
        out.view(torch.float32).copy_(x)
        return
    cfg, se = wire.cfg, wire.slice_elems
    mant, scale = bfp_cuda.bfp_encode_plain(x, cfg.block_size,
                                            cfg.mantissa_bits, cfg.rounding)
    S = wire.C // se
    out.view(S, se + se // cfg.block_size).copy_(torch.cat(
        [mant.view(torch.uint8).view(S, se),
         scale.view(torch.uint8).view(S, se // cfg.block_size)], dim=1))


def decode_frame(frame: torch.Tensor, wire: Wire) -> torch.Tensor:
    """A frame's [C] f32 values."""
    if wire.cfg is None:
        return frame.view(torch.float32).clone()
    cfg, se = wire.cfg, wire.slice_elems
    S = wire.C // se
    f = frame.view(S, se + se // cfg.block_size)
    mant = f[:, :se].reshape(-1).view(torch.int8)
    scale = f[:, se:].reshape(-1).view(torch.int8)
    return bfp_cuda.bfp_decode_plain(mant, scale, cfg.block_size)


# -- the hops -----------------------------------------------------------------

def _check_hop(x: torch.Tensor, frames, wire: Wire) -> None:
    if x.shape != (wire.C,) or x.dtype != torch.float32:
        raise ValueError(f"a hop takes a [{wire.C}] f32 chunk, got "
                         f"{tuple(x.shape)} {x.dtype}")
    for f in frames:
        if f is not None and (f.dtype != torch.uint8
                              or f.shape != (wire.frame_bytes,)):
            raise ValueError(f"a frame is uint8 [{wire.frame_bytes}]")


def rs_hop_plain(x, recv, send, wire: Wire, *, n: int,
                 last: bool = False, w=None, state=None, hyper=None,
                 opt_kind: Optional[str] = None):
    """``rs_hop``'s plain version."""
    v = x if recv is None else x + decode_frame(recv, wire)
    if send is not None:
        encode_frame(v, wire, send)
    if not last:
        return None
    g = v.clone()
    if opt_kind is None:
        return g, None, {}
    w_new, st = optim.fused_apply_flat(OptimizerSpec(kind=opt_kind), w, g,
                                       state, hyper, n)
    return g, w_new, st


def rs_hop(x: torch.Tensor, recv: Optional[torch.Tensor],
           send: Optional[torch.Tensor], wire: Wire, *, n: int,
           last: bool = False, w: Optional[torch.Tensor] = None,
           state: Optional[Dict[str, torch.Tensor]] = None,
           hyper: Optional[torch.Tensor] = None,
           opt_kind: Optional[str] = None):
    """One reduce-scatter hop of this rank: ``x`` its row's [C] chunk for
    this launch, ``recv`` the frame that arrived (None at launch 0),
    ``send`` where the outgoing frame goes (the neighbour's buffer; None
    at the last launch).  The last launch returns ``(g_sum [C], w_new,
    new_state)`` (w_new None and new_state {} without an optimizer); the
    others None."""
    _check_hop(x, (recv, send), wire)
    if x.device.type == "cpu":
        return rs_hop_plain(x, recv, send, wire, n=n, last=last, w=w,
                            state=state, hyper=hyper, opt_kind=opt_kind)
    spec = OptimizerSpec(kind=opt_kind) if opt_kind else None
    g = w_out = None
    outs: Tuple[torch.Tensor, ...] = ()
    st_in: Tuple[torch.Tensor, ...] = ()
    if last:
        g = torch.empty_like(x)
        if spec is not None:
            for t in (w, hyper) + tuple(state[k] for k in spec.state_keys):
                bfp_cuda.check_cuda(t, torch.float32, "optimizer operand")
            if hyper.numel() != optim.HYPER_LEN:
                raise ValueError(f"hyper must hold {optim.HYPER_LEN} values")
            st_in = tuple(state[k] for k in spec.state_keys)
            w_out = torch.empty_like(w)
            outs = tuple(torch.empty_like(t) for t in st_in)
    m_in, v_in = (st_in + (None, None))[:2]
    m_out, v_out = (outs + (None, None))[:2]

    def p(t):
        return None if t is None else ptr(t)

    cfg = wire.cfg
    tps = wire.slice_elems // (cfg.block_size * LANES) if cfg else 0
    RING_HOP_RS(ptr(x), p(recv), p(send), p(g), p(w), p(w_out), p(m_in),
                p(m_out), p(v_in), p(v_out), p(hyper), n, wire.C, tps,
                cfg.block_size if cfg else 0, cfg.mantissa_bits if cfg else 8,
                int(cfg is not None and cfg.rounding == "rtz"),
                OPT_CODES[opt_kind])
    if not last:
        return None
    if spec is None:
        return g, None, {}
    return g, w_out, dict(zip(spec.state_keys, outs))


def ag_hop_plain(owned, recv, send, out, wire: Wire) -> None:
    """``ag_hop``'s plain version."""
    if recv is None:
        frame = torch.empty(wire.frame_bytes, dtype=torch.uint8,
                            device=owned.device)
        encode_frame(owned, wire, frame)
    else:
        frame = recv
    if send is not None:
        send.copy_(frame)
    out.copy_(decode_frame(frame, wire))


def ag_hop(owned: torch.Tensor, recv: Optional[torch.Tensor],
           send: Optional[torch.Tensor], out: torch.Tensor,
           wire: Wire) -> None:
    """One all-gather hop: with ``recv`` None encode ``owned`` (the [C]
    master chunk), else take the arrived frame; forward it to ``send``
    unchanged (None at the last launch) and decode it into ``out`` (the
    replica's [C] slot of the frame's origin)."""
    _check_hop(owned, (recv, send), wire)
    if out.shape != (wire.C,) or out.dtype != torch.float32:
        raise ValueError(f"the slot must be [{wire.C}] f32")
    if owned.device.type == "cpu":
        return ag_hop_plain(owned, recv, send, out, wire)
    cfg = wire.cfg
    tps = wire.slice_elems // (cfg.block_size * LANES) if cfg else 0
    RING_HOP_AG(ptr(owned), None if recv is None else ptr(recv),
                None if send is None else ptr(send), ptr(out), wire.C, tps,
                cfg.block_size if cfg else 0, cfg.mantissa_bits if cfg else 8,
                int(cfg is not None and cfg.rounding == "rtz"))
    return None


# -- the transports -----------------------------------------------------------

class GlooPort:
    """One rank's frames over a gloo group: sends from a local staging
    buffer with ``isend``, receives into two local buffers with ``irecv``.
    ``frame_bytes``: the largest frame (the buffers' size)."""

    def __init__(self, rank: int, n: int, frame_bytes: int, group=None):
        self.rank, self.n, self.group = rank, n, group
        self.frame_bytes = frame_bytes
        self.bufs = torch.zeros((2, frame_bytes), dtype=torch.uint8)
        self.stage = torch.zeros(frame_bytes, dtype=torch.uint8)

    def recv(self, k: int) -> torch.Tensor:
        return self.bufs[k % 2]

    def send(self, k: int) -> torch.Tensor:
        return self.stage

    def done(self, k: int, nbytes: int) -> None:
        """Hop k's frame (its first ``nbytes``) to the right neighbour,
        the left one's into ``recv(k)``."""
        import torch.distributed as dist
        reqs = [dist.isend(self.stage[:nbytes], (self.rank + 1) % self.n,
                           group=self.group),
                dist.irecv(self.bufs[k % 2, :nbytes],
                           (self.rank - 1) % self.n, group=self.group)]
        for r in reqs:
            r.wait()

    def fence(self) -> None:
        """Nothing to wait for: ``done`` returns when both transfers have."""

    def close(self) -> None:
        import torch.distributed as dist
        dist.barrier(group=self.group)


class IpcPort:
    """One rank's frames in CUDA IPC peer buffers: a hop's kernel writes
    into the right neighbour's ``bufs[k % 2]``, opened from its handle.
    ``frame_bytes``: the largest frame (the buffers' size)."""

    def __init__(self, rank: int, n: int, frame_bytes: int,
                 device: torch.device, group=None):
        import torch.distributed as dist
        from torch.multiprocessing.reductions import reduce_tensor
        self.rank, self.n, self.group, self.device = rank, n, group, device
        self.frame_bytes = frame_bytes
        self.bufs = torch.zeros((2, frame_bytes), dtype=torch.uint8,
                                device=device)
        torch.cuda.synchronize(device)
        handles: List = [None] * n
        dist.all_gather_object(handles, reduce_tensor(self.bufs),
                               group=group)
        rebuild, args = handles[(rank + 1) % n]
        self.peer = rebuild(*args)
        dist.barrier(group=group)

    def recv(self, k: int) -> torch.Tensor:
        return self.bufs[k % 2]

    def send(self, k: int) -> torch.Tensor:
        return self.peer[k % 2]

    def done(self, k: int, nbytes: int = 0) -> None:
        """The hop's frame is in the neighbour's memory for every rank."""
        import torch.distributed as dist
        torch.cuda.current_stream(self.device).synchronize()
        dist.barrier(group=self.group)

    def fence(self) -> None:
        self.done(-1)

    def close(self) -> None:
        """Every rank drops its peer's handle, then (after the barrier)
        may free its own buffers."""
        import torch.distributed as dist
        torch.cuda.synchronize(self.device)
        dist.barrier(group=self.group)
        del self.peer
        torch.cuda.synchronize(self.device)
        dist.barrier(group=self.group)


class LoopbackPorts:
    """n ranks in one process (tests): rank r's sends land in rank r+1's
    buffers, as the peer stores of ``IpcPort`` do."""

    def __init__(self, n: int, frame_bytes: int, device="cpu"):
        self.bufs = [torch.zeros((2, frame_bytes), dtype=torch.uint8,
                                 device=device) for _ in range(n)]
        self.n, self.frame_bytes = n, frame_bytes

    def port(self, rank: int) -> "_LoopbackPort":
        return _LoopbackPort(self, rank)


class _LoopbackPort:
    def __init__(self, group: LoopbackPorts, rank: int):
        self.g, self.rank = group, rank
        self.frame_bytes = group.frame_bytes

    def recv(self, k: int) -> torch.Tensor:
        return self.g.bufs[self.rank][k % 2]

    def send(self, k: int) -> torch.Tensor:
        return self.g.bufs[(self.rank + 1) % self.g.n][k % 2]

    def done(self, k: int, nbytes: int = 0) -> None:
        """The caller steps every rank through a launch before the next."""

    def fence(self) -> None:
        pass

    def close(self) -> None:
        pass


# -- one rank's ring ----------------------------------------------------------

class ProcRing:
    """Rank ``rank`` of an n-rank ring over ``port`` (one of the transports
    above), for [n C] rows.  ``rs_launch`` / ``ag_launch`` are one launch
    each (the hop functions); ``reduce_scatter_update``, ``all_gather``
    and ``all_reduce`` run them with the port's exchange between them.
    ``wire`` is the default wire; each call may take another whose frame
    fits the port's buffers.  ``seconds``: host time inside the
    collectives, from their first launch to their fence."""

    def __init__(self, rank: int, n: int, wire: Wire, port):
        if n < 2:
            raise ValueError("a ring across processes needs n >= 2")
        self.rank, self.n, self.wire, self.port = rank, n, wire, port
        self._check_wire(wire)
        self.seconds = 0.0

    def _check_wire(self, wire: Wire) -> Wire:
        if wire.frame_bytes > self.port.frame_bytes:
            raise ValueError(f"a frame of {wire.frame_bytes} bytes does not "
                             f"fit the port's {self.port.frame_bytes}")
        return wire

    def _chunk(self, row: torch.Tensor, c: int, wire: Wire) -> torch.Tensor:
        return row[c * wire.C:(c + 1) * wire.C]

    def _frames(self, k: int, wire: Wire):
        F = wire.frame_bytes
        return (self.port.recv(k - 1)[:F] if k > 0 else None,
                self.port.send(k)[:F] if k < self.n - 1 else None)

    def rs_launch(self, k: int, x: torch.Tensor, w=None, state=None,
                  hyper=None, opt_kind: Optional[str] = None,
                  wire: Optional[Wire] = None):
        wire = wire or self.wire
        recv, send = self._frames(k, wire)
        return rs_hop(self._chunk(x, (self.rank - k - 1) % self.n, wire),
                      recv, send, wire, n=self.n, last=k == self.n - 1, w=w,
                      state=state, hyper=hyper, opt_kind=opt_kind)

    def ag_launch(self, k: int, owned: torch.Tensor, replica: torch.Tensor,
                  wire: Optional[Wire] = None) -> None:
        wire = wire or self.wire
        recv, send = self._frames(k, wire)
        ag_hop(owned, recv, send,
               self._chunk(replica, (self.rank - k) % self.n, wire), wire)

    def reduce_scatter_update(self, x: torch.Tensor, w=None, state=None,
                              hyper=None, opt_kind: Optional[str] = None,
                              wire: Optional[Wire] = None):
        """This rank's ``(g_sum [C], w_new, new_state)`` of the ring
        reduce-scatter of the ranks' ``[n C]`` rows ``x``, the update on
        its owned chunk (``opt_kind`` None: no update, ``(g_sum, None,
        {})``)."""
        wire = self._check_wire(wire or self.wire)
        if x.shape != (self.n * wire.C,):
            raise ValueError(f"a row is [{self.n * wire.C}], got "
                             f"{tuple(x.shape)}")
        t0 = time.perf_counter()
        for k in range(self.n):
            res = self.rs_launch(k, x, w, state, hyper, opt_kind, wire)
            if k < self.n - 1:
                self.port.done(k, wire.frame_bytes)
        self.port.fence()
        self.seconds += time.perf_counter() - t0
        return res

    def all_gather(self, owned: torch.Tensor,
                   wire: Optional[Wire] = None) -> torch.Tensor:
        """This rank's [n C] replica: slot j the decoded frame of rank j's
        owned chunk."""
        wire = self._check_wire(wire or self.wire)
        replica = torch.empty(self.n * wire.C, dtype=torch.float32,
                              device=owned.device)
        t0 = time.perf_counter()
        for k in range(self.n):
            self.ag_launch(k, owned, replica, wire)
            if k < self.n - 1:
                self.port.done(k, wire.frame_bytes)
        self.port.fence()
        self.seconds += time.perf_counter() - t0
        return replica

    def all_reduce(self, x: torch.Tensor,
                   wire: Optional[Wire] = None) -> torch.Tensor:
        """This rank's [n C] sums of the ranks' ``[n C]`` rows: the
        reduce-scatter without an update, then the all-gather of the owned
        sum (on BFP frames the gather rounds each sum once), as
        ``ring_cuda.ring_all_reduce_fused`` computes every rank's row."""
        g, _, _ = self.reduce_scatter_update(x, wire=wire)
        return self.all_gather(g, wire)

    def close(self) -> None:
        self.port.close()


@dataclasses.dataclass
class ExchangeCount:
    """Calls of an exchange and their host seconds."""

    calls: int = 0
    seconds: float = 0.0


RANK_GATHERS = ExchangeCount()


def rank_gather(t: torch.Tensor, world: int, group=None) -> torch.Tensor:
    """Every process's ``t`` (one shape and dtype in all), stacked in rank
    order: ``[world, *t.shape]`` on ``t``'s device.  The gloo group carries
    CPU copies (a card's tensor is copied to the host first, which waits
    for it); no library all-reduce, so any sum over the stack is the
    caller's, in rank order.  Every process must call it at the same
    point of its program."""
    import torch.distributed as dist
    t0 = time.perf_counter()
    mine = t.detach().to("cpu").contiguous()
    parts = [torch.empty_like(mine) for _ in range(world)]
    dist.all_gather(parts, mine, group=group)
    out = torch.stack(parts).to(t.device)
    RANK_GATHERS.calls += 1
    RANK_GATHERS.seconds += time.perf_counter() - t0
    return out


def proc_device(rank: int, n: int, device="cuda") -> torch.device:
    """Process ``rank``'s device: the CPU when asked, else ``cuda:rank``
    when the host has n cards (each pair given peer access when a
    buffer is opened), else ``cuda:0`` for every process."""
    d = torch.device(device)
    if d.type == "cpu":
        return d
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass device='cpu'")
    return torch.device("cuda", rank if torch.cuda.device_count() >= n
                        else 0)


def open_ring(rank: int, n: int, C: int, cfg: Optional[BFPConfig],
              device: torch.device, group=None,
              max_frame: int = 0) -> ProcRing:
    """This process's rank of the ring (default wire: chunk ``C``, codec
    ``cfg``), its transport chosen by the rows' device: gloo sends for CPU
    rows, CUDA IPC peer buffers for CUDA rows, sized for the larger of the
    wire's frame and ``max_frame`` (other wires' frames)."""
    wire = wire_for(C, cfg)
    F = max(wire.frame_bytes, max_frame)
    if device.type == "cpu":
        port = GlooPort(rank, n, F, group)
    else:
        port = IpcPort(rank, n, F, device, group)
    return ProcRing(rank, n, wire, port)
