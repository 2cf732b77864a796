"""Per-block-scaled int8 quantization with stochastic rounding — the port of
the JAX package's ``compress/int8.py`` (the EQuARX-style low-bit codec).

Wire format per block of ``block_size`` f32 values: int8 values plus one
bf16 linear scale, ``scale = bf16(max|x| * f32(1/127))`` (1.0 for an
all-zero block).  The decode product ``q * scale`` has at most 15
significand bits, so it is exact in f32 and immune to fused multiply-adds.
Rounding is "stochastic" (``floor(x/scale + u)``, u a hash of the value's
own f32 bits and the seed, so every pass is reproducible and slicing a
hop never changes its bits) or "nearest" (half to even).

Backends, each a distinct bit stream (the block partition differs):

  - "xla" (default): consecutive-element blocks, the "flat16" layout, in
    plain torch on any device (``int8_encode`` / ``int8_decode`` below).
  - "pallas": lane-column blocks, the "sublane" layout of
    ``ops.int8_cuda``: the CUDA kernels on a CUDA tensor, their plain
    versions on a CPU tensor, never one in place of the other.  A payload
    must be a whole number of (block, 128)-lane tiles; the dp=8 canonical
    MLP's rank chunk (5,245,440 = 512 x 10245 elements) is not, and JAX's
    kernel asserts on it too, so the canonical int8 path runs at dp=2.
  - "auto": the sublane kernels for a CUDA tensor whose rank payload is
    whole (block, 128)-lane tiles, else (and always on the CPU) flat16,
    JAX's rule for its TPU kernels.  It pads and joins payloads as flat16
    does.  ``for_payload`` takes the decision, once a collective, on one
    rank's chunk (``compress.base.as_codec``); unpinned it encodes as
    flat16 on the CPU and raises on a CUDA tensor.

``plain=True`` pins the sublane layout to its plain torch version on every
device, as ``BFPCodec(plain=True)`` does, so a kernel is never compared
against itself.  The bit spec is ``compress.golden.int8_encode``.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from .base import Codec, check_pinned, register
from ..ops import int8_cuda


def int8_encode(x: torch.Tensor, block_size: int = 16,
                rounding: str = "stochastic", seed: int = 0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat f32 [n] (n % block == 0) -> (int8 q [n], bf16 scale
    [n/block]), consecutive-element blocks."""
    x = x.to(torch.float32)
    q, scale = int8_cuda.encode_blocks(x.reshape(-1, block_size), rounding,
                                       seed)
    return q.reshape(x.shape), scale


def int8_decode(q: torch.Tensor, scale: torch.Tensor, block_size: int = 16,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    x = int8_cuda.decode_blocks(q.reshape(-1, block_size), scale)
    return x.reshape(q.shape).to(dtype)


@register
class Int8Codec(Codec):
    """Per-block linear int8, stochastic rounding (see module docstring)."""

    name = "int8"
    idempotent = False
    supports_fused = False     # the fused ring's frames carry BFP scales

    def __init__(self, block_size: int = 16, rounding: str = "stochastic",
                 seed: int = 0, backend: str = "xla",
                 error_feedback: bool = False, plain: bool = False) -> None:
        assert rounding in int8_cuda.ROUNDINGS, rounding
        assert backend in ("xla", "pallas", "auto"), backend
        assert block_size >= 2
        self.block_size = int(block_size)
        self.rounding = rounding
        self.seed = int(seed)
        self.backend = backend
        self.error_feedback = bool(error_feedback)
        self.plain = plain

    @property
    def sublane(self) -> bool:
        """The "pallas" backend's lane-column blocks (else flat16)."""
        return self.backend == "pallas"

    def _tiles(self, n_elems: int) -> bool:
        return n_elems % (self.block_size * int8_cuda.LANES) == 0

    def for_payload(self, n_elems: int, device: torch.device) -> "Int8Codec":
        """"auto" pinned for one rank's [n_elems] payload on ``device``:
        "pallas" on a CUDA device where the payload is whole tiles, else
        "xla" (``compress.base.Codec.for_payload``); other backends as
        they are."""
        if self.backend != "auto":
            return self
        pick = ("pallas" if torch.device(device).type == "cuda"
                and self._tiles(n_elems) else "xla")
        return Int8Codec(self.block_size, self.rounding, self.seed, pick,
                         self.error_feedback, self.plain)

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.backend == "auto":
            check_pinned(self.name, x.device)
        if not self.sublane:
            enc = int8_encode
        elif self.plain:
            enc = int8_cuda.int8_encode_plain
        else:
            enc = int8_cuda.int8_encode
        return tuple(enc(x, self.block_size, self.rounding, self.seed))

    def decode(self, payload: Tuple[torch.Tensor, ...], n_elems: int,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
        q, scale = payload
        if self.backend == "auto":
            check_pinned(self.name, q.device)
        if not self.sublane:
            dec = int8_decode
        elif self.plain:
            dec = int8_cuda.int8_decode_plain
        else:
            dec = int8_cuda.int8_decode
        return dec(q, scale, self.block_size, dtype)

    @property
    def pad_elems(self) -> int:
        return self.block_size

    def unit_elems(self, n_elems: int) -> int:
        # the sublane layout's unit is a whole (block, 128)-lane tile
        if self.sublane:
            return self.block_size * int8_cuda.LANES
        return self.block_size

    @property
    def error_bound(self) -> float:
        # grid step = bf16(blockmax/127) <= (1 + 2^-8) * blockmax/127;
        # stochastic floor can land a full step away, nearest half a step
        step = (1.0 + 2.0 ** -8) / 127.0
        return step if self.rounding == "stochastic" else step / 2

    def wire_bytes(self, n_elems: int) -> int:
        assert n_elems % self.block_size == 0
        return n_elems + 2 * (n_elems // self.block_size)

    def describe(self) -> Dict[str, Any]:
        d = super().describe()
        d.update(block_size=self.block_size, rounding=self.rounding,
                 seed=self.seed, backend=self.backend)
        return d
