"""The "sublane" int8 codec: CUDA kernels and their plain torch versions —
the port of the JAX package's ``compress/int8.py`` Pallas backend
(``int8_encode_pallas`` / ``int8_decode_pallas``).

Layout (``compress.golden``, ``layout="sublane"``, shared with BFP's): a
tile of B*128 consecutive f32 holds 128 blocks; block (t, l) is the B
elements ``(t*B + r)*128 + l`` (r = 0..B-1) and its bf16 scale sits at
``t*128 + l``.  A flat length must be a whole number of tiles; the dp=8
canonical MLP is not (its rank chunk of 5,245,440 elements is 512 x 10245),
so that configuration cannot take this layout — JAX's kernel asserts on
it too — and the canonical int8 path runs at dp=2.

Bit contract (``compress.golden.int8_encode``, bit for bit):

    scale = bf16_rne(max|x| * f32(1/127))   (1.0 when max|x| == 0)
    q     = clip(floor(x / scale + u), -127, 127)     "stochastic"
    q     = clip(rint(x / scale), -127, 127)          "nearest"
    x_hat = q * f32(scale)                  (exact: <= 15 significand bits)

where ``u = (murmur3_fmix(bits(x) ^ stamp) >> 8) * 2^-24`` hashes the
value's own f32 bit pattern with ``stamp = seed * 0x9E3779B9 mod 2^32``.
Non-finite gradients are outside the contract: a block holding NaN takes
scale 1.0 (``NaN > 0`` is false, as in the golden) and its NaN elements
cast to int8 as each platform casts NaN.

``int8_encode`` / ``int8_decode`` take the plain version for a tensor on
the CPU and launch the kernel (``csrc/int8_codec.cu``) for a tensor on
CUDA; there is no fallback between the two.  ``ENCODE.launches`` /
``DECODE.launches`` count kernel launches.  Torch has no uint32
arithmetic on the CPU, so the plain hash runs in int64, masked to 32 bits
after every step, with each 32 x 32-bit multiply split into 16-bit halves
so no int64 product overflows.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from ._build import Kernel, ptr
from .bfp_cuda import (LANES, _check_tiled, _sublane, check_cuda,
                       check_kernel_block)

ROUNDINGS = ("stochastic", "nearest")
# f32(1/127): the double rounded once to f32, as the reference spells it
INV127 = np.float32(1.0 / 127.0)
_M32 = 0xFFFFFFFF

ENCODE = Kernel("int8_encode", "int8_codec.cu", "int8_encode_launch",
                [ctypes.c_void_p] * 3
                + [ctypes.c_longlong, ctypes.c_int, ctypes.c_uint,
                   ctypes.c_int])
DECODE = Kernel("int8_decode", "int8_codec.cu", "int8_decode_launch",
                [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int])


def seed_stamp(seed: int) -> int:
    """The 32-bit word the hash mixes into every value's bits."""
    return (seed * 0x9E3779B9) & _M32


# -- plain versions ---------------------------------------------------------

def _mul32(z: torch.Tensor, c: int) -> torch.Tensor:
    """(z * c) mod 2^32 for int64 z in [0, 2^32): c split into 16-bit
    halves keeps every product below 2^48."""
    lo = z * (c & 0xFFFF)
    hi = ((z * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def hash_u01(x: torch.Tensor, seed: int) -> torch.Tensor:
    """f32 values -> the pseudo-uniform f32 in [0, 1) their bit patterns
    hash to (``compress.golden.hash_u01``)."""
    z = (x.view(torch.int32).to(torch.int64) & _M32) ^ seed_stamp(seed)
    z = z ^ (z >> 16)
    z = _mul32(z, 0x85EBCA6B)
    z = z ^ (z >> 13)
    z = _mul32(z, 0xC2B2AE35)
    z = z ^ (z >> 16)
    return (z >> 8).to(torch.float32) * (2.0 ** -24)


def encode_blocks(xb: torch.Tensor, rounding: str = "stochastic",
                  seed: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., B] f32 blocks -> (int8 q [..., B], bf16 scales [...]).
    torch.round rounds half to even, as jnp.round and np.rint do."""
    if rounding not in ROUNDINGS:
        raise ValueError(rounding)
    maxabs = xb.abs().amax(dim=-1)
    inv = torch.tensor(INV127, device=xb.device)
    scale = torch.where(maxabs > 0, maxabs * inv,
                        torch.ones_like(maxabs)).to(torch.bfloat16)
    v = xb / scale.to(torch.float32).unsqueeze(-1)
    if rounding == "stochastic":
        v = torch.floor(v + hash_u01(xb, seed))
    else:
        v = torch.round(v)
    return torch.clamp(v, -127.0, 127.0).to(torch.int8), scale


def decode_blocks(qb: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 [..., B] x f32(scale[...]) -> f32, exact."""
    return qb.to(torch.float32) * scale.to(torch.float32).unsqueeze(-1)


def int8_encode_plain(x: torch.Tensor, block_size: int = 16,
                      rounding: str = "stochastic", seed: int = 0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    n = x.shape[0]
    _check_tiled(n, block_size)
    q, scale = encode_blocks(_sublane(x.to(torch.float32), block_size),
                             rounding, seed)
    return q.transpose(1, 2).reshape(n), scale.reshape(n // block_size)


def int8_decode_plain(q: torch.Tensor, scale: torch.Tensor,
                      block_size: int = 16,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    n = q.shape[0]
    _check_tiled(n, block_size)
    x = decode_blocks(_sublane(q, block_size), scale.reshape(-1, LANES))
    return x.transpose(1, 2).reshape(n).to(dtype)


# -- kernel launches ----------------------------------------------------------

def launch_encode(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                  block_size: int, rounding: str, seed: int) -> None:
    """Encode flat f32 ``x`` into the preallocated ``q`` / ``scale``."""
    n = x.numel()
    check_kernel_block(block_size)
    _check_tiled(n, block_size)
    check_cuda(x, torch.float32, "x")
    check_cuda(q, torch.int8, "q")
    check_cuda(scale, torch.bfloat16, "scale")
    if q.numel() != n or scale.numel() != n // block_size:
        raise ValueError("encode output sizes do not match the input")
    if rounding not in ROUNDINGS:
        raise ValueError(rounding)
    ENCODE(ptr(x), ptr(q), ptr(scale), n, block_size, seed_stamp(seed),
           int(rounding == "nearest"))


def launch_decode(q: torch.Tensor, scale: torch.Tensor, out: torch.Tensor,
                  block_size: int) -> None:
    """Decode into the preallocated f32 ``out`` (same length as q)."""
    n = q.numel()
    check_kernel_block(block_size)
    _check_tiled(n, block_size)
    check_cuda(q, torch.int8, "q")
    check_cuda(scale, torch.bfloat16, "scale")
    check_cuda(out, torch.float32, "out")
    if out.numel() != n or scale.numel() != n // block_size:
        raise ValueError("decode operand sizes do not match")
    DECODE(ptr(q), ptr(scale), ptr(out), n, block_size)


# -- public wrappers ----------------------------------------------------------

def int8_encode(x: torch.Tensor, block_size: int = 16,
                rounding: str = "stochastic", seed: int = 0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat f32 [N] (N % (B*128) == 0) -> (int8 [N], bf16 [N/B])."""
    if x.device.type == "cpu":
        return int8_encode_plain(x, block_size, rounding, seed)
    n = x.shape[0]
    q = torch.empty(n, dtype=torch.int8, device=x.device)
    scale = torch.empty(n // block_size, dtype=torch.bfloat16,
                        device=x.device)
    launch_encode(x, q, scale, block_size, rounding, seed)
    return q, scale


def int8_decode(q: torch.Tensor, scale: torch.Tensor, block_size: int = 16,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    if q.device.type == "cpu":
        return int8_decode_plain(q, scale, block_size, dtype)
    if dtype != torch.float32:
        raise TypeError(f"the decode kernel writes float32, not {dtype}")
    out = torch.empty(q.shape[0], dtype=torch.float32, device=q.device)
    launch_decode(q, scale, out, block_size)
    return out

