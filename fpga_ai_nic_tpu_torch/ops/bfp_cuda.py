"""The "sublane" BFP codec: CUDA kernels and their plain torch versions —
the port of the JAX package's ``ops/bfp_pallas.py``.

Layout (``ops.bfp_golden``, ``layout="sublane"``): a tile of B*128
consecutive elements holds 128 blocks, block (t, l) being the B elements
128 apart at lane l; its scale sits at t*128 + l.  Bit for bit equal to
the golden model.

``bfp_encode`` / ``bfp_decode`` take the plain version for a tensor on the
CPU and launch the kernel (``csrc/bfp_codec.cu``) for a tensor on CUDA —
there is no fallback between the two.  ``ENCODE.launches`` /
``DECODE.launches`` count kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ._build import Kernel, ptr
from .bfp import decode_blocks, encode_blocks

LANES = 128
KERNEL_BLOCK_SIZES = (2, 4, 8, 16, 32)

ENCODE = Kernel("bfp_encode", "bfp_codec.cu", "bfp_encode_launch",
                [ctypes.c_void_p] * 3
                + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int])
DECODE = Kernel("bfp_decode", "bfp_codec.cu", "bfp_decode_launch",
                [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int])


def _check_tiled(n: int, block_size: int) -> None:
    if n % (block_size * LANES):
        raise ValueError(f"sublane layout needs a flat length divisible by "
                         f"{block_size * LANES}, got {n}")


def _sublane(x: torch.Tensor, block_size: int) -> torch.Tensor:
    """Flat [N] -> blocks [N/(B*128), 128, B] (a strided view)."""
    return x.reshape(-1, block_size, LANES).transpose(1, 2)


# -- plain versions ---------------------------------------------------------

def bfp_encode_plain(x: torch.Tensor, block_size: int = 16,
                     mantissa_bits: int = 8, rounding: str = "nearest"
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    n = x.shape[0]
    _check_tiled(n, block_size)
    q, se = encode_blocks(_sublane(x.to(torch.float32), block_size),
                          mantissa_bits, rounding)
    return q.transpose(1, 2).reshape(n), se.reshape(n // block_size)


def bfp_decode_plain(mant: torch.Tensor, scale: torch.Tensor,
                     block_size: int = 16,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    n = mant.shape[0]
    _check_tiled(n, block_size)
    x = decode_blocks(_sublane(mant, block_size),
                      scale.reshape(-1, LANES))
    return x.transpose(1, 2).reshape(n).to(dtype)


# -- kernel launches (shared with ops.ring_cuda) ----------------------------

def check_cuda(t: torch.Tensor, dtype: torch.dtype, name: str) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def check_kernel_block(block_size: int) -> None:
    if block_size not in KERNEL_BLOCK_SIZES:
        raise ValueError(f"CUDA BFP kernels take block_size in "
                         f"{KERNEL_BLOCK_SIZES}, got {block_size}")


def launch_encode(x: torch.Tensor, mant: torch.Tensor, scale: torch.Tensor,
                  block_size: int, mantissa_bits: int, rounding: str) -> None:
    """Encode flat f32 ``x`` into the preallocated ``mant`` / ``scale``."""
    n = x.numel()
    check_kernel_block(block_size)
    _check_tiled(n, block_size)
    check_cuda(x, torch.float32, "x")
    check_cuda(mant, torch.int8, "mant")
    check_cuda(scale, torch.int8, "scale")
    if mant.numel() != n or scale.numel() != n // block_size:
        raise ValueError("encode output sizes do not match the input")
    if rounding not in ("nearest", "rtz") or not 2 <= mantissa_bits <= 8:
        raise ValueError((rounding, mantissa_bits))
    ENCODE(ptr(x), ptr(mant), ptr(scale), n, block_size, mantissa_bits,
           int(rounding == "rtz"))


def launch_decode(mant: torch.Tensor, scale: torch.Tensor, out: torch.Tensor,
                  block_size: int) -> None:
    """Decode into the preallocated f32 ``out`` (same length as mant)."""
    n = mant.numel()
    check_kernel_block(block_size)
    _check_tiled(n, block_size)
    check_cuda(mant, torch.int8, "mant")
    check_cuda(scale, torch.int8, "scale")
    check_cuda(out, torch.float32, "out")
    if out.numel() != n or scale.numel() != n // block_size:
        raise ValueError("decode operand sizes do not match")
    DECODE(ptr(mant), ptr(scale), ptr(out), n, block_size)


# -- public wrappers ----------------------------------------------------------

def bfp_encode(x: torch.Tensor, block_size: int = 16, mantissa_bits: int = 8,
               rounding: str = "nearest"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat f32 [N] (N % (B*128) == 0) -> (int8 [N], int8 [N/B])."""
    if x.device.type == "cpu":
        return bfp_encode_plain(x, block_size, mantissa_bits, rounding)
    n = x.shape[0]
    mant = torch.empty(n, dtype=torch.int8, device=x.device)
    scale = torch.empty(n // block_size, dtype=torch.int8, device=x.device)
    launch_encode(x, mant, scale, block_size, mantissa_bits, rounding)
    return mant, scale


def bfp_decode(mant: torch.Tensor, scale: torch.Tensor, block_size: int = 16,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    if mant.device.type == "cpu":
        return bfp_decode_plain(mant, scale, block_size, dtype)
    if dtype != torch.float32:
        raise TypeError(f"the decode kernel writes float32, not {dtype}")
    out = torch.empty(mant.shape[0], dtype=torch.float32, device=mant.device)
    launch_decode(mant, scale, out, block_size)
    return out
