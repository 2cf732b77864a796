"""Torch implementation of the "flat16" BFP codec (blocks of consecutive
elements) — the port of the JAX package's ``ops/bfp.py``.

Plain tensor code that runs on any device.  Bit for bit equal to
``ops.bfp_golden`` with ``layout="flat16"`` (tests/test_torch_bfp.py).
``encode_blocks`` / ``decode_blocks`` are the block arithmetic shared with
the "sublane" layout's plain versions in ``ops.bfp_cuda``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..utils.config import BFPConfig


def biased_exponent(x: torch.Tensor) -> torch.Tensor:
    """IEEE-754 biased exponent field of f32 values (int32, 0..255)."""
    return (x.to(torch.float32).view(torch.int32) >> 23) & 0xFF


def exp2_int(e: torch.Tensor) -> torch.Tensor:
    """2.0**e for int32 e in [-126, 127], exactly, via the exponent bits."""
    return ((e.to(torch.int32) + 127) << 23).view(torch.float32)


def encode_blocks(xb: torch.Tensor, mantissa_bits: int = 8,
                  rounding: str = "nearest"
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., B] f32 blocks -> (int8 mantissas [..., B], int8 scales [...]).
    torch.round rounds half to even, as jnp.round and np.rint do."""
    emax = biased_exponent(xb).amax(dim=-1)
    scale_e = torch.clamp(emax - 127 - (mantissa_bits - 2), -126, 126)
    q = xb * exp2_int(-scale_e).unsqueeze(-1)
    if rounding == "nearest":
        q = torch.round(q)
    elif rounding == "rtz":
        q = torch.trunc(q)
    else:
        raise ValueError(rounding)
    lim = float(2 ** (mantissa_bits - 1) - 1)
    return (torch.clamp(q, -lim, lim).to(torch.int8),
            scale_e.to(torch.int8))


def decode_blocks(mb: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of encode_blocks: int8 [..., B] x 2**scale[...] -> f32."""
    return mb.to(torch.float32) * exp2_int(scale).unsqueeze(-1)


def _blocked(x: torch.Tensor, block: int) -> torch.Tensor:
    if x.shape[-1] % block:
        raise ValueError(f"last dim {x.shape[-1]} not a multiple of {block}")
    return x.reshape(*x.shape[:-1], x.shape[-1] // block, block)


def bfp_encode(x: torch.Tensor, block_size: int = 16, mantissa_bits: int = 8,
               rounding: str = "nearest"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 [..., n] -> (int8 mantissas [..., n], int8 scales [..., n/B])."""
    x = x.to(torch.float32)
    mant, scale = encode_blocks(_blocked(x, block_size), mantissa_bits,
                                rounding)
    return mant.reshape(x.shape), scale


def bfp_decode(mant: torch.Tensor, scale_exp: torch.Tensor,
               block_size: int = 16,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    x = decode_blocks(_blocked(mant, block_size), scale_exp)
    return x.reshape(mant.shape).to(dtype)


def bfp_roundtrip(x: torch.Tensor, cfg: BFPConfig) -> torch.Tensor:
    """decode(encode(x)) — the quantization the wire applies."""
    mant, se = bfp_encode(x, cfg.block_size, cfg.mantissa_bits, cfg.rounding)
    return bfp_decode(mant, se, cfg.block_size, x.dtype)


class _BfpSte(torch.autograd.Function):
    """BFP quantization forward, identity backward."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, block_size: int,
                mantissa_bits: int) -> torch.Tensor:
        mant, se = bfp_encode(x, block_size, mantissa_bits)
        return bfp_decode(mant, se, block_size, x.dtype)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return g, None, None


def bfp_ste(x: torch.Tensor, block_size: int = 16,
            mantissa_bits: int = 8) -> torch.Tensor:
    """Straight-through estimator: ``bfp_decode(bfp_encode(x))`` (the flat
    layout, round to nearest) in the forward pass, the incoming gradient
    unchanged in the backward, so a model trains through a simulated
    compressed channel."""
    return _BfpSte.apply(x, block_size, mantissa_bits)


def pad_to_block(x: torch.Tensor, block_size: int
                 ) -> Tuple[torch.Tensor, int]:
    """Flatten + zero-pad to a block multiple: ``(flat, pad)``."""
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % block_size
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat, pad


def wire_bytes(n_elems: int, cfg: BFPConfig) -> int:
    """Bytes on the wire: mantissas + one scale byte per block."""
    assert n_elems % cfg.block_size == 0
    mant_bytes = (n_elems * cfg.mantissa_bits + 7) // 8
    return mant_bytes + n_elems // cfg.block_size
