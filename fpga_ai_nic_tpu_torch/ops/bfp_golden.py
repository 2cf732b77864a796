"""Numpy golden model of the BFP (block-floating-point) codec.

A copy of the JAX package's ``ops/bfp_golden.py`` (numpy only), kept here
so the port never imports the JAX package.  Bit-for-bit the specification
that the port's torch codecs (``ops.bfp`` "flat16", ``ops.bfp_cuda``
"sublane") and its CUDA kernels (``csrc/bfp_codec.cu``, ``csrc/ring_rs.cu``,
``csrc/ring_ag.cu``) must match.  The reference has no such golden model — its RTL sim golden
compare is documented to FAIL when BFP is enabled (readme.pdf §3.3); we fix
that by making the codec itself the spec.

Semantics (derived from the reference RTL, not translated from it):
the encoder (hw/bf16_to_bfp_core.sv:30-132 as instantiated by
hw/bfp_adapter.sv:134 with MANTISSA_SIZE=24, then truncated to MANT_SIZE=8
at hw/bfp_adapter.sv:150) quantizes each block of ``block_size`` fp32 values
against the block's maximum biased exponent ``emax``:

    scale_exp = emax - 127 - (mantissa_bits - 2)      # int8 two's complement
    q_i       = round_mode(x_i * 2**(-scale_exp))     # fits in [-127, 127]
    x̂_i      = q_i * 2**(scale_exp)                  # decode

For mantissa_bits=8 this is scale_exp = emax - 133: the block maximum lands
in [64, 127], exactly the reference's layout (implicit-1 at bit 6, one bit
of headroom so the two's-complement negation cannot overflow —
hw/bf16_to_bfp_core.sv:109,125).  The decoder (hw/bfp_to_bf16_core.sv:30-125)
renormalizes via leading-zero count; in value terms it is exactly
``q * 2**scale_exp``, which is what we implement.

Deviations from the RTL (deliberate, documented):
- zero/denormal inputs decode to exactly 0 (the RTL feeds {1'b1, frac} even
  for exp=0, so an all-tiny block would decode garbage — known-bug class,
  see SURVEY.md §5 "known bugs"; we do not replicate it).
- rounding="nearest" (ties-to-even) is offered in addition to the RTL's
  truncation ("rtz"); nearest is the default because it halves the expected
  quantization error at identical wire cost.
- storage is (int8 mantissa, int8 scale_exp) rather than the RTL's biased
  uint8 shared exponent; scale_exp = shared_biased - 133 is a relabeling,
  wire size is identical (8 bits per block either way).  The RTL's NX_MODE
  parameter (hw/bf16_to_bfp_core.sv:34,100: report emax-6 instead of emax)
  is another constant relabeling of the same field, so it is subsumed —
  both conventions decode to identical values.
"""

from __future__ import annotations

import numpy as np


LANES = 128  # TPU vector-register lane count (the "sublane" layout's stride)


def _to_blocks(x: np.ndarray, block_size: int, layout: str) -> np.ndarray:
    """Partition into [n_blocks, block_size].

    layout="flat16":  consecutive elements form a block — the reference's
      grouping (one 512-bit beat of 16 fp32, hw/bfp_adapter.sv:129-131).
    layout="sublane": elements stride LANES apart form a block — the TPU
      hardware word: in a (block_size, 128) vector tile each *lane column*
      is one block, so the block max is a sublane reduction on the VPU.
      Used by the Pallas kernel (ops/bfp_pallas.py); same rate, same error
      bounds, different partition.  Scale order: block (tile b, lane l) is
      at index b*LANES + l.
    """
    if layout == "flat16":
        return _split_blocks(x, block_size)
    if layout == "sublane":
        if x.ndim != 1 or x.shape[0] % (block_size * LANES) != 0:
            raise ValueError(
                f"sublane layout needs a flat vector divisible by "
                f"{block_size * LANES}, got {x.shape}")
        return x.reshape(-1, block_size, LANES).transpose(0, 2, 1).reshape(
            -1, block_size)
    raise ValueError(layout)


def _from_blocks(blocks: np.ndarray, shape, block_size: int,
                 layout: str) -> np.ndarray:
    """Inverse of _to_blocks: back to the original element order/shape.
    flat16 keeps leading batch dims ([..., nb, bs]); sublane is flat-only."""
    if layout == "flat16":
        return blocks.reshape(shape)
    return blocks.reshape(-1, LANES, block_size).transpose(0, 2, 1).reshape(
        shape)


def _split_blocks(x: np.ndarray, block_size: int) -> np.ndarray:
    if x.shape[-1] % block_size != 0:
        raise ValueError(f"last dim {x.shape[-1]} not a multiple of block {block_size}")
    return x.reshape(*x.shape[:-1], x.shape[-1] // block_size, block_size)


def biased_exponent(x: np.ndarray) -> np.ndarray:
    """IEEE-754 biased exponent field of fp32 values (0..255)."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits >> 23) & 0xFF).astype(np.int32)


def bfp_encode(x: np.ndarray, block_size: int = 16, mantissa_bits: int = 8,
               rounding: str = "nearest", layout: str = "flat16"):
    """Encode fp32/bf16 array -> (mantissas int8 [x.shape], scale_exp int8
    [n/B]).  Value of element i in block b is ``mant[i] * 2.0**scale_exp[b]``.
    Mantissas keep the input element order for every layout; only the
    block *membership* (and hence the scale array order) depends on layout.
    """
    x = np.asarray(x, np.float32)
    xb = _to_blocks(x, block_size, layout)
    emax = biased_exponent(xb).max(axis=-1)
    scale_exp = emax - 127 - (mantissa_bits - 2)
    # [-126, 126]: int8-storable, exactly representable as a NORMAL fp32 on
    # both encode (2^-s) and decode (2^s) sides — +-127 would need a
    # subnormal reciprocal, which exponent-bitcast implementations (Pallas,
    # C++) cannot form.  Blocks of subnormals quantize to 0.
    scale_exp = np.clip(scale_exp, -126, 126).astype(np.int32)
    inv_scale = np.ldexp(np.float32(1.0), -scale_exp).astype(np.float32)
    q = xb * inv_scale[..., None]
    if rounding == "nearest":
        q = np.rint(q)
    elif rounding == "rtz":
        q = np.trunc(q)
    else:
        raise ValueError(rounding)
    lim = float(2 ** (mantissa_bits - 1) - 1)
    q = np.clip(q, -lim, lim)
    mant = _from_blocks(q.astype(np.int8), x.shape, block_size, layout)
    return mant, scale_exp.astype(np.int8)


def bfp_decode(mant: np.ndarray, scale_exp: np.ndarray, block_size: int = 16,
               dtype=np.float32, layout: str = "flat16") -> np.ndarray:
    """Decode (int8 mantissas, int8 per-block scale exponents) -> float array."""
    mb = _to_blocks(np.asarray(mant, np.int8), block_size, layout)
    scale = scale_exp.astype(np.int32)
    if layout == "sublane":
        scale = scale.reshape(-1)
    x = mb.astype(np.float32) * np.ldexp(np.float32(1.0), scale)[..., None]
    return _from_blocks(x, mant.shape, block_size, layout).astype(dtype)


def wire_bits(n_elems: int, block_size: int = 16, mantissa_bits: int = 8) -> int:
    """Bits on the wire for n_elems values (ref frame: 136b per 16 fp32,
    hw/bfp_adapter.sv:76 BFP_SIZE = EXP_SIZE + NUM_FP*MANT_SIZE)."""
    assert n_elems % block_size == 0
    return (n_elems // block_size) * (8 + block_size * mantissa_bits)
