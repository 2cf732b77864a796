"""BFP as a registered codec — the port of the JAX package's
``compress/bfp.py``.

``BFPConfig.codec`` picks the block partition, and that choice is part of
the bit contract: "xla" is the "flat16" layout (``ops.bfp``, plain torch on
any device), "pallas" the "sublane" layout (``ops.bfp_cuda``: the CUDA
kernels on a CUDA tensor, their plain versions on a CPU tensor).  "auto"
decides per payload, as JAX's ``use_pallas`` does on a TPU: the sublane
kernels for a CUDA tensor whose rank payload is whole (block, 128)-lane
tiles, else (and always on the CPU) the flat16 ops.  ``for_payload``
takes that decision, once a collective, on one rank's chunk
(``compress.base.as_codec``); an unpinned "auto" encodes as flat16 on the
CPU and raises on a CUDA tensor.  "auto" pads a flat vector as flat16
does, so the payloads it decides on are JAX's.
``plain=True`` pins the sublane codec to its plain torch version on every
device — what the fused ring kernels' plain versions use, so that holding
a kernel against its plain version never runs a kernel on both sides.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from .base import Codec, check_pinned, register
from ..ops import bfp as _bfp_flat
from ..ops import bfp_cuda as _bfp_sub
from ..utils.config import BFPConfig


def tiles(cfg: BFPConfig, n_elems: int) -> bool:
    """Is a [n_elems] payload whole (block, 128)-lane tiles?"""
    return n_elems % (cfg.block_size * _bfp_sub.LANES) == 0


def use_pallas(cfg: BFPConfig, n_elems: int) -> bool:
    """Does this [n_elems] payload take the sublane layout on a card?
    "pallas" always; "auto" when the payload is whole tiles (JAX's rule
    for its TPU kernels)."""
    return cfg.codec == "pallas" or (cfg.codec == "auto"
                                     and tiles(cfg, n_elems))


def codec_pair(cfg: BFPConfig, n_elems: int, plain: bool = False
               ) -> Tuple[Callable, Callable]:
    """(encode, decode) for a flat [n_elems] payload."""
    if use_pallas(cfg, n_elems):
        enc_fn = _bfp_sub.bfp_encode_plain if plain else _bfp_sub.bfp_encode
        dec_fn = _bfp_sub.bfp_decode_plain if plain else _bfp_sub.bfp_decode
    else:
        enc_fn, dec_fn = _bfp_flat.bfp_encode, _bfp_flat.bfp_decode

    def enc(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return enc_fn(x, cfg.block_size, cfg.mantissa_bits, cfg.rounding)

    def dec(mant: torch.Tensor, se: torch.Tensor,
            dtype: torch.dtype) -> torch.Tensor:
        return dec_fn(mant, se, cfg.block_size, dtype)

    return enc, dec


@register
class BFPCodec(Codec):
    """Block-floating-point: int8 mantissas + one shared int8 power-of-two
    exponent per block."""

    name = "bfp"
    idempotent = True          # re-quantizing the decoded grid is exact
    error_feedback = False
    supports_fused = True

    def __init__(self, cfg: Optional[BFPConfig] = None,
                 error_feedback: bool = False, plain: bool = False,
                 **overrides: Any) -> None:
        self.cfg = replace(cfg or BFPConfig(), **overrides)
        self.error_feedback = bool(error_feedback)
        self.plain = plain

    def _layout(self, device: torch.device) -> BFPConfig:
        if self.cfg.codec != "auto":
            return self.cfg
        check_pinned(self.name, device)
        return replace(self.cfg, codec="xla")

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        enc, _ = codec_pair(self._layout(x.device), x.shape[0], self.plain)
        return tuple(enc(x))

    def decode(self, payload: Tuple[torch.Tensor, ...], n_elems: int,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
        mant, se = payload
        _, dec = codec_pair(self._layout(mant.device), n_elems, self.plain)
        return dec(mant, se, dtype)

    def for_payload(self, n_elems: int, device: torch.device) -> "BFPCodec":
        """"auto" pinned for one rank's [n_elems] payload on ``device``:
        "pallas" on a CUDA device where the payload takes the sublane
        kernels (``use_pallas``), else "xla".  Any other backend is
        returned as it is."""
        if self.cfg.codec != "auto":
            return self
        pick = ("pallas" if torch.device(device).type == "cuda"
                and use_pallas(self.cfg, n_elems) else "xla")
        return BFPCodec(replace(self.cfg, codec=pick),
                        self.error_feedback, self.plain)

    @property
    def pad_elems(self) -> int:
        return self.cfg.block_size

    def unit_elems(self, n_elems: int) -> int:
        # the sublane layout's unit is a whole (block, 128)-lane tile;
        # "auto" pads and joins payloads as flat16 does (JAX's padding)
        if self.cfg.codec == "pallas":
            return self.cfg.block_size * _bfp_sub.LANES
        return self.cfg.block_size

    @property
    def error_bound(self) -> float:
        # one grid step of the block's scale: 2^(1-m) of the block max
        return 2.0 ** (1 - self.cfg.mantissa_bits)

    def wire_bytes(self, n_elems: int) -> int:
        return _bfp_flat.wire_bytes(n_elems, self.cfg)

    def describe(self) -> Dict[str, Any]:
        d = super().describe()
        d.update(block_size=self.cfg.block_size,
                 mantissa_bits=self.cfg.mantissa_bits,
                 rounding=self.cfg.rounding, backend=self.cfg.codec)
        return d
