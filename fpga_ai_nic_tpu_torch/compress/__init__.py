"""Pluggable gradient-compression codecs for the port's rings: the Codec
protocol and registry (``compress.base``) with BFP (``compress.bfp``),
int8 (``compress.int8``) and top-k (``compress.topk``) registered, and
their numpy goldens (``compress.golden``)."""

from .base import (Codec, as_codec, available_codecs, get_codec,  # noqa: F401
                   register, resolve)
from . import base, bfp, int8, topk  # noqa: F401
from .bfp import BFPCodec  # noqa: F401
from .int8 import Int8Codec  # noqa: F401
from .topk import TopKCodec  # noqa: F401

__all__ = ["Codec", "BFPCodec", "Int8Codec", "TopKCodec", "register",
           "get_codec", "available_codecs", "resolve", "as_codec", "base",
           "bfp", "int8", "topk"]
