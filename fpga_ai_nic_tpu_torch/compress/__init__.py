"""Pluggable gradient-compression codecs for the port's rings: the Codec
protocol and registry (``compress.base``) with BFP registered
(``compress.bfp``)."""

from .base import (Codec, as_codec, available_codecs, get_codec,  # noqa: F401
                   register, resolve)
from . import base, bfp  # noqa: F401
from .bfp import BFPCodec  # noqa: F401

__all__ = ["Codec", "BFPCodec", "register", "get_codec", "available_codecs",
           "resolve", "as_codec", "base", "bfp"]
