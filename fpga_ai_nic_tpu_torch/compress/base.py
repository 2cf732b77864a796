"""Codec protocol + registry — the port of the JAX package's
``compress/base.py``.

The contract is the reference's: ``encode`` maps a flat f32 vector to a
tuple of tensors (the hop payload), ``decode`` inverts it given the element
count; ``pad_elems`` is the alignment of one compression unit;
``supports_fused`` whether the codec may ride the fused ring
kernels (``ops.ring_cuda``).  Only ``bfp`` is registered in this port so
far; asking for another codec the JAX package registers raises
``NotImplementedError``.
"""

from __future__ import annotations

import abc
from typing import Any, Dict, Mapping, Optional, Tuple, Type

import torch

# codecs the JAX package registers that this port has not ported yet
UNPORTED_CODECS = ("int8", "topk")


class Codec(abc.ABC):
    """One gradient-compression wire format (see module docstring)."""

    name: str = ""
    error_feedback: bool = False
    supports_fused: bool = False

    @abc.abstractmethod
    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """Flat f32 [n] (n % pad_elems == 0) -> payload tuple."""

    @abc.abstractmethod
    def decode(self, payload: Tuple[torch.Tensor, ...], n_elems: int,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """Payload tuple -> flat [n_elems] in ``dtype``."""

    def roundtrip(self, x: torch.Tensor) -> torch.Tensor:
        """decode(encode(x)) — the quantization one wire pass applies."""
        return self.decode(self.encode(x), x.shape[0], x.dtype)

    @property
    @abc.abstractmethod
    def pad_elems(self) -> int:
        """Elements per independent compression unit (alignment quantum)."""

    @abc.abstractmethod
    def wire_bytes(self, n_elems: int) -> int:
        """Bytes one encoded [n_elems] payload puts on the wire."""

    def sliceable(self, chunk_elems: int, slice_elems: Optional[int]) -> bool:
        """May a [chunk_elems] hop be sent as [slice_elems] slices with
        identical bits?  True only when slicing cannot change the unit
        partition (and actually splits the chunk)."""
        return (slice_elems is not None
                and chunk_elems > slice_elems
                and chunk_elems % slice_elems == 0
                and slice_elems % self.pad_elems == 0)


_REGISTRY: Dict[str, Type[Codec]] = {}


def register(cls: Type[Codec]) -> Type[Codec]:
    """Class decorator: add a Codec subclass under ``cls.name``."""
    assert issubclass(cls, Codec) and cls.name, cls
    _REGISTRY[cls.name] = cls
    return cls


def available_codecs() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get_codec(name: str, opts: Optional[Mapping[str, Any]] = None) -> Codec:
    """Instantiate a registered codec by name; unknown names fail fast."""
    if name in UNPORTED_CODECS:
        raise NotImplementedError(
            f"codec {name!r} is not ported yet: registered codecs are "
            f"{list(available_codecs())}")
    if name not in _REGISTRY:
        raise ValueError(
            f"unknown codec {name!r}: registered codecs are "
            f"{list(available_codecs())}")
    return _REGISTRY[name](**dict(opts or {}))


def resolve(coll: Any) -> Optional[Codec]:
    """The codec a CollectiveConfig asks for (None = uncompressed): a named
    ``coll.codec`` with its ``codec_opts``, or the legacy
    ``coll.compression`` BFPConfig alone."""
    from .bfp import BFPCodec
    name = getattr(coll, "codec", None)
    if name:
        opts = dict(getattr(coll, "codec_opts", ()) or ())
        if name == "bfp" and coll.compression is not None:
            return BFPCodec(cfg=coll.compression, **opts)
        return get_codec(name, opts)
    if getattr(coll, "compression", None) is not None:
        return BFPCodec(cfg=coll.compression)
    return None


def as_codec(compression: Any) -> Optional[Codec]:
    """Normalize a ring-level ``compression=`` argument: None, a Codec, or
    a bare BFPConfig."""
    if compression is None or isinstance(compression, Codec):
        return compression
    from ..utils.config import BFPConfig
    if isinstance(compression, BFPConfig):
        from .bfp import BFPCodec
        return BFPCodec(cfg=compression)
    raise TypeError(
        f"compression must be None, a compress.Codec, or a BFPConfig; "
        f"got {type(compression).__name__}")
