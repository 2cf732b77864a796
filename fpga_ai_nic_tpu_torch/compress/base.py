"""Codec protocol + registry — the port of the JAX package's
``compress/base.py``.

The contract is the reference's: ``encode`` maps a flat f32 vector to a
tuple of tensors (the hop payload), ``decode`` inverts it given the element
count; ``pad_elems`` is the alignment of one compression unit;
``error_feedback`` whether the trainer carries a residual across steps
(``state_init``); ``error_bound`` the declared worst case of one pass as a
fraction of the unit's max-abs value; ``idempotent`` whether
decode∘encode is a projection; ``supports_fused`` whether the codec may
ride the fused ring kernels (``ops.ring_cuda``).  Registered: ``bfp``,
``int8`` and ``topk``, as in the JAX package.

``unit_elems`` is the port's addition: the rings stack every rank's
payload into one codec call, which gives each rank's own bits only when
each rank's part is a whole number of these units (``ops.ring``).
"""

from __future__ import annotations

import abc
from typing import Any, Dict, Mapping, Optional, Tuple, Type

import torch

class Codec(abc.ABC):
    """One gradient-compression wire format (see module docstring)."""

    name: str = ""
    #: decode∘encode is a projection: a second pass is bit-identical
    idempotent: bool = False
    #: carries an error-feedback residual across trainer steps
    error_feedback: bool = False
    #: may ride the fused ring kernels (ops.ring_cuda)
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

    def unit_elems(self, n_elems: int) -> int:
        """Elements of the layout unit a [n_elems] payload is cut into:
        one compression unit, or a whole (block, 128)-lane tile where the
        codec takes the sublane layout.  Payloads may be joined end to end
        in one codec call, or sliced, without changing their bits only
        when each is a whole number of these."""
        return self.pad_elems

    def for_payload(self, n_elems: int, device: torch.device) -> "Codec":
        """The codec that encodes one rank's [n_elems] payload on
        ``device``: itself, or for a backend that decides per payload
        ("auto") the concrete layout it picks there.  The one place that
        decision is taken: a collective pins its codec once, on one
        rank's chunk (``as_codec``), before it encodes every rank's
        payload in one call."""
        return self

    def sliceable(self, chunk_elems: int, slice_elems: Optional[int]) -> bool:
        """May a [chunk_elems] hop be sent as [slice_elems] slices with
        identical bits?  True only when slicing cannot change the unit
        partition (and actually splits the chunk)."""
        return (slice_elems is not None
                and chunk_elems > slice_elems
                and chunk_elems % slice_elems == 0
                and slice_elems % self.unit_elems(slice_elems) == 0)

    def state_init(self, shape: Tuple[int, ...],
                   device: Optional[torch.device] = None
                   ) -> Optional[torch.Tensor]:
        """Fresh residual carry for a gradient stream of ``shape`` (None
        for codecs without error feedback)."""
        if not self.error_feedback:
            return None
        return torch.zeros(shape, dtype=torch.float32, device=device)

    @property
    @abc.abstractmethod
    def error_bound(self) -> float:
        """Worst-case per-element |x - roundtrip(x)| as a fraction of the
        unit's max-abs value, for one encode/decode pass."""

    @abc.abstractmethod
    def wire_bytes(self, n_elems: int) -> int:
        """Bytes one encoded [n_elems] payload puts on the wire."""

    @property
    def compression_ratio_vs_f32(self) -> float:
        n = self.pad_elems
        return 4.0 * n / self.wire_bytes(n)

    def describe(self) -> Dict[str, Any]:
        """Static facts for tables and run summaries."""
        return {
            "codec": self.name,
            "pad_elems": self.pad_elems,
            "compression_ratio_vs_f32":
                round(self.compression_ratio_vs_f32, 3),
            "error_bound": self.error_bound,
            "error_feedback": self.error_feedback,
            "idempotent": self.idempotent,
            "supports_fused": self.supports_fused,
        }


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


def check_pinned(name: str, device: torch.device) -> None:
    """An "auto" codec not pinned by ``Codec.for_payload`` encodes only on
    the CPU, where it is flat16 whatever the payload.  On a card one
    rank's payload decides, which a call over every rank's payload cannot
    see, so there it raises."""
    if torch.device(device).type == "cuda":
        raise ValueError(
            f"codec {name!r} with an 'auto' layout on a CUDA tensor: pin it "
            "to one rank's payload first (Codec.for_payload, as_codec)")


def as_codec(compression: Any, per_rank_elems: Optional[int] = None,
             device: Optional[torch.device] = None) -> Optional[Codec]:
    """Normalize a ring-level ``compression=`` argument: None, a Codec, or
    a bare BFPConfig.  With ``per_rank_elems`` (one rank's chunk) and
    ``device``, an "auto" codec comes back pinned to the layout that
    chunk takes there, so the rings below never see "auto"."""
    if compression is not None and not isinstance(compression, Codec):
        from ..utils.config import BFPConfig
        if not isinstance(compression, BFPConfig):
            raise TypeError(
                f"compression must be None, a compress.Codec, or a "
                f"BFPConfig; got {type(compression).__name__}")
        from .bfp import BFPCodec
        compression = BFPCodec(cfg=compression)
    if compression is None or per_rank_elems is None:
        return compression
    return compression.for_payload(per_rank_elems, device)
