"""Per-bucket magnitude top-k with error feedback — the port of the JAX
package's ``compress/topk.py`` (the SparCML family).

The gradient is cut into independent buckets of ``bucket_elems``
consecutive elements; each keeps its ``k`` largest-magnitude entries.  The
wire payload per bucket is (f32 values [k], int16 indices [k]), 6 bytes
per kept element (defaults: 512-element buckets, k=64, 5.33x vs f32).

Top-k is not a bounded-error codec (``error_bound = 1.0``); it converges
through error feedback: the dropped residual is carried in
``TrainState.codec_state`` and re-added to the next step's gradient
(``ops.fused_update.error_feedback_encode``).

Ties are part of the bit spec: ``lax.top_k`` returns equal magnitudes in
ascending index order.  ``torch.topk`` does not promise that, so the
selection is a stable sort of the negated magnitudes, first k taken, as
the golden's stable argsort does (``compress.golden.topk_encode``).
Decode sets the values (the indices of a bucket are distinct).

The JAX package has no TPU kernel for top-k; plain torch ops are the port
on every device.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from .base import Codec, register


@register
class TopKCodec(Codec):
    """Per-bucket magnitude top-k, error feedback on by default."""

    name = "topk"
    idempotent = True          # re-selecting a k-sparse bucket is exact
    supports_fused = False

    def __init__(self, bucket_elems: int = 512, k: int = 64,
                 error_feedback: bool = True) -> None:
        assert 0 < k <= bucket_elems, (k, bucket_elems)
        assert bucket_elems <= 32768, "int16 wire indices"
        self.bucket_elems = int(bucket_elems)
        self.k = int(k)
        self.error_feedback = bool(error_feedback)

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        B = self.bucket_elems
        assert x.shape[0] % B == 0, (x.shape, B)
        xb = x.to(torch.float32).reshape(-1, B)
        order = torch.sort(-xb.abs(), dim=-1, stable=True).indices
        idx = order[:, :self.k]
        return torch.gather(xb, 1, idx), idx.to(torch.int16)

    def decode(self, payload: Tuple[torch.Tensor, ...], n_elems: int,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
        vals, idx = payload
        B = self.bucket_elems
        nb = n_elems // B
        out = torch.zeros((nb, B), dtype=torch.float32, device=vals.device)
        out.scatter_(1, idx.reshape(nb, self.k).to(torch.int64),
                     vals.reshape(nb, self.k).to(torch.float32))
        return out.reshape(n_elems).to(dtype)

    @property
    def pad_elems(self) -> int:
        return self.bucket_elems

    @property
    def error_bound(self) -> float:
        # a dropped coordinate can equal the bucket max (ties at the k-th
        # magnitude): the residual carry, not a per-pass bound, is the
        # accuracy story
        return 1.0

    def wire_bytes(self, n_elems: int) -> int:
        assert n_elems % self.bucket_elems == 0
        return (n_elems // self.bucket_elems) * self.k * (4 + 2)

    def describe(self) -> Dict[str, Any]:
        d = super().describe()
        d.update(bucket_elems=self.bucket_elems, k=self.k,
                 density=round(self.k / self.bucket_elems, 4))
        return d
