"""Text into Llama batches: a byte-level tokenizer, packed LM windows and
shuffled (tokens, labels) batches — the port of the JAX package's
``text.py`` (``ByteTokenizer``, ``pack_windows``, ``lm_batches``).  numpy
only, so the windows and batches equal the JAX package's for the same
source and seed.

- **Fixed shapes.** Documents are packed into ``[seq_len + 1]`` windows
  (concatenated with EOS separators, no padding inside a window).
- **Globally shifted labels.** ``labels[i] = tokens[i + 1]`` is taken
  when the window is packed, before any sequence sharding, so the shift
  crosses sp shard boundaries as ``models.llama.loss_fn`` expects.  A
  target that starts a new document is masked with -100 (the loss's
  ignore value).
- **No downloads.** The tokenizer is byte-level (256 bytes + pad, bos and
  eos): self-contained and reversible.  The JAX package's ``HFTokenizer``
  needs a cached BPE vocabulary, which the repository does not hold; it
  waits in ROADMAP A.1.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterable, Iterator, List, Optional, Sequence, Union

import numpy as np


@dataclass(frozen=True)
class ByteTokenizer:
    """Reversible byte-level tokenizer: ids 0..255 are raw bytes, then pad,
    bos and eos.  ``vocab_size`` is 259; a model's vocab must be at least
    that."""

    pad_id: int = 256
    bos_id: int = 257
    eos_id: int = 258

    @property
    def vocab_size(self) -> int:
        return 259

    def encode(self, text: str) -> List[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids: Sequence[int]) -> str:
        return bytes(i for i in ids if i < 256).decode("utf-8",
                                                       errors="replace")


def _iter_texts(source: Union[str, Iterable[str]]) -> Iterator[str]:
    """Documents: an iterable of strings, a text file's path (one document
    a blank-line-separated block), or a directory of ``*.txt`` files (in
    sorted order)."""
    if isinstance(source, str):
        if os.path.isdir(source):
            for name in sorted(os.listdir(source)):
                if name.endswith(".txt"):
                    yield from _iter_texts(os.path.join(source, name))
            return
        with open(source, encoding="utf-8") as f:
            block: List[str] = []
            for line in f:
                if line.strip():
                    block.append(line)
                elif block:
                    yield "".join(block)
                    block = []
            if block:
                yield "".join(block)
        return
    yield from source


def pack_windows(source: Union[str, Iterable[str]], tokenizer,
                 seq_len: int, *, epochs: Optional[int] = 1,
                 ) -> Iterator[np.ndarray]:
    """Tokenized documents packed into int32 ``[seq_len + 1]`` windows:
    ``[bos] doc [eos] doc [eos] ...`` concatenated, consecutive windows
    overlapping by one token, the last partial window dropped.  The token
    buffer carries over between epochs (``None``: forever), so a corpus
    shorter than a window still fills windows; a source with no documents
    raises.  A one-shot iterator is captured during epoch 1 and replayed
    for the later ones."""
    one_shot = not isinstance(source, str) and iter(source) is source
    capture: Optional[List[str]] = [] if one_shot and epochs != 1 else None
    buf: List[int] = [tokenizer.bos_id]
    off = 0
    e = 0
    while epochs is None or e < epochs:
        any_doc = False
        docs = capture if (capture is not None and e > 0) \
            else _iter_texts(source)
        for doc in docs:
            if capture is not None and e == 0:
                capture.append(doc)
            any_doc = True
            buf.extend(tokenizer.encode(doc))
            buf.append(tokenizer.eos_id)
            # windows off a read offset (re-slicing the tail each window
            # would be quadratic in a document's length)
            while len(buf) - off >= seq_len + 1:
                yield np.asarray(buf[off:off + seq_len + 1], np.int32)
                off += seq_len
            if off:
                buf = buf[off:]
                off = 0
        if not any_doc:
            raise ValueError("empty corpus: source yielded no documents")
        e += 1


def lm_batches(source: Union[str, Iterable[str]], tokenizer, *,
               batch_size: int, seq_len: int, seed: int = 0,
               shuffle_buffer: int = 256, epochs: Optional[int] = 1,
               mask_boundaries: bool = True) -> Iterator[tuple]:
    """``(tokens [B, S], labels [B, S])`` int32 numpy batches for the
    Llama trainers: ``pack_windows``' windows shuffled through a
    reservoir of ``shuffle_buffer`` windows (numpy's generator seeded
    with ``seed``), labels the windows shifted by one, a target whose
    predecessor is eos masked with -100."""
    rng = np.random.default_rng(seed)
    eos = tokenizer.eos_id

    def pairs():
        for w in pack_windows(source, tokenizer, seq_len, epochs=epochs):
            toks, labels = w[:-1], w[1:].copy()
            if mask_boundaries:
                labels[toks == eos] = -100
            yield toks, labels

    buf: List[tuple] = []
    batch: List[tuple] = []
    for p in pairs():
        if len(buf) < shuffle_buffer:
            buf.append(p)
            continue
        j = int(rng.integers(len(buf)))
        buf[j], p = p, buf[j]
        batch.append(p)
        if len(batch) == batch_size:
            yield (np.stack([t for t, _ in batch]),
                   np.stack([l for _, l in batch]))
            batch = []
    rng.shuffle(buf)
    for p in buf:
        batch.append(p)
        if len(batch) == batch_size:
            yield (np.stack([t for t, _ in batch]),
                   np.stack([l for _, l in batch]))
            batch = []
