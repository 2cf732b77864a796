"""The port's ``text.py`` against the JAX package's: the byte tokenizer,
``pack_windows`` and ``lm_batches`` give equal arrays, exactly, for a
file, a directory and a generator source over several epochs, the
shuffle seeded alike."""

import itertools

import numpy as np
import pytest
from torch_threads import one_torch_thread  # noqa: F401

from fpga_ai_nic_tpu import text as jax_text
from fpga_ai_nic_tpu_torch import text

DOCS = ["alpha beta gamma delta " * 3, "héllo wörld", "x" * 70,
        "short", "the quick brown fox jumps over the lazy dog\n" * 2]


@pytest.fixture
def corpus(tmp_path):
    (tmp_path / "a.txt").write_text("\n\n".join(DOCS[:3]) + "\n")
    (tmp_path / "b.txt").write_text("\n\n".join(DOCS[3:]) + "\n")
    (tmp_path / "skip.md").write_text("not read")
    return tmp_path


def test_byte_tokenizer_matches_jax():
    a, b = text.ByteTokenizer(), jax_text.ByteTokenizer()
    assert (a.pad_id, a.bos_id, a.eos_id, a.vocab_size) == \
        (b.pad_id, b.bos_id, b.eos_id, b.vocab_size)
    for d in DOCS:
        assert a.encode(d) == b.encode(d)
        assert a.decode(a.encode(d) + [a.eos_id]) == d


def _sources(corpus):
    return {"file": lambda: str(corpus / "a.txt"),
            "dir": lambda: str(corpus),
            "generator": lambda: (d for d in DOCS)}


@pytest.mark.parametrize("kind", ["file", "dir", "generator"])
@pytest.mark.parametrize("epochs", [1, 3])
def test_pack_windows_match_jax(corpus, kind, epochs):
    src = _sources(corpus)[kind]
    tok = text.ByteTokenizer()
    got = list(text.pack_windows(src(), tok, 16, epochs=epochs))
    want = list(jax_text.pack_windows(src(), jax_text.ByteTokenizer(), 16,
                                      epochs=epochs))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kind", ["file", "dir", "generator"])
def test_lm_batches_match_jax(corpus, kind):
    src = _sources(corpus)[kind]
    kw = dict(batch_size=3, seq_len=8, seed=11, shuffle_buffer=5)
    got = list(itertools.islice(text.lm_batches(
        src(), text.ByteTokenizer(), epochs=4, **kw), 30))
    want = list(itertools.islice(jax_text.lm_batches(
        src(), jax_text.ByteTokenizer(), epochs=4, **kw), 30))
    assert len(got) == len(want) > 0
    masked = 0
    for (gt, gl), (wt, wl) in zip(got, want):
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_array_equal(gl, wl)
        masked += int((gl == -100).sum())
    assert masked > 0


def test_lm_batches_cycle_forever_and_raise_on_empty(corpus):
    kw = dict(batch_size=2, seq_len=64, seed=0)
    got = list(itertools.islice(text.lm_batches(
        str(corpus / "a.txt"), text.ByteTokenizer(), epochs=None, **kw), 5))
    want = list(itertools.islice(jax_text.lm_batches(
        str(corpus / "a.txt"), jax_text.ByteTokenizer(), epochs=None, **kw),
        5))
    assert len(got) == 5
    for (gt, gl), (wt, wl) in zip(got, want):
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_array_equal(gl, wl)
    with pytest.raises(ValueError, match="empty corpus"):
        list(text.pack_windows(iter([]), text.ByteTokenizer(), 8))
