"""The port's CLIP tokenizer against the JAX package's, id for id.

No merges table is in the repository, so both read the same synthetic one:
as openai's gzip file (a header line, then the merges), as a plain
merges.txt (with a comment line) and as a list. Captions cover the
cleanup (HTML entities, whitespace, case), punctuation and underscores,
digits, non-ASCII text, EOS padding and truncation to 77 tokens; the
decode, the byte table and a missing file are held too.
"""

import gzip

import numpy as np
import pytest

from upgpt_torch.data import tokenizer as ttok
from upgpt_tpu.data import tokenizer as jtok

MERGES = [("h", "e"), ("l", "l"), ("he", "ll"), ("hell", "o</w>"),
          ("w", "o"), ("r", "l"), ("wo", "rl"), ("worl", "d</w>"),
          ("s", "h"), ("i", "r"), ("t", "</w>"), ("sh", "ir"),
          ("shir", "t</w>"),
          ("r", "e"), ("d", "</w>"), ("re", "d</w>"), ("a", "n"),
          ("an", "d</w>"), ("o", "n"), ("on", "</w>"), ("e", "s"),
          ("w", "e"), ("we", "a"), ("wea", "r"), ("s", "</w>")]

TEXTS = [
    "hello world",
    "  HeLLo\n\tWORLD ",
    "a red shirt and red shoes; she wears it on the beach.",
    "she's wearing a t-shirt &amp; jeans &lt;3",
    "hello_world 2024 s1ze 10,000",
    "Ünïcödé façade — naïve café",
    "",
    " ".join(["red shirt"] * 60),  # truncated to 77 with BOS and EOS
]


def _write(path, kind):
    lines = [" ".join(m) for m in MERGES]
    if kind == "gz":
        with gzip.open(path, "wt", encoding="utf-8") as f:
            f.write("\n".join(["#version: 0.2"] + lines) + "\n")
    else:
        path.write_text("\n".join(["#version: 0.2"] + lines) + "\n")
    return str(path)


@pytest.fixture(params=["gz", "txt", "list"])
def pair(request, tmp_path):
    if request.param == "list":
        return (ttok.CLIPTokenizer(merges=list(MERGES)),
                jtok.CLIPTokenizer(merges=list(MERGES)))
    path = _write(tmp_path / ("bpe.txt.gz" if request.param == "gz"
                              else "merges.txt"), request.param)
    return ttok.CLIPTokenizer(bpe_path=path), jtok.CLIPTokenizer(bpe_path=path)


def test_ids_equal_jax(pair):
    ours, theirs = pair
    assert ours.bpe_ranks == theirs.bpe_ranks
    assert ours.encoder == theirs.encoder
    for text in TEXTS:
        assert ours.encode(text) == theirs.encode(text), text
    got, want = ours(TEXTS), theirs(TEXTS)
    assert got.dtype == want.dtype == np.int32
    assert got.shape == (len(TEXTS), 77)
    np.testing.assert_array_equal(got, want)
    # BOS, EOS after the text, EOS padding; the long caption truncated
    assert (got[:, 0] == ours.bos_id).all()
    assert (got[6, 1:] == ours.eos_id).all()
    assert got[7, -1] == ours.eos_id and (got[7, 1:-1] != ours.eos_id).all()


def test_decode_equal_jax(pair):
    ours, theirs = pair
    for text in TEXTS:
        ids = ours.encode(text)
        assert ours.decode(ids) == theirs.decode(ids)
    assert ours.decode(ours.encode("hello world")) == "hello world"


def test_merged_words_and_cleanup():
    tok = ttok.CLIPTokenizer(merges=list(MERGES), max_length=6)
    ids = tok.encode("hello world")
    assert [tok.decoder[i] for i in ids] == ["hello</w>", "world</w>"]
    assert tok.encode("  HeLLo\n\tWORLD ") == ids
    assert tok.encode("hello_world") != tok.encode("helloworld")
    out = tok(["hello", "hello world hello world"])
    assert out.shape == (2, 6)
    assert list(out[0]) == [tok.bos_id, ids[0]] + [tok.eos_id] * 4
    assert out[1, 0] == tok.bos_id and out[1, -1] == tok.eos_id


def test_byte_table_equal_jax():
    assert ttok.bytes_to_unicode() == jtok.bytes_to_unicode()
    assert len(set(ttok.bytes_to_unicode().values())) == 256


@pytest.mark.parametrize("path", [None, "/nonexistent/bpe_simple_vocab.gz"])
def test_missing_merges_file_raises(path):
    with pytest.raises(FileNotFoundError):
        ttok.CLIPTokenizer(bpe_path=path)
