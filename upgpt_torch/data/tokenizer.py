"""CLIP's byte-level BPE tokenizer, in plain Python.

The port's own copy of `upgpt_tpu.data.tokenizer` (it imports nothing of
the JAX package): the openai-clip / HF CLIPTokenizer algorithm with
`</w>` word-end markers, HTML unescape and whitespace cleanup, lowercase,
and a 49,408-entry vocabulary (256 bytes, 256 bytes with `</w>`, 48,894
merges, `<|startoftext|>` and `<|endoftext|>`).

The merges table is data: `bpe_path` names openai's
`bpe_simple_vocab_16e6.txt.gz` (whose header line and slice are read as
openai reads them) or a plain merges file (HF `merges.txt`). None is in
the repository.

A batch encodes as FrozenCLIPEmbedder's tokenizer call does (reference
encoders/modules.py:152-156): BOS, at most 75 ids, EOS, then EOS padding
to 77.
"""

from __future__ import annotations

import gzip
import html
import os
import re
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """The reversible byte -> printable character table of byte BPE."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word: Tuple[str, ...]) -> set:
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


_CLEAN_RE = re.compile(r"\s+")
# CLIP's pattern with \p{L} / \p{N} written for the standard library's re:
# '_' is punctuation to CLIP but a word character to \w, so the punctuation
# class names it explicitly
_TOKEN_RE = re.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"""
    r"""[^\W\d_]+|\d|(?:[^\s\w]|_)+""",
    re.IGNORECASE | re.UNICODE)


def _basic_clean(text: str) -> str:
    return html.unescape(html.unescape(text)).strip()


def _whitespace_clean(text: str) -> str:
    return _CLEAN_RE.sub(" ", text).strip()


class CLIPTokenizer:
    def __init__(self, bpe_path: Optional[str] = None, max_length: int = 77,
                 merges: Optional[List[Tuple[str, str]]] = None):
        self.max_length = max_length
        self.byte_encoder = bytes_to_unicode()
        if merges is None:
            if bpe_path is None or not os.path.exists(bpe_path):
                raise FileNotFoundError(
                    f"CLIP BPE merges file {bpe_path!r} not found: pass "
                    f"bpe_path to openai's bpe_simple_vocab_16e6.txt.gz or a "
                    f"merges.txt (none is in the repository)")
            merges = self._load_merges(bpe_path)
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab.extend("".join(m) for m in merges)
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bos_id = self.encoder["<|startoftext|>"]
        self.eos_id = self.encoder["<|endoftext|>"]
        self.cache: Dict[str, str] = {"<|startoftext|>": "<|startoftext|>",
                                      "<|endoftext|>": "<|endoftext|>"}

    @staticmethod
    def _load_merges(path: str) -> List[Tuple[str, str]]:
        if path.endswith(".gz"):
            with gzip.open(path, "rt", encoding="utf-8") as f:
                lines = f.read().split("\n")
            # openai's file: a header line, then the merges openai reads,
            # lines [1, 49152 - 256 - 2 + 1)
            lines = lines[1:49152 - 256 - 2 + 1]
        else:
            with open(path, encoding="utf-8") as f:
                lines = [line for line in f.read().split("\n")
                         if line and not line.startswith("#")]
        return [tuple(line.split()) for line in lines if line]

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs,
                         key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        text = _whitespace_clean(_basic_clean(text)).lower()
        for token in _TOKEN_RE.findall(text):
            token = "".join(self.byte_encoder[b]
                            for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(token).split(" "))
        return ids

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        """(B, max_length) int32: BOS, the ids truncated to max_length - 2,
        EOS, then EOS padding (HF's padding="max_length")."""
        out = np.full((len(texts), self.max_length), self.eos_id, np.int32)
        for i, text in enumerate(texts):
            ids = ([self.bos_id] + self.encode(text)[:self.max_length - 2]
                   + [self.eos_id])
            out[i, :len(ids)] = ids
        return out

    def decode(self, ids: Sequence[int]) -> str:
        byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        text = "".join(self.decoder[int(i)] for i in ids)
        raw = bytearray(byte_decoder[c] for c in text if c in byte_decoder)
        return raw.decode("utf-8", errors="replace").replace("</w>",
                                                             " ").strip()
