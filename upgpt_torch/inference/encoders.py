"""Conditioning encoders: raw batch (txt strings, style images) ->
embedding batch for LatentDiffusion.

Port of `upgpt_tpu.inference.encoders` for the weightless path:
`DebugConditioningEncoder` is a deterministic stand-in (seeded-hash
embeddings, numpy only) so sampling and serving smoke runs work without
CLIP weights. It is NOT output parity. The CLIP encoder
(`CLIPConditioningEncoder`) is not ported yet (ROADMAP §1 item 7).
"""

from __future__ import annotations

import hashlib
from typing import Dict, Sequence

import numpy as np

from upgpt_torch.data.transforms import CLIP_MEAN, CLIP_STD


class DebugConditioningEncoder:
    """Deterministic hash-based embeddings — smoke runs only, NOT parity.

    Bit for bit the JAX package's: the same sha256/sha1 keys, the same
    numpy generators and the same float32 arithmetic."""

    def __init__(self, context_dim: int = 768, text_len: int = 77):
        self.context_dim = context_dim
        self.text_len = text_len
        self._proj_cache: dict = {}
        # the encoder is a frozen deterministic function, so caching by
        # input is exact; captions and styles repeat across requests
        self._text_cache: dict = {}
        self._style_cache: dict = {}

    def _emb(self, key: str, shape) -> np.ndarray:
        seed = int.from_bytes(hashlib.sha256(key.encode()).digest()[:4],
                              "little")
        return (np.random.default_rng(seed).normal(size=shape)
                .astype(np.float32) * 0.1)

    def text_hidden(self, texts: Sequence[str]) -> np.ndarray:
        out = []
        for t in texts:
            e = self._text_cache.get(t)
            if e is None:
                e = self._emb(t, (self.text_len, self.context_dim))
                # (77, 768) float32 is ~236 KB: cap the cache at ~240 MB
                if len(self._text_cache) < 1024:
                    self._text_cache[t] = e
            out.append(e)
        return np.stack(out)

    def text_pooled(self, texts: Sequence[str]) -> np.ndarray:
        return np.stack([self._emb("pool:" + t, (self.context_dim,))
                         for t in texts])

    def style_embeddings(self, styles) -> np.ndarray:
        """(B, n, H, W, 3) style crops -> (B, n, context_dim): an 8x8-strided
        subsample through a cached seeded random projection."""
        styles = np.asarray(styles)
        b, n = styles.shape[:2]
        sub = styles[:, :, ::8, ::8, :]
        if sub.dtype == np.uint8:
            # compact pipeline: the normalisation the CLIP path applies
            sub = (sub.astype(np.float32) / 255.0 - CLIP_MEAN) / CLIP_STD
        flat = np.ascontiguousarray(sub, dtype=np.float32).reshape(b, n, -1)
        proj = self._proj_cache.get(flat.shape[-1])
        if proj is None:
            proj = np.random.default_rng(0).normal(
                size=(flat.shape[-1], self.context_dim)).astype(np.float32)
            self._proj_cache[flat.shape[-1]] = proj
        scale = np.float32(0.1 / np.sqrt(flat.shape[-1]))
        out = np.empty((b, n, self.context_dim), np.float32)
        for i in range(b):
            for j in range(n):
                key = hashlib.sha1(flat[i, j].tobytes()).digest()
                e = self._style_cache.get(key)
                if e is None:
                    e = (flat[i, j] @ proj) * scale
                    if len(self._style_cache) < 32768:  # 3 KB each
                        self._style_cache[key] = e
                out[i, j] = e
        return out

    def encode_batch(self, batch: Dict) -> Dict:
        out = dict(batch)
        out["text_emb"] = self.text_hidden(batch["txt"])
        if "styles" in batch:
            out["style_emb"] = self.style_embeddings(batch["styles"])
        return out
