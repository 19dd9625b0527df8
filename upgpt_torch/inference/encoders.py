"""Conditioning encoders: raw batch (txt strings, style images) ->
embedding batch for LatentDiffusion.

Port of `upgpt_tpu.inference.encoders`. `CLIPConditioningEncoder` is the
reference's frozen cond stages (encoders/modules.py): the text tower's
77x768 last hidden state (FrozenCLIPEmbedder), the vision tower's pooled
embedding of each of the 9 style slots (FrozenClipImageEmbedder2) and the
pooled text feature for per-slot overrides (FrozenCLIPTextEmbedder,
normalize=False at inference). Its towers run where they lie (the card in
the CLI), frozen, in float32 as JAX's do, under `torch.no_grad()` (not
inference mode: the trainable fusion saves the text states for its
backward). Tokenisation is host Python and the style crops may arrive as
uint8 (the compact transport), normalised on the device.

`DebugConditioningEncoder` is a deterministic stand-in (seeded-hash
embeddings, numpy only) so sampling, serving and training smoke runs work
without CLIP weights. It is NOT output parity.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Sequence

import numpy as np
import torch

from upgpt_torch.data.tokenizer import CLIPTokenizer
from upgpt_torch.data.transforms import CLIP_MEAN, CLIP_STD
from upgpt_torch.models.clip import (
    CLIPTextTower, CLIPVisionTower, StyleImageEncoder,
)


def _dequant_styles(imgs: torch.Tensor) -> torch.Tensor:
    """uint8 style crops -> CLIP-normalised float32 on their device, with
    the arithmetic of `transforms.clip_normalize_image` (exact for
    uint8-sourced crops; the uint8 zero slot gives normalize(black), the
    empty style). The divisor is a tensor: CUDA's division by a host scalar
    multiplies by its reciprocal. Float crops pass through."""
    if imgs.dtype != torch.uint8:
        return imgs
    dev = imgs.device
    x = imgs.float() / torch.full((), 255.0, device=dev)
    return ((x - torch.from_numpy(CLIP_MEAN).to(dev))
            / torch.from_numpy(CLIP_STD).to(dev))


class CLIPConditioningEncoder:
    """Frozen CLIP text and style-image encoding on the towers' device.

    `encode_batch` does both halves at once; the trainer splits them:
    `tokenize_batch` on the host (the loader's producer thread) and
    `encode_device` on the card, ahead of the step."""

    def __init__(self, text_tower: CLIPTextTower,
                 vision_tower: CLIPVisionTower, tokenizer: CLIPTokenizer):
        self.tokenizer = tokenizer
        self.text_tower = text_tower.eval().requires_grad_(False)
        self.style_encoder = StyleImageEncoder(
            vision_tower.config, vision_tower).eval().requires_grad_(False)

    @classmethod
    def from_files(cls, text_params: str, vision_params: str, bpe_path: str,
                   quick_gelu: bool = True, device="cuda"
                   ) -> "CLIPConditioningEncoder":
        """Towers from `torch.save`d state dicts (HF, openai or the port's
        layout, told apart by their keys; one openai CLIP file may serve
        both) or from the JAX CLI's orbax trees of either tower
        (`upgpt_tpu/cli.py:30-40`), and the BPE merges file."""
        from upgpt_torch.convert.clip_weights import (
            text_tower_from_state_dict, vision_tower_from_state_dict,
        )
        from upgpt_torch.convert.from_jax import jax_state_dict
        from upgpt_torch.convert.orbax import is_orbax_dir, restore

        def load(path):
            if is_orbax_dir(path):
                return jax_state_dict(restore(path))
            return torch.load(path, map_location="cpu", weights_only=True)

        return cls(text_tower_from_state_dict(load(text_params), quick_gelu,
                                              device),
                   vision_tower_from_state_dict(load(vision_params),
                                                quick_gelu, device),
                   CLIPTokenizer(bpe_path=bpe_path))

    @property
    def device(self) -> torch.device:
        return self.text_tower.position_embedding.device

    def tokenize(self, texts: Sequence[str]) -> np.ndarray:
        """(B, 77) int32 token ids, on the host."""
        return self.tokenizer(list(texts))

    def _ids(self, texts) -> torch.Tensor:
        return torch.from_numpy(self.tokenize(texts)).to(self.device)

    @torch.no_grad()
    def text_hidden(self, texts: Sequence[str]) -> torch.Tensor:
        """(B, 77, D) float32 last hidden states."""
        return self.text_tower(self._ids(texts))[0]

    @torch.no_grad()
    def text_pooled(self, texts: Sequence[str]) -> torch.Tensor:
        """(B, projection_dim) float32 pooled, projected text features."""
        return self.text_tower(self._ids(texts))[1]

    @torch.no_grad()
    def style_embeddings(self, styles) -> torch.Tensor:
        """(B, 9, H, W, 3) crops, CLIP-normalised float or uint8 ->
        (B, 9, projection_dim) float32."""
        styles = torch.as_tensor(np.asarray(styles) if not isinstance(
            styles, torch.Tensor) else styles).to(self.device)
        return self.style_encoder(_dequant_styles(styles))

    def encode_batch(self, batch: Dict) -> Dict:
        out = dict(batch)
        out["text_emb"] = self.text_hidden(batch["txt"])
        if "styles" in batch:
            out["style_emb"] = self.style_embeddings(batch["styles"])
        return out

    def tokenize_batch(self, batch: Dict) -> Dict:
        """The host half: `txt` -> `token_ids` (B, 77) int32."""
        out = dict(batch)
        out["token_ids"] = self.tokenize(batch["txt"])
        return out

    @torch.no_grad()
    def encode_device(self, batch: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
        """The device half, on tensors already on the towers' device:
        `token_ids` -> `text_emb`, `styles` -> `style_emb`; both inputs
        dropped."""
        out = {k: v for k, v in batch.items()
               if k not in ("token_ids", "styles")}
        out["text_emb"] = self.text_tower(batch["token_ids"])[0]
        if "styles" in batch:
            out["style_emb"] = self.style_encoder(
                _dequant_styles(batch["styles"]))
        return out


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
