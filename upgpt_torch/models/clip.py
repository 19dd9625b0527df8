"""CLIP's text and vision towers: the frozen conditioning encoders.

Port of `upgpt_tpu.models.clip`. The reference conditions through three
CLIP entry points (ldm/modules/encoders/modules.py):
- FrozenCLIPEmbedder (137-162): the text model's 77x768 last hidden state,
  the main context of every released model;
- FrozenCLIPTextEmbedder (165-198): the pooled text feature (the EOS
  token's hidden state after ln_final, projected), per style slot for text
  overrides;
- FrozenClipImageEmbedder2 (234-256): the ViT-L/14 image tower over the
  nine style crops, pooled and projected to (B, 9, 768).

Text: token embedding plus learned positions, pre-LN blocks under a causal
mask, ln_final; pooled at the EOS position (the first argmax of the token
ids: the tokenizer pads with EOS, the largest id) and projected. Vision: a
14x14 patch conv, the class token, learned positions, ln_pre, pre-LN
blocks, ln_post on the class token and the projection. The openai towers
use QuickGELU, the laion ones exact GELU (`quick_gelu`).

Numerics as in the JAX package: LayerNorms in float32 (eps 1e-5), scores
in float32 with the causal mask added as float32's most negative value, a
float32 softmax whose probabilities take v's dtype, compute in the config's
`dtype` (float32 by default, as JAX's towers run). The attention is plain
matmuls, as JAX's is plain einsums: JAX has no kernel here.

Module names follow the JAX parameter tree (`block_{i}.attn.q_proj`,
`token_embedding`, `text_projection`, ...), so `convert/from_jax.py` loads
JAX's trees and `convert/clip_weights.py` maps HF and openai state dicts.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from upgpt_torch.models.layers import Dense, Norm


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_ratio: int = 4
    max_positions: int = 77
    quick_gelu: bool = True  # openai checkpoints; laion's use exact GELU
    projection_dim: int = 768
    dtype: torch.dtype = torch.float32


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    mlp_ratio: int = 4
    quick_gelu: bool = True
    projection_dim: int = 768
    dtype: torch.dtype = torch.float32


def _act(x: torch.Tensor, quick: bool) -> torch.Tensor:
    if quick:
        return x * torch.sigmoid(1.702 * x)
    return F.gelu(x)


def _layer_norm(x: torch.Tensor, norm: Norm) -> torch.Tensor:
    """LayerNorm in float32, eps 1e-5 (flax LayerNorm(dtype=float32))."""
    return F.layer_norm(x.float(), x.shape[-1:], norm.weight.float(),
                        norm.bias.float(), 1e-5)


class CLIPAttention(nn.Module):
    def __init__(self, hidden: int, heads: int, dtype: torch.dtype):
        super().__init__()
        self.heads = heads
        self.q_proj = Dense(hidden, hidden, dtype=dtype)
        self.k_proj = Dense(hidden, hidden, dtype=dtype)
        self.v_proj = Dense(hidden, hidden, dtype=dtype)
        self.out_proj = Dense(hidden, hidden, dtype=dtype)

    def forward(self, x: torch.Tensor,
                causal_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, t, c = x.shape
        d = c // self.heads
        q = self.q_proj(x).reshape(b, t, self.heads, d) * (d ** -0.5)
        k = self.k_proj(x).reshape(b, t, self.heads, d)
        v = self.v_proj(x).reshape(b, t, self.heads, d)
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        if causal_mask is not None:
            scores = scores + causal_mask
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, t, c)
        return self.out_proj(out)


class CLIPBlock(nn.Module):
    """Pre-LN: x + attn(ln1(x)), then x + fc2(act(fc1(ln2(x))))."""

    def __init__(self, hidden: int, heads: int, mlp_ratio: int,
                 quick_gelu: bool, dtype: torch.dtype):
        super().__init__()
        self.quick_gelu = quick_gelu
        self.ln1 = Norm(hidden)
        self.attn = CLIPAttention(hidden, heads, dtype)
        self.ln2 = Norm(hidden)
        self.fc1 = Dense(hidden, hidden * mlp_ratio, dtype=dtype)
        self.fc2 = Dense(hidden * mlp_ratio, hidden, dtype=dtype)

    def forward(self, x: torch.Tensor,
                causal_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attn(_layer_norm(x, self.ln1).to(x.dtype), causal_mask)
        h = self.fc1(_layer_norm(x, self.ln2).to(x.dtype))
        return x + self.fc2(_act(h, self.quick_gelu))


def _normal(*shape: int) -> nn.Parameter:
    return nn.Parameter(torch.randn(*shape) * 0.01)


class CLIPTextTower(nn.Module):
    """token ids (B, T) -> (last hidden state (B, T, D) float32, pooled and
    projected (B, projection_dim) float32)."""

    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        cfg = self.config = config
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        nn.init.normal_(self.token_embedding.weight, std=0.01)
        self.position_embedding = _normal(cfg.max_positions, cfg.hidden_size)
        for i in range(cfg.num_layers):
            self.add_module(f"block_{i}", CLIPBlock(
                cfg.hidden_size, cfg.num_heads, cfg.mlp_ratio, cfg.quick_gelu,
                cfg.dtype))
        self.ln_final = Norm(cfg.hidden_size)
        self.text_projection = _normal(cfg.hidden_size, cfg.projection_dim)

    def forward(self, token_ids: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.config
        b, t = token_ids.shape
        token_ids = token_ids.long()
        x = (self.token_embedding(token_ids).to(cfg.dtype)
             + self.position_embedding[:t].to(cfg.dtype))
        # the additive causal mask on float32 scores: every row keeps its
        # diagonal, so no row is masked whole
        causal = torch.full((t, t), torch.finfo(torch.float32).min,
                            device=x.device).triu(1)
        for i in range(cfg.num_layers):
            x = getattr(self, f"block_{i}")(x, causal)
        x = _layer_norm(x, self.ln_final)
        # pooled at the EOS token: the first argmax of the ids (EOS is the
        # largest id and also pads; torch.argmax returns the first maximum)
        eos = torch.argmax(token_ids, dim=-1)
        pooled = x[torch.arange(b, device=x.device), eos]
        return x, pooled @ self.text_projection.float()


class CLIPVisionTower(nn.Module):
    """CLIP-normalised pixels (B, H, W, 3) -> (hidden states with the class
    token (B, 1 + N, D) float32, pooled and projected (B, projection_dim)
    float32)."""

    def __init__(self, config: CLIPVisionConfig):
        super().__init__()
        cfg = self.config = config
        d, p = cfg.hidden_size, cfg.patch_size
        self.patch_embedding = nn.Conv2d(3, d, p, stride=p, bias=False)
        n = (cfg.image_size // p) ** 2
        self.class_embedding = _normal(d)
        self.position_embedding = _normal(n + 1, d)
        self.ln_pre = Norm(d)
        for i in range(cfg.num_layers):
            self.add_module(f"block_{i}", CLIPBlock(
                d, cfg.num_heads, cfg.mlp_ratio, cfg.quick_gelu, cfg.dtype))
        self.ln_post = Norm(d)
        self.visual_projection = _normal(d, cfg.projection_dim)

    def forward(self, pixels: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.config
        b = pixels.shape[0]
        w = self.patch_embedding.weight.to(cfg.dtype)
        x = F.conv2d(pixels.to(cfg.dtype).permute(0, 3, 1, 2), w,
                     stride=cfg.patch_size)
        x = x.permute(0, 2, 3, 1).reshape(b, -1, cfg.hidden_size)
        cls = self.class_embedding.to(x.dtype).expand(b, 1, cfg.hidden_size)
        x = torch.cat([cls, x], dim=1) + self.position_embedding.to(x.dtype)
        x = _layer_norm(x, self.ln_pre).to(cfg.dtype)
        for i in range(cfg.num_layers):
            x = getattr(self, f"block_{i}")(x)
        pooled = _layer_norm(x[:, 0].float(), self.ln_post)
        return x.float(), pooled @ self.visual_projection.float()


class StyleImageEncoder(nn.Module):
    """FrozenClipImageEmbedder2 (modules.py:234-256): the CLIP-normalised
    style stack (B, S, H, W, 3) -> (B, S, projection_dim), the S slots
    folded into the batch for one pass of the tower."""

    def __init__(self, config: CLIPVisionConfig,
                 vision: Optional[CLIPVisionTower] = None):
        super().__init__()
        self.vision = vision if vision is not None else CLIPVisionTower(config)

    def forward(self, styles: torch.Tensor) -> torch.Tensor:
        b, n = styles.shape[:2]
        _, pooled = self.vision(styles.reshape((b * n,) + styles.shape[2:]))
        return pooled.reshape(b, n, -1)

