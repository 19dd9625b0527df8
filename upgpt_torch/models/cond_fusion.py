"""CLIPTextImageCrossAtten's trainable text-style fusion.

Port of `upgpt_tpu.models.cond_fusion` (reference encoders/modules.py:
259-323). Frozen laion CLIP towers (exact GELU) encode the caption to its
77x768 last hidden state and the nine style slots to pooled embeddings
(from the crops in the `image` mode, from per-slot texts in the `text`
mode); a TRAINABLE CrossAttention(query 768, context 768, 8 heads of 96)
lets the text tokens attend over the style slots. The fused 77 tokens
replace text and styles in the context, so it is 77 + 1 pose token
(configs/deepfashion/inshop_laion_clip.yaml, cond_stage_key_2).

The towers live in `inference/encoders.py`; the fusion is
`LatentDiffusion.cond_fusion` and trains with the U-Net and the pose stage
(reference ddpm.py:1501-1509, cond_stage_trainable).
"""

from __future__ import annotations

import torch
from torch import nn

from upgpt_torch.models.unet import CrossAttention


class TextStyleCrossAttention(nn.Module):
    """text hidden states (B, T, D) x style embeddings (B, S, D) ->
    (B, T, D), computed in float32 (the JAX module's default dtype)."""

    def __init__(self, dim: int = 768, num_heads: int = 8,
                 head_dim: int = 96):
        super().__init__()
        self.cross_att = CrossAttention(dim, dim, num_heads * head_dim,
                                        num_heads=num_heads,
                                        dtype=torch.float32)

    def forward(self, text_hidden: torch.Tensor,
                style_emb: torch.Tensor) -> torch.Tensor:
        return self.cross_att(text_hidden, context=style_emb)


class CLIPTextImageCrossAttenStage:
    """The cond stage as one callable: the frozen towers of `cond_encoder`
    (a `CLIPConditioningEncoder`) and a fusion module. `style_encode`
    'image' fuses the crops' pooled vision embeddings, 'text' the pooled
    text embeddings of per-slot texts (modules.py:306-316)."""

    def __init__(self, cond_encoder, fusion: TextStyleCrossAttention,
                 style_encode: str = "image"):
        if style_encode not in ("image", "text"):
            raise ValueError(f"style_encode {style_encode!r}: expected "
                             f"'image' or 'text'")
        self.encoder = cond_encoder
        self.fusion = fusion
        self.style_encode = style_encode

    def __call__(self, txt, styles) -> torch.Tensor:
        text_hidden = self.encoder.text_hidden(txt)
        if self.style_encode == "image":
            style_emb = self.encoder.style_embeddings(styles)
        else:
            style_emb = torch.stack([self.encoder.text_pooled(s)
                                     for s in styles])
        return self.fusion(text_hidden, style_emb)
