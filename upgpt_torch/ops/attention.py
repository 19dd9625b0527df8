"""Multi-head attention core with a float32 softmax island.

Port of `upgpt_tpu.ops.attention`. Both functions are plain PyTorch, as they
are plain XLA in the JAX package; `multi_head_attention` dispatches to the
flash kernel (`ops/flash_attention.py`) when `use_flash` is set and the
shape qualifies. Scores are softmax(q k^T / sqrt(d)) with the scale split as
1/d**0.25 over q and k, the softmax in float32 and the probabilities cast to
v's dtype before the value product, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional

import torch


def multi_head_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int,
    mask: Optional[torch.Tensor] = None,
    use_flash: bool = False,
) -> torch.Tensor:
    """Attention over (B, Tq, H*D) queries and (B, Tk, H*D) keys/values.

    Returns (B, Tq, H*D) in q's dtype. `mask` is an optional (B, Tk) bool
    where False positions are excluded.
    """
    b, tq, inner = q.shape
    tk = k.shape[1]
    if inner % num_heads:
        raise ValueError(f"width {inner} not divisible by {num_heads} heads")
    d = inner // num_heads

    if use_flash and mask is None:
        from upgpt_torch.ops.flash_attention import (
            flash_attention, flash_attention_qualifies,
        )

        if flash_attention_qualifies(b, num_heads, tq, tk, d, q.dtype):
            qh = q.reshape(b, tq, num_heads, d).transpose(1, 2)
            kh = k.reshape(b, tk, num_heads, d).transpose(1, 2)
            vh = v.reshape(b, tk, num_heads, d).transpose(1, 2)
            out = flash_attention(qh.contiguous(), kh.contiguous(),
                                  vh.contiguous())
            return out.transpose(1, 2).reshape(b, tq, inner)

    scale = 1.0 / math.sqrt(math.sqrt(d))
    qh = (q * scale).reshape(b, tq, num_heads, d)
    kh = (k * scale).reshape(b, tk, num_heads, d)
    vh = v.reshape(b, tk, num_heads, d)
    scores = torch.einsum("bqhd,bkhd->bhqk", qh.float(), kh.float())
    if mask is not None:
        neg = torch.finfo(torch.float32).min
        scores = torch.where(mask[:, None, None, :], scores, neg)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), vh.float())
    return out.to(q.dtype).reshape(b, tq, inner)


def attention_weight_split(
    z_q: torch.Tensor,
    kv_src: Optional[torch.Tensor],
    attn_params: Mapping[str, Mapping[str, torch.Tensor]],
    num_heads: int,
    kv=None,
    bias: bool = True,
) -> torch.Tensor:
    """Attention with the head split taken on the weights.

    `attn_params` holds `to_q`/`to_k`/`to_v`/`to_out`, each a
    {"weight": (out, in)[, "bias"]} dict in nn.Linear layout. `kv` is an
    optional precomputed packed (B, Tk, H*D) (k, v) pair. Same math as
    `multi_head_attention`; the output includes `to_out`'s projection and,
    unless `bias` is False (a tensor-parallel shard's row partial), its
    bias.
    """
    comp = z_q.dtype
    wq = attn_params["to_q"]["weight"].to(comp)
    inner, cin = wq.shape
    d = inner // num_heads
    scale = 1.0 / math.sqrt(math.sqrt(d))
    qh = torch.einsum("btc,hdc->bhtd", z_q * scale,
                      wq.reshape(num_heads, d, cin))
    if kv is not None:
        k, v = kv
        b, tk, _ = k.shape
        kh = k.reshape(b, tk, num_heads, d).transpose(1, 2)
        vh = v.reshape(b, tk, num_heads, d).transpose(1, 2)
    else:
        src = z_q if kv_src is None else kv_src.to(comp)
        wk = attn_params["to_k"]["weight"].to(comp)
        wv = attn_params["to_v"]["weight"].to(comp)
        kh = torch.einsum("bsc,hdc->bhsd", src,
                          wk.reshape(num_heads, d, wk.shape[-1]))
        vh = torch.einsum("bsc,hdc->bhsd", src,
                          wv.reshape(num_heads, d, wv.shape[-1]))
    kh = kh * scale
    scores = torch.einsum("bhtd,bhsd->bhts", qh.float(), kh.float())
    probs = torch.softmax(scores, dim=-1).to(vh.dtype)
    oh = torch.einsum("bhts,bhsd->bhtd", probs.float(), vh.float()).to(comp)
    wo = attn_params["to_out"]["weight"].to(comp)
    out = torch.einsum("bhtd,chd->btc", oh,
                       wo.reshape(wo.shape[0], num_heads, d))
    return out + attn_params["to_out"]["bias"].to(comp) if bias else out
