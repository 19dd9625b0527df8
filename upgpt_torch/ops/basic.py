"""Core NN ops on NHWC tensors, with the reference's numerics.

Port of `upgpt_tpu.ops.basic`:
- `group_norm`: GroupNorm(32) with float32 statistics whatever the input
  dtype, var = E[x^2] - E[x]^2 clamped at 0, result cast back to the input
  dtype (GroupNorm32, reference diffusionmodules/util.py:214-216).
- `timestep_embedding`: the U-Net's cos-first sinusoid (util.py:151-171).
- `timestep_embedding_ddpm`: the VAE `Model`'s sin-first fairseq
  embedding (model.py:12-30); the released weights do not use it.
- `silu`: x * sigmoid(x) (util.py:209-211).
- `nearest_upsample_2x`: F.interpolate(scale_factor=2, mode="nearest").
- `asymmetric_pad_hw`: the VAE downsample's (0, 1, 0, 1) zero pad
  (model.py:60-79).
- `normalize_to_clip`: [-1, 1] images to CLIP's normalised pixels
  (encoders/modules.py:218-230).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from upgpt_torch.data.transforms import CLIP_MEAN, CLIP_STD


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def group_norm(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int = 32,
    eps: float = 1e-5,
) -> torch.Tensor:
    """GroupNorm over the trailing channel dim of an (N, ..., C) tensor.

    Statistics are float32; `scale`/`bias` are per-channel (C,) vectors.
    """
    n, c = x.shape[0], x.shape[-1]
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by groups {num_groups}")
    xf = x.float().reshape(n, -1, num_groups, c // num_groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = torch.clamp(xf.square().mean(dim=(1, 3), keepdim=True)
                      - mean.square(), min=0.0)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y.reshape(n, -1, c) * scale.float() + bias.float()
    return y.reshape(x.shape).to(x.dtype)


def timestep_embedding(
    timesteps: torch.Tensor, dim: int, max_period: float = 10000.0
) -> torch.Tensor:
    """(B,) timesteps -> (B, dim) float32 [cos(t*f), sin(t*f)] embedding."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=timesteps.device)
        / half)
    args = timesteps.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def timestep_embedding_ddpm(timesteps: torch.Tensor, dim: int
                            ) -> torch.Tensor:
    """(B,) timesteps -> (B, dim) float32 [sin(t*f), cos(t*f)] with
    f = exp(-log(10000) * arange(half) / (half - 1))."""
    half = dim // 2
    scale = math.log(10000.0) / (half - 1)
    freqs = torch.exp(torch.arange(half, dtype=torch.float32,
                                   device=timesteps.device) * -scale)
    args = timesteps.float()[:, None] * freqs[None, :]
    out = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    if dim % 2:
        out = F.pad(out, (0, 1))
    return out


def nearest_upsample_2x(x: torch.Tensor) -> torch.Tensor:
    """2x nearest-neighbour upsample of an NHWC tensor."""
    n, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(n, h, 2, w, 2, c)
    return x.reshape(n, h * 2, w * 2, c)


def asymmetric_pad_hw(x: torch.Tensor) -> torch.Tensor:
    """Pad NHWC with (top 0, bottom 1, left 0, right 1) zeros."""
    return F.pad(x, (0, 0, 0, 1, 0, 1))


def normalize_to_clip(x: torch.Tensor,
                      out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Map NHWC images in [-1, 1] to CLIP's normalised pixel space:
    (x + 1) / 2, then the per-channel CLIP mean and std, in float32
    (FrozenClipImageEmbedder.preprocess, reference
    encoders/modules.py:218-230)."""
    x = (x.float() + 1.0) / 2.0
    return ((x - torch.from_numpy(CLIP_MEAN).to(x.device))
            / torch.from_numpy(CLIP_STD).to(x.device)).to(out_dtype)
