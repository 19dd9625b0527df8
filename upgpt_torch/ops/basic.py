"""Core NN ops on NHWC tensors, with the reference's numerics.

Port of `upgpt_tpu.ops.basic`:
- `group_norm`: GroupNorm(32) with float32 statistics whatever the input
  dtype, var = E[x^2] - E[x]^2 clamped at 0, result cast back to the input
  dtype (GroupNorm32, reference diffusionmodules/util.py:214-216).
- `timestep_embedding`: the U-Net's cos-first sinusoid (util.py:151-171).
- `silu`: x * sigmoid(x) (util.py:209-211).
- `nearest_upsample_2x`: F.interpolate(scale_factor=2, mode="nearest").
"""

from __future__ import annotations

import math

import torch


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


def nearest_upsample_2x(x: torch.Tensor) -> torch.Tensor:
    """2x nearest-neighbour upsample of an NHWC tensor."""
    n, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(n, h, 2, w, 2, c)
    return x.reshape(n, h * 2, w * 2, c)
