"""KL-regularised conv VAE, decode side, on NHWC tensors.

Port of the decoder half of `upgpt_tpu.models.vae` (reference CompVis
model.py: ResnetBlock 82-141, AttnBlock 150-203, Decoder 462-568;
autoencoder.py:285-423): GroupNorm(32) eps 1e-6 with float32 statistics,
swish, the single-head mid AttnBlock (scale c^-0.5, float32 softmax) through
`multi_head_attention(use_flash=...)`, nearest 2x upsampling. The encoder,
`DiagonalGaussian` and kl-f4 are not ported yet. The latent scale factor is
applied by the diffusion model, not here.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from upgpt_torch.models.layers import Conv2d, Norm
from upgpt_torch.ops.attention import multi_head_attention
from upgpt_torch.ops.basic import group_norm, nearest_upsample_2x, silu


@dataclasses.dataclass(frozen=True)
class AutoencoderConfig:
    embed_dim: int = 4
    z_channels: int = 4
    ch: int = 128
    ch_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    attn_resolutions: Tuple[int, ...] = ()
    out_ch: int = 3
    resolution: int = 256
    use_flash_attention: bool = False

    @classmethod
    def kl_f8(cls, **overrides) -> "AutoencoderConfig":
        return dataclasses.replace(cls(), **overrides)


def _gn(x: torch.Tensor, norm: Norm) -> torch.Tensor:
    return group_norm(x, norm.weight, norm.bias, num_groups=32, eps=1e-6)


class ResnetBlock(nn.Module):
    """GN->swish->conv ->GN->swish->conv + (1x1) shortcut."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.norm1 = Norm(in_channels)
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1)
        self.norm2 = Norm(out_channels)
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1)
        self.nin_shortcut = (Conv2d(in_channels, out_channels, 1)
                             if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(silu(_gn(x, self.norm1)))
        h = self.conv2(silu(_gn(h, self.norm2)))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head self-attention over the spatial grid + residual."""

    def __init__(self, channels: int, use_flash: bool = False):
        super().__init__()
        self.use_flash = use_flash
        self.norm = Norm(channels)
        self.q = Conv2d(channels, channels, 1)
        self.k = Conv2d(channels, channels, 1)
        self.v = Conv2d(channels, channels, 1)
        self.proj_out = Conv2d(channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, hh, ww, c = x.shape
        h = _gn(x, self.norm)
        q = self.q(h).reshape(b, hh * ww, c)
        k = self.k(h).reshape(b, hh * ww, c)
        v = self.v(h).reshape(b, hh * ww, c)
        out = multi_head_attention(q, k, v, num_heads=1,
                                   use_flash=self.use_flash)
        return x + self.proj_out(out.reshape(b, hh, ww, c))


class Upsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(nearest_upsample_2x(x))


class Decoder(nn.Module):
    """Reference model.py:462-568. forward(z) -> float32 NHWC image."""

    def __init__(self, cfg: AutoencoderConfig):
        super().__init__()
        self.config = cfg
        num_res = len(cfg.ch_mult)
        block_in = cfg.ch * cfg.ch_mult[-1]
        self.conv_in = Conv2d(cfg.z_channels, block_in, 3, padding=1)
        self.mid_block_1 = ResnetBlock(block_in, block_in)
        self.mid_attn_1 = AttnBlock(block_in, cfg.use_flash_attention)
        self.mid_block_2 = ResnetBlock(block_in, block_in)
        self._plan = []
        curr_res = cfg.resolution // 2 ** (num_res - 1)
        for i_level in reversed(range(num_res)):
            block_out = cfg.ch * cfg.ch_mult[i_level]
            for i_block in range(cfg.num_res_blocks + 1):
                name = f"up_{i_level}_block_{i_block}"
                self.add_module(name, ResnetBlock(block_in, block_out))
                self._plan.append(name)
                block_in = block_out
                if curr_res in cfg.attn_resolutions:
                    name = f"up_{i_level}_attn_{i_block}"
                    self.add_module(name, AttnBlock(
                        block_out, cfg.use_flash_attention))
                    self._plan.append(name)
            if i_level != 0:
                name = f"up_{i_level}_upsample"
                self.add_module(name, Upsample(block_out))
                self._plan.append(name)
                curr_res *= 2
        self.norm_out = Norm(block_in)
        self.conv_out = Conv2d(block_in, cfg.out_ch, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(z)
        h = self.mid_block_2(self.mid_attn_1(self.mid_block_1(h)))
        for name in self._plan:
            h = getattr(self, name)(h)
        h = self.conv_out(silu(_gn(h, self.norm_out)))
        return h.float()


class AutoencoderKL(nn.Module):
    """Decode side of the first stage: post_quant_conv + Decoder."""

    def __init__(self, cfg: AutoencoderConfig):
        super().__init__()
        self.config = cfg
        self.decoder = Decoder(cfg)
        self.post_quant_conv = Conv2d(cfg.embed_dim, cfg.z_channels, 1)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(z))
