"""KL-regularised conv VAE on NHWC tensors.

Port of `upgpt_tpu.models.vae` (reference CompVis model.py: ResnetBlock
82-141, AttnBlock 150-203, Encoder 368-459, Decoder 462-568;
autoencoder.py:285-423; distributions.py:24-62): GroupNorm(32) eps 1e-6 with
float32 statistics, swish, the single-head mid AttnBlock (scale c^-0.5,
float32 softmax) through `multi_head_attention(use_flash=...)`, nearest 2x
upsampling, and the encoder's asymmetric (0, 1, 0, 1) pad before a VALID
stride-2 conv. `encode` returns a `DiagonalGaussian` over float32 moments.
`AutoencoderConfig.dtype` is the compute dtype (see models/layers.py).
`kl_f8` is the main stage, `kl_f4` the upscale stage (z=3, ch_mult 1/2/4).
`AutoencoderKL.forward` samples the posterior and decodes, returning
`(dec, posterior)` as JAX's `__call__` does; the posterior's `kl` and
`nll` feed the first stage's training loss (`training/vae_loss.py`).
`use_fused_groupnorm` routes every norm through `VAEGroupNorm` to the
GroupNorm kernels (`ops/fused_gn.py`): the one-pass kernel where it
qualifies, the row-tiled one for decode-size tensors, as the JAX
VAEGroupNorm does. The latent scale factor is applied by the diffusion
model, not here. `AutoencoderKL.decode` is a `vae.decode` span
(`utils/diagnostics.py`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
from torch import nn

from upgpt_torch.models.layers import Conv2d, Norm
from upgpt_torch.ops.attention import multi_head_attention
from upgpt_torch.ops.basic import (
    asymmetric_pad_hw, group_norm, nearest_upsample_2x, silu,
)
from upgpt_torch.ops.fused_gn import (
    fused_group_norm, fused_group_norm_qualifies, tiled_group_norm_qualifies,
)
from upgpt_torch.utils.diagnostics import span


@dataclasses.dataclass(frozen=True)
class AutoencoderConfig:
    embed_dim: int = 4
    z_channels: int = 4
    # the encoder emits mean and log-variance (the reference's double_z)
    double_z: bool = True
    ch: int = 128
    ch_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    attn_resolutions: Tuple[int, ...] = ()
    in_channels: int = 3
    out_ch: int = 3
    resolution: int = 256
    # dropout between a ResnetBlock's second norm and conv, in train mode
    # only; JAX's paths, training included, call the VAE deterministic
    dropout: float = 0.0
    use_flash_attention: bool = False
    # every GroupNorm through the CUDA GroupNorm kernels (VAEGroupNorm)
    use_fused_groupnorm: bool = False
    dtype: Optional[torch.dtype] = None  # compute dtype; None: the params'

    @classmethod
    def kl_f8(cls, **overrides) -> "AutoencoderConfig":
        return dataclasses.replace(cls(), **overrides)

    @classmethod
    def kl_f4(cls, **overrides) -> "AutoencoderConfig":
        # models/upgpt/upscale/config.yaml:60-81
        base = cls(embed_dim=3, z_channels=3, ch_mult=(1, 2, 4))
        return dataclasses.replace(base, **overrides)


class VAEGroupNorm(Norm):
    """GroupNorm(32), eps 1e-6, float32 statistics, optional SiLU. With
    `fused`, an NHWC tensor goes to `fused_group_norm` (the one-pass kernel
    for latent-size tensors, the row-tiled one for decode-size ones) where
    either gate admits it, else the plain path runs (counted in
    `fused_group_norm.plain_routes`)."""

    def __init__(self, channels: int, fused: bool = False,
                 with_silu: bool = False):
        super().__init__(channels)
        self.fused = fused
        self.with_silu = with_silu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused:
            if x.dim() == 4 and (fused_group_norm_qualifies(x.shape, 32)
                                 or tiled_group_norm_qualifies(x.shape, 32)):
                return fused_group_norm(x, self.weight, self.bias, 32, 1e-6,
                                        self.with_silu)
            fused_group_norm.plain_routes += 1
        out = group_norm(x, self.weight, self.bias, num_groups=32, eps=1e-6)
        return silu(out) if self.with_silu else out


class ResnetBlock(nn.Module):
    """GN->swish->conv ->GN->swish->dropout->conv + (1x1) shortcut."""

    def __init__(self, in_channels: int, out_channels: int, dtype=None,
                 fused_gn: bool = False, dropout: float = 0.0):
        super().__init__()
        self.norm1 = VAEGroupNorm(in_channels, fused_gn, with_silu=True)
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1,
                            dtype=dtype)
        self.norm2 = VAEGroupNorm(out_channels, fused_gn, with_silu=True)
        self.dropout = nn.Dropout(dropout) if dropout > 0 else nn.Identity()
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1,
                            dtype=dtype)
        self.nin_shortcut = (Conv2d(in_channels, out_channels, 1, dtype=dtype)
                             if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv2(self.dropout(self.norm2(self.conv1(self.norm1(x)))))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head self-attention over the spatial grid + residual."""

    def __init__(self, channels: int, use_flash: bool = False, dtype=None,
                 fused_gn: bool = False):
        super().__init__()
        self.use_flash = use_flash
        self.norm = VAEGroupNorm(channels, fused_gn)
        self.q = Conv2d(channels, channels, 1, dtype=dtype)
        self.k = Conv2d(channels, channels, 1, dtype=dtype)
        self.v = Conv2d(channels, channels, 1, dtype=dtype)
        self.proj_out = Conv2d(channels, channels, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, hh, ww, c = x.shape
        h = self.norm(x)
        q = self.q(h).reshape(b, hh * ww, c)
        k = self.k(h).reshape(b, hh * ww, c)
        v = self.v(h).reshape(b, hh * ww, c)
        out = multi_head_attention(q, k, v, num_heads=1,
                                   use_flash=self.use_flash)
        return x + self.proj_out(out.reshape(b, hh, ww, c))


class Upsample(nn.Module):
    def __init__(self, channels: int, dtype=None):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1, dtype=dtype)

    def forward(self, x):
        return self.conv(nearest_upsample_2x(x))


class Downsample(nn.Module):
    """(0, 1, 0, 1) zero pad + VALID stride-2 3x3 conv (model.py:60-79)."""

    def __init__(self, channels: int, dtype=None):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, stride=2, dtype=dtype)

    def forward(self, x):
        return self.conv(asymmetric_pad_hw(x))


class Encoder(nn.Module):
    """Reference model.py:368-459. forward(x) -> float32 NHWC moments."""

    def __init__(self, cfg: AutoencoderConfig):
        super().__init__()
        comp, fgn = cfg.dtype, cfg.use_fused_groupnorm
        self.conv_in = Conv2d(cfg.in_channels, cfg.ch, 3, padding=1,
                              dtype=comp)
        self._plan = []
        curr_res = cfg.resolution
        block_in = cfg.ch
        for i_level, mult in enumerate(cfg.ch_mult):
            block_out = cfg.ch * mult
            for i_block in range(cfg.num_res_blocks):
                name = f"down_{i_level}_block_{i_block}"
                self.add_module(name, ResnetBlock(block_in, block_out, comp,
                                                  fgn, cfg.dropout))
                self._plan.append(name)
                block_in = block_out
                if curr_res in cfg.attn_resolutions:
                    name = f"down_{i_level}_attn_{i_block}"
                    self.add_module(name, AttnBlock(
                        block_out, cfg.use_flash_attention, comp, fgn))
                    self._plan.append(name)
            if i_level != len(cfg.ch_mult) - 1:
                name = f"down_{i_level}_downsample"
                self.add_module(name, Downsample(block_out, comp))
                self._plan.append(name)
                curr_res //= 2
        self.mid_block_1 = ResnetBlock(block_in, block_in, comp, fgn,
                                       cfg.dropout)
        self.mid_attn_1 = AttnBlock(block_in, cfg.use_flash_attention, comp,
                                    fgn)
        self.mid_block_2 = ResnetBlock(block_in, block_in, comp, fgn,
                                       cfg.dropout)
        self.norm_out = VAEGroupNorm(block_in, fgn, with_silu=True)
        z = 2 * cfg.z_channels if cfg.double_z else cfg.z_channels
        self.conv_out = Conv2d(block_in, z, 3, padding=1, dtype=comp)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for name in self._plan:
            h = getattr(self, name)(h)
        h = self.mid_block_2(self.mid_attn_1(self.mid_block_1(h)))
        return self.conv_out(self.norm_out(h)).float()


class Decoder(nn.Module):
    """Reference model.py:462-568. forward(z) -> float32 NHWC image."""

    def __init__(self, cfg: AutoencoderConfig):
        super().__init__()
        self.config = cfg
        comp, fgn = cfg.dtype, cfg.use_fused_groupnorm
        num_res = len(cfg.ch_mult)
        block_in = cfg.ch * cfg.ch_mult[-1]
        self.conv_in = Conv2d(cfg.z_channels, block_in, 3, padding=1,
                              dtype=comp)
        self.mid_block_1 = ResnetBlock(block_in, block_in, comp, fgn,
                                       cfg.dropout)
        self.mid_attn_1 = AttnBlock(block_in, cfg.use_flash_attention, comp,
                                    fgn)
        self.mid_block_2 = ResnetBlock(block_in, block_in, comp, fgn,
                                       cfg.dropout)
        self._plan = []
        curr_res = cfg.resolution // 2 ** (num_res - 1)
        for i_level in reversed(range(num_res)):
            block_out = cfg.ch * cfg.ch_mult[i_level]
            for i_block in range(cfg.num_res_blocks + 1):
                name = f"up_{i_level}_block_{i_block}"
                self.add_module(name, ResnetBlock(block_in, block_out, comp,
                                                  fgn, cfg.dropout))
                self._plan.append(name)
                block_in = block_out
                if curr_res in cfg.attn_resolutions:
                    name = f"up_{i_level}_attn_{i_block}"
                    self.add_module(name, AttnBlock(
                        block_out, cfg.use_flash_attention, comp, fgn))
                    self._plan.append(name)
            if i_level != 0:
                name = f"up_{i_level}_upsample"
                self.add_module(name, Upsample(block_out, comp))
                self._plan.append(name)
                curr_res *= 2
        self.norm_out = VAEGroupNorm(block_in, fgn, with_silu=True)
        self.conv_out = Conv2d(block_in, cfg.out_ch, 3, padding=1, dtype=comp)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(z)
        h = self.mid_block_2(self.mid_attn_1(self.mid_block_1(h)))
        for name in self._plan:
            h = getattr(self, name)(h)
        return self.conv_out(self.norm_out(h)).float()


class DiagonalGaussian:
    """VAE posterior over (B, h, w, 2z) moments (distributions.py:24-62):
    logvar clamped to [-30, 20]."""

    def __init__(self, moments: torch.Tensor):
        self.mean, logvar = moments.chunk(2, dim=-1)
        self.logvar = torch.clamp(logvar, -30.0, 20.0)
        self.std = torch.exp(0.5 * self.logvar)
        self.var = torch.exp(self.logvar)

    def sample(self, noise: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """mean + std * noise; `noise` is drawn from `generator` when not
        given."""
        if noise is None:
            noise = torch.randn(self.mean.shape, generator=generator,
                                device=self.mean.device,
                                dtype=self.mean.dtype)
        return self.mean + self.std * noise

    def mode(self) -> torch.Tensor:
        return self.mean

    def kl(self, other: Optional["DiagonalGaussian"] = None) -> torch.Tensor:
        """(B,) KL divergence to `other`, or to the standard normal."""
        dims = tuple(range(1, self.mean.dim()))
        if other is None:
            return 0.5 * torch.sum(self.mean.square() + self.var - 1.0
                                   - self.logvar, dim=dims)
        return 0.5 * torch.sum(
            (self.mean - other.mean).square() / other.var
            + self.var / other.var - 1.0 - self.logvar + other.logvar,
            dim=dims)

    def nll(self, sample: torch.Tensor) -> torch.Tensor:
        """(B,) negative log-likelihood of `sample`."""
        dims = tuple(range(1, self.mean.dim()))
        return 0.5 * torch.sum(
            math.log(2.0 * math.pi) + self.logvar
            + (sample - self.mean).square() / self.var, dim=dims)


class AutoencoderKL(nn.Module):
    """Encoder + 1x1 quant/post-quant convs + Decoder."""

    def __init__(self, cfg: AutoencoderConfig):
        super().__init__()
        self.config = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        factor = 2 if cfg.double_z else 1
        self.quant_conv = Conv2d(factor * cfg.z_channels,
                                 factor * cfg.embed_dim, 1, dtype=cfg.dtype)
        # the posterior's mean: half the moments (JAX's tree without
        # double_z too; the reference's AutoencoderKL requires it)
        self.post_quant_conv = Conv2d(factor * cfg.embed_dim // 2,
                                      cfg.z_channels, 1, dtype=cfg.dtype)

    def encode(self, x: torch.Tensor) -> DiagonalGaussian:
        moments = self.quant_conv(self.encoder(x))
        return DiagonalGaussian(moments.float())

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        with span("vae.decode"):
            return self.decoder(self.post_quant_conv(z))

    def forward(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                sample_posterior: bool = True):
        """(decoded image, posterior) of an NHWC image: the decode of a
        posterior sample (`noise`, else drawn from `generator`) or of its
        mode."""
        posterior = self.encode(x)
        z = (posterior.sample(noise, generator) if sample_posterior
             else posterior.mode())
        return self.decode(z), posterior
