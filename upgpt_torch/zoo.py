"""Model zoo: named builders for the ported UPGPT variants.

Port of `upgpt_tpu.zoo` for the 256px variants and the CI geometry:

| variant    | latent  | concat        | context            | first stage |
|------------|---------|---------------|--------------------|-------------|
| pt_256     | 32x24x4 | bbox mask 1ch | 77 txt + 9 sty + 1 | kl-f8       |
| interp_256 | 32x24x4 | bbox mask 1ch | same               | kl-f8       |
| tiny       | 32x24x4 | mask 1ch      | same               | tiny kl-f8  |

The kernel switches are on by default, as the JAX package's sampling
benchmark configures the same program: `use_fused_transformer` routes the
qualifying SpatialTransformers to the CUDA block kernel and
`use_flash_attention` lets long self-attention (U-Net and the VAE's mid
AttnBlock) use the flash kernel. On CPU tensors both run their plain
versions.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from upgpt_torch.diffusion.latent_diffusion import (
    LatentDiffusion, LatentDiffusionConfig,
)
from upgpt_torch.models.unet import UNetConfig
from upgpt_torch.models.vae import AutoencoderConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _unet_256(flash: bool, fused: bool) -> UNetConfig:
    # models/upgpt/interp_256/config.yaml:40-55
    return UNetConfig(
        in_channels=5, model_channels=224, out_channels=4, num_res_blocks=2,
        attention_resolutions=(4, 2, 1), channel_mult=(1, 2, 4, 4),
        num_heads=8, transformer_depth=1, context_dim=768,
        use_flash_attention=flash, use_fused_transformer=fused)


def _pt_256(flash: bool, fused: bool) -> LatentDiffusionConfig:
    return LatentDiffusionConfig(
        unet=_unet_256(flash, fused),
        vae=AutoencoderConfig.kl_f8(use_flash_attention=flash),
        latent_size=(32, 24), latent_channels=4)


def _interp_256(flash: bool, fused: bool) -> LatentDiffusionConfig:
    return _pt_256(flash, fused)  # same graph; loss weights are data-side


def _tiny(flash: bool, fused: bool) -> LatentDiffusionConfig:
    """Miniature CI geometry (upgpt_tpu/zoo.py `tiny`): the full topology —
    hybrid concat, 87-token context, pose stage — at a fraction of the
    compute."""
    return LatentDiffusionConfig(
        unet=UNetConfig(
            in_channels=5, model_channels=32, out_channels=4,
            num_res_blocks=1, attention_resolutions=(1, 2),
            channel_mult=(1, 2), num_heads=4, context_dim=768,
            use_flash_attention=flash, use_fused_transformer=fused),
        vae=AutoencoderConfig(
            embed_dim=4, z_channels=4, ch=32, ch_mult=(1, 2),
            num_res_blocks=1, resolution=64, use_flash_attention=flash),
        timesteps=1000, latent_size=(32, 24), latent_channels=4)


_BUILDERS = {"pt_256": _pt_256, "interp_256": _interp_256, "tiny": _tiny}


def build_latent_diffusion(
    variant: str = "interp_256",
    dtype: Union[str, torch.dtype] = "float32",
    device: Optional[Union[str, torch.device]] = None,
    use_flash_attention: bool = True,
    use_fused_transformer: bool = True,
    **overrides,
) -> LatentDiffusion:
    """Build a variant with freshly initialised weights, cast to `dtype`
    and moved to `device` (CPU when None)."""
    if variant not in _BUILDERS:
        raise KeyError(f"unknown variant {variant!r}; have {list(_BUILDERS)}")
    comp = _DTYPES[dtype] if isinstance(dtype, str) else dtype
    cfg = _BUILDERS[variant](use_flash_attention, use_fused_transformer)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return LatentDiffusion(cfg).to(device=device, dtype=comp).eval()
