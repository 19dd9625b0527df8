"""Model zoo: named builders for the ported UPGPT variants.

Port of `upgpt_tpu.zoo` for the 256px variants, the direct 512px model,
the upscale stage of the 256->512 chain and the CI geometries:

| variant      | latent   | concat        | context            | first stage |
|--------------|----------|---------------|--------------------|-------------|
| pt_256       | 32x24x4  | bbox mask 1ch | 77 txt + 9 sty + 1 | kl-f8       |
| interp_256   | 32x24x4  | bbox mask 1ch | same               | kl-f8       |
| inshop_laion | 32x24x4  | smpl mask 1ch | 77 fused txt + 1   | kl-f8       |
| mm_512       | 64x48x4  | smpl mask 1ch | same               | kl-f8 512px |
| upscale      | 128x96x3 | lr image 3ch  | 77 txt + 9 sty     | kl-f4       |
| tiny         | 32x24x4  | mask 1ch      | 77 txt + 9 sty + 1 | tiny kl-f8  |
| tiny_upscale | 32x24x3  | lr image 3ch  | 77 txt + 9 sty     | tiny kl-f4  |

`dtype` is the compute dtype and `param_dtype` the parameters' (flax's
`dtype` and `param_dtype`; by default the same). The sampling path keeps
both bf16; training keeps float32 masters under bf16 compute:

    build_latent_diffusion("interp_256", dtype="bfloat16",
                           param_dtype="float32", use_fused_groupnorm=True)

The kernel switches mirror the JAX configs. `use_fused_transformer` routes
the qualifying SpatialTransformers to the CUDA block kernel,
`use_flash_attention` lets long self-attention (U-Net and the VAE's mid
AttnBlock) use the flash kernels, `use_fused_groupnorm` routes the U-Net's
GroupNorm+SiLU to the one-pass kernel (ResBlock level 1 and the out head),
`use_fused_resblock` routes the U-Net's qualifying ResBlock half-steps to
the GroupNorm+SiLU+conv kernel (level 2), and `use_fused_vae_groupnorm`
routes every VAE GroupNorm to the GroupNorm kernels (the one-pass or the
row-tiled one), the JAX `AutoencoderConfig.use_fused_groupnorm`. The first
two are on by default, as the sampling benchmark configures them; the rest
are off. The training benchmark turns on `use_fused_groupnorm`; the
256->512 chain turns on the three GroupNorm switches:

    build_latent_diffusion("upscale", dtype="bfloat16",
                           use_fused_groupnorm=True, use_fused_resblock=True,
                           use_fused_vae_groupnorm=True)

On CPU tensors every kernel runs its plain version.

`build_autoencoder` builds the first stage alone (`configs/autoencoder/`),
float32 parameters under the compute dtype, as flax's `dtype` over a
float32 `param_dtype`, with flash attention and the GroupNorm kernels off
unless `**over` turns them on, as JAX's `AutoencoderConfig` has them.

`use_checkpoint` is the configs' rematerialisation switch (the
inshop_laion config sets it): `torch.utils.checkpoint` over every ResBlock
and SpatialTransformer, whose kernels then launch again in the backward.

The model is built on the CUDA card unless the caller asks for another
device; without a card that raises.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from upgpt_torch.diffusion.latent_diffusion import (
    LatentDiffusion, LatentDiffusionConfig,
)
from upgpt_torch.models.unet import UNetConfig
from upgpt_torch.models.vae import AutoencoderConfig, AutoencoderKL

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


_UNET_SWITCHES = ("use_flash_attention", "use_fused_transformer",
                  "use_fused_groupnorm", "use_fused_resblock")


def _unet(kernels) -> dict:
    return {k: kernels[k] for k in _UNET_SWITCHES}


def _vae(kernels) -> dict:
    return {"use_flash_attention": kernels["use_flash_attention"],
            "use_fused_groupnorm": kernels["use_fused_vae_groupnorm"]}


def _unet_256(comp, kernels) -> UNetConfig:
    # models/upgpt/interp_256/config.yaml:40-55
    return UNetConfig(
        in_channels=5, model_channels=224, out_channels=4, num_res_blocks=2,
        attention_resolutions=(4, 2, 1), channel_mult=(1, 2, 4, 4),
        num_heads=8, transformer_depth=1, context_dim=768, dtype=comp,
        **_unet(kernels))


def _pt_256(comp, kernels) -> LatentDiffusionConfig:
    return LatentDiffusionConfig(
        unet=_unet_256(comp, kernels),
        vae=AutoencoderConfig.kl_f8(dtype=comp, **_vae(kernels)),
        latent_size=(32, 24), latent_channels=4)


def _interp_256(comp, kernels) -> LatentDiffusionConfig:
    return _pt_256(comp, kernels)  # same graph; loss weights are data-side


def _inshop_laion(comp, kernels) -> LatentDiffusionConfig:
    # configs/deepfashion/inshop_laion_clip.yaml: the interp geometry with
    # the cond_stage_key_2 route, a TRAINABLE text-style CrossAttention over
    # laion-CLIP embeddings (exact-GELU towers), an smpl RPM mask, and a
    # context of the fused text (77) and the pose token
    return dataclasses.replace(_pt_256(comp, kernels), cond_fusion="image")


def _mm_512(comp, kernels) -> LatentDiffusionConfig:
    # models/upgpt/mm_512/config.yaml: 512x384 -> 64x48 latent, smpl RPM.
    # The interp_256 U-Net over 4x the tokens: its ds1 blocks (T 3072) run
    # the twin with the flash kernel for self-attention, ds2 (768, 448) the
    # block kernel, and the decoder's mid AttnBlock T 3072.
    return LatentDiffusionConfig(
        unet=_unet_256(comp, kernels),
        vae=AutoencoderConfig.kl_f8(dtype=comp, resolution=512,
                                    **_vae(kernels)),
        latent_size=(64, 48), latent_channels=4)


def _upscale(comp, kernels) -> LatentDiffusionConfig:
    # models/upgpt/upscale/config.yaml:14-23,37-81
    return LatentDiffusionConfig.upscale_512(
        unet=UNetConfig.upscale_512(dtype=comp, **_unet(kernels)),
        vae=AutoencoderConfig.kl_f4(dtype=comp, resolution=512,
                                    **_vae(kernels)))


def _tiny(comp, kernels) -> LatentDiffusionConfig:
    """Miniature CI geometry (upgpt_tpu/zoo.py `tiny`): the full topology —
    hybrid concat, 87-token context, pose stage — at a fraction of the
    compute."""
    return LatentDiffusionConfig(
        unet=UNetConfig(
            in_channels=5, model_channels=32, out_channels=4,
            num_res_blocks=1, attention_resolutions=(1, 2),
            channel_mult=(1, 2), num_heads=4, context_dim=768, dtype=comp,
            **_unet(kernels)),
        vae=AutoencoderConfig(
            embed_dim=4, z_channels=4, ch=32, ch_mult=(1, 2),
            num_res_blocks=1, resolution=64, dtype=comp, **_vae(kernels)),
        timesteps=1000, latent_size=(32, 24), latent_channels=4)


def _tiny_upscale(comp, kernels) -> LatentDiffusionConfig:
    """Miniature upscale-stage CI geometry (upgpt_tpu/zoo.py
    `tiny_upscale`): lr-image concat (6 channels in, 3 out), a z=3 first
    stage and no pose token; pairs with `tiny` for the chained tests."""
    return LatentDiffusionConfig(
        unet=UNetConfig(
            in_channels=6, model_channels=32, out_channels=3,
            num_res_blocks=1, attention_resolutions=(2,),
            channel_mult=(1, 2), num_heads=4, context_dim=768, dtype=comp,
            **_unet(kernels)),
        vae=AutoencoderConfig(
            embed_dim=3, z_channels=3, ch=32, ch_mult=(1, 2),
            num_res_blocks=1, resolution=64, dtype=comp, **_vae(kernels)),
        timesteps=1000, latent_size=(32, 24), latent_channels=3,
        pose_input_dim=None, linear_start=1e-4, linear_end=2e-2)


_BUILDERS = {"pt_256": _pt_256, "interp_256": _interp_256,
             "inshop_laion": _inshop_laion, "mm_512": _mm_512,
             "upscale": _upscale, "tiny": _tiny,
             "tiny_upscale": _tiny_upscale}


def _dtype(d: Union[str, torch.dtype]) -> torch.dtype:
    return _DTYPES[d] if isinstance(d, str) else d


def _on(device: Union[str, torch.device], builder: str) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{builder}: no CUDA card is available; the port builds on the "
            f"card unless device='cpu' is given")
    return device


def build_latent_diffusion(
    variant: str = "interp_256",
    dtype: Union[str, torch.dtype] = "float32",
    param_dtype: Optional[Union[str, torch.dtype]] = None,
    device: Union[str, torch.device] = "cuda",
    use_flash_attention: bool = True,
    use_fused_transformer: bool = True,
    use_fused_groupnorm: bool = False,
    use_fused_resblock: bool = False,
    use_fused_vae_groupnorm: bool = False,
    use_checkpoint: bool = False,
    **overrides,
) -> LatentDiffusion:
    """Build a variant with freshly initialised weights in `param_dtype`
    (default: `dtype`), computing in `dtype`, on `device` (the CUDA card
    unless the caller names another device)."""
    if variant not in _BUILDERS:
        raise KeyError(f"unknown variant {variant!r}; have {list(_BUILDERS)}")
    device = _on(device, "build_latent_diffusion")
    comp = _dtype(dtype)
    kernels = {"use_flash_attention": use_flash_attention,
               "use_fused_transformer": use_fused_transformer,
               "use_fused_groupnorm": use_fused_groupnorm,
               "use_fused_resblock": use_fused_resblock,
               "use_fused_vae_groupnorm": use_fused_vae_groupnorm}
    cfg = _BUILDERS[variant](comp, kernels)
    cfg = dataclasses.replace(cfg, unet=dataclasses.replace(
        cfg.unet, use_checkpoint=use_checkpoint))
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return LatentDiffusion(cfg).to(
        device=device, dtype=_dtype(param_dtype or dtype)).eval()


def build_autoencoder(kind: str = "kl_f8",
                      dtype: Union[str, torch.dtype] = "float32",
                      device: Union[str, torch.device] = "cuda",
                      **over) -> AutoencoderKL:
    """kl-f8 or kl-f4 (`kind`) with `AutoencoderConfig` fields in `over`,
    float32 parameters computing in `dtype`, on `device` (the card unless
    the caller names another device)."""
    if kind not in ("kl_f8", "kl_f4"):
        raise KeyError(f"unknown autoencoder {kind!r}; have kl_f8, kl_f4")
    device = _on(device, "build_autoencoder")
    cfg = getattr(AutoencoderConfig, kind)(dtype=_dtype(dtype), **over)
    return AutoencoderKL(cfg).to(device=device, dtype=torch.float32).eval()
