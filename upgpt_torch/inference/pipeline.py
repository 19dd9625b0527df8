"""Generation: conditioning embeddings -> DDIM -> decoded images.

Port of `upgpt_tpu.inference.pipeline.GenerationPipeline` (reference
ldm/data/generate_utils.py:131-190). Conditioning enters as embeddings —
text (77, 768), style slots (9, 768), SMPL (1, 85) — with the person mask
(h, w, 1) as the latent channel concat. The cross-attention K/V of the fixed
context are projected once before the step loop (`precompute_cross_kv`).

Only the DDIM sampler on the uniform grid is ported; "dpm++" and "unipc"
raise NotImplementedError. `shared_x_T` broadcasts one initial draw over the
batch, as the reference's seeded interpolation does (ddpm.py:1433-1437).

The chained 256->512 path (app.py:93-97, 262-278, 379-409) is
`ChainedUpscalePipeline`: the 256 model's float image, `prepare_lr_condition`
to the upscale stage's latent grid, and the upscale model's lr-conditioned
DDIM in kl-f4 latent space, decoded to 512x384. `UpscalePipeline` is the
second stage alone.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from upgpt_torch.diffusion.ddim import ddim_sample
from upgpt_torch.diffusion.latent_diffusion import LatentDiffusion
from upgpt_torch.diffusion.schedule import make_ddim_schedule
from upgpt_torch.models.unet import precompute_cross_kv


class GenerationPipeline:
    """text + style + pose embeddings -> images for one model."""

    def __init__(
        self,
        model: LatentDiffusion,
        num_steps: int = 200,
        eta: float = 1.0,
        guidance_scale: float = 1.0,
        decode: bool = True,
        output_uint8: bool = False,
        sampler: str = "ddim",
    ):
        if sampler in ("dpm++", "unipc"):
            raise NotImplementedError(
                f"sampler {sampler!r} is not ported to upgpt_torch yet")
        if sampler != "ddim":
            raise ValueError(f"unknown sampler {sampler!r}")
        self.model = model
        self.eta = eta
        self.guidance_scale = guidance_scale
        self.decode = decode
        self.output_uint8 = output_uint8
        self.sampler = sampler
        self.ddim = make_ddim_schedule(model.schedule, num_steps, eta=eta)
        # the table's length, not the requested count: a uniform grid whose
        # count does not divide the training steps runs one step more, and
        # callers size per-step inputs (`noise`) by what will run
        self.num_steps = self.ddim.num_steps

    def _cond(self, context, concat):
        cond = {"c_crossattn": context, "c_concat": concat}
        if self.model.config.conditioning_key in ("hybrid", "crossattn"):
            cond["cross_kv"] = precompute_cross_kv(self.model.unet, context)
        return cond

    @torch.inference_mode()
    def generate(
        self,
        batch: Dict[str, torch.Tensor],
        generator: Optional[torch.Generator] = None,
        *,
        shared_x_T: bool = False,
        x_T: Optional[torch.Tensor] = None,
        noise: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Images NHWC: float32 in [-1, 1], uint8 with `output_uint8`, or
        latents with `decode=False`.

        `batch` holds `text_emb`, optional `style_emb`, `smpl`,
        `person_mask` and `uncond` (a cond dict for guidance). `x_T` and the
        per-step `noise` override draws from `generator`.
        """
        model = self.model
        cfg = model.config
        dev = model.device
        get = lambda k: (None if batch.get(k) is None
                         else batch[k].to(dev, torch.float32))
        context = model.build_context(get("text_emb"), get("style_emb"),
                                      get("smpl"))
        cond = self._cond(context, get("person_mask"))
        uncond = batch.get("uncond")
        if uncond is not None:
            concat = uncond.get("c_concat")
            uncond = self._cond(
                uncond["c_crossattn"].to(dev, torch.float32),
                None if concat is None else concat.to(dev, torch.float32))

        b = context.shape[0]
        h, w = cfg.latent_size
        shape = (b, h, w, cfg.latent_channels)
        if x_T is None:
            if shared_x_T:
                x_T = torch.randn((1,) + shape[1:], generator=generator,
                                  device=dev).expand(shape)
            else:
                x_T = torch.randn(shape, generator=generator, device=dev)

        def eps_model(x, t, c):
            return model.to_eps(model.apply_model(x, t, c), x, t)

        z = ddim_sample(eps_model, self.ddim, shape, cond,
                        generator=generator, x_T=x_T.to(dev), noise=noise,
                        guidance_scale=self.guidance_scale, uncond=uncond)
        if not self.decode:
            return z
        img = torch.clamp(model.decode_first_stage(z), -1.0, 1.0)
        if self.output_uint8:
            return torch.round((img + 1.0) * 127.5).to(torch.uint8)
        return img


# ---------------- 256 -> 512 upscale chain ----------------


def prepare_lr_condition(image_256: torch.Tensor,
                         out_hw: Tuple[int, int] = (128, 96)) -> torch.Tensor:
    """256x192 sample -> low-res concat conditioning for the upscale stage
    (app.py:93-97): edge-pad 4 px left and right, bilinear resize to the
    stage's latent grid, values left in [-1, 1]. NHWC in and out, float32.

    The resize antialiases when it downscales, as `jax.image.resize(...,
    "bilinear")` does; `F.interpolate(antialias=True)` computes the same
    triangle filter scaled to the output spacing.
    """
    x = image_256.float().permute(0, 3, 1, 2)
    x = F.pad(x, (4, 4, 0, 0), mode="replicate")
    x = F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                      align_corners=False, antialias=True)
    return x.permute(0, 2, 3, 1)


class UpscalePipeline:
    """The 512 stage alone: lr-concat conditioned DDIM in kl-f4 latent
    space (app.py:379-409, models/upgpt/upscale/config.yaml)."""

    def __init__(self, model: LatentDiffusion, num_steps: int = 200,
                 eta: float = 1.0, output_uint8: bool = False):
        self.inner = GenerationPipeline(model, num_steps=num_steps, eta=eta,
                                        output_uint8=output_uint8)
        # lr concat grid = this stage's latent size (128x96 released)
        self.lr_hw = model.config.latent_size

    def upscale(self, image_256: torch.Tensor, text_emb: torch.Tensor,
                style_emb: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, *,
                x_T: Optional[torch.Tensor] = None,
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        batch = {"text_emb": text_emb, "style_emb": style_emb,
                 # the c_concat slot carries the lr image (3 channels)
                 "person_mask": prepare_lr_condition(image_256, self.lr_hw)}
        return self.inner.generate(batch, generator, x_T=x_T, noise=noise)


class ChainedUpscalePipeline:
    """End-to-end 256->512 generation: the 256 stage to a float image on
    the card, its lr condition, then the upscale stage.

    `batch` is the 256 stage's conditioning (text_emb, style_emb, smpl,
    person_mask); the upscale stage reuses text_emb and style_emb (an
    86-token context) and takes its c_concat from the generated image.
    Both stages draw from one `generator`, the 256 stage first; `x_T`,
    `noise`, `up_x_T` and `up_noise` override the draws of each stage.
    """

    def __init__(self, base_model: LatentDiffusion,
                 upscale_model: LatentDiffusion, num_steps: int = 50,
                 eta: float = 1.0, output_uint8: bool = False):
        # the intermediate stays a float image in [-1, 1]; only the final
        # stage honours output_uint8
        self.base = GenerationPipeline(base_model, num_steps=num_steps,
                                       eta=eta)
        self.up = GenerationPipeline(upscale_model, num_steps=num_steps,
                                     eta=eta, output_uint8=output_uint8)
        # lr concat grid = the upscale stage's latent size (128x96 released)
        self.lr_hw = upscale_model.config.latent_size

    def generate(self, batch: Dict[str, torch.Tensor],
                 generator: Optional[torch.Generator] = None, *,
                 x_T: Optional[torch.Tensor] = None,
                 noise: Optional[torch.Tensor] = None,
                 up_x_T: Optional[torch.Tensor] = None,
                 up_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        img256 = self.base.generate(batch, generator, x_T=x_T, noise=noise)
        up_batch = {"text_emb": batch["text_emb"],
                    "style_emb": batch.get("style_emb"),
                    "person_mask": prepare_lr_condition(img256, self.lr_hw)}
        return self.up.generate(up_batch, generator, x_T=up_x_T,
                                noise=up_noise)
