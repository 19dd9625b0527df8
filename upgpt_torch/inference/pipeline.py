"""Generation: conditioning embeddings -> DDIM -> decoded images.

Port of `upgpt_tpu.inference.pipeline.GenerationPipeline` (reference
ldm/data/generate_utils.py:131-190). Conditioning enters as embeddings —
text (77, 768), style slots (9, 768), SMPL (1, 85) — with the person mask
(h, w, 1) as the latent channel concat. The cross-attention K/V of the fixed
context are projected once before the step loop (`precompute_cross_kv`).

Only the DDIM sampler on the uniform grid is ported; "dpm++" and "unipc"
raise NotImplementedError. `shared_x_T` broadcasts one initial draw over the
batch, as the reference's seeded interpolation does (ddpm.py:1433-1437).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

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
        self.num_steps = num_steps

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
