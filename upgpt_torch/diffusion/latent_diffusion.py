"""LatentDiffusion: the model family behind the samplers.

Port of `upgpt_tpu.diffusion.latent_diffusion` for sampling. The JAX class
is stateless over explicit parameter pytrees; here it is an nn.Module that
owns `unet`, `pose` and `vae` submodules (the same three subtrees as the JAX
params dict). Conditioning contract (DiffusionWrapper 'hybrid', reference
ddpm.py:1550-1577):

    cond = {
        "c_crossattn": (B, T, 768) context — text (77) | style (9) | pose (1),
                       or with `cond_fusion` the fused text (77) | pose (1),
        "c_concat":    (B, h, w, Cc) latent-resolution channel concat,
        "cross_kv":    optional `cross_kv(context)` output,
    }

Training (reference ddpm.py:1083-1123): `training_loss` encodes the image
through the frozen VAE without gradient (the JAX `stop_gradient`), samples
the posterior, noises the latent (`q_sample`) and takes the weighted
eps/v/x0 loss (`p_losses`). Its three random tensors are drawn by
`training_draws` in a fixed order, or passed in explicitly.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from upgpt_torch.diffusion.schedule import DiffusionSchedule
from upgpt_torch.models.cond_fusion import TextStyleCrossAttention
from upgpt_torch.models.pose import LinearProject
from upgpt_torch.models.unet import (
    UNetConfig, UNetModel, precompute_cross_kv,
)
from upgpt_torch.models.vae import AutoencoderConfig, AutoencoderKL


@dataclasses.dataclass(frozen=True)
class LatentDiffusionConfig:
    unet: UNetConfig = dataclasses.field(default_factory=UNetConfig)
    vae: AutoencoderConfig = dataclasses.field(default_factory=AutoencoderConfig)
    timesteps: int = 1000
    beta_schedule: str = "linear"
    linear_start: float = 0.00085
    linear_end: float = 0.0120
    scale_factor: float = 0.18215
    parameterization: str = "eps"
    conditioning_key: Optional[str] = "hybrid"  # None|concat|crossattn|hybrid
    latent_size: Tuple[int, int] = (32, 24)
    latent_channels: int = 4
    pose_input_dim: Optional[int] = 85  # None: no pose stage
    context_dim: int = 768
    # the cond_stage_key_2 route (inshop_laion_clip.yaml:12, 82): a
    # TRAINABLE text-style CrossAttention fuses the style embeddings into
    # the text tokens instead of concatenating them. None disables it;
    # "image" / "text" is the reference's style_encode mode (modules.py:
    # 306-316), which selects the embeddings the encoder feeds in: the
    # fusion's math is the same
    cond_fusion: Optional[str] = None
    l_simple_weight: float = 1.0
    original_elbo_weight: float = 0.0

    @classmethod
    def interp_256(cls, **overrides) -> "LatentDiffusionConfig":
        return dataclasses.replace(cls(), **overrides)

    @classmethod
    def upscale_512(cls, **overrides) -> "LatentDiffusionConfig":
        """The upscale stage: kl-f4 latents (128x96x3) with the 3-channel
        low-res image as `c_concat` and an 86-token context (no pose stage).
        It trains without EMA (upscale/config.yaml `use_ema: false`), which
        here is `create_train_state(..., use_ema=False)`."""
        base = cls(
            unet=UNetConfig.upscale_512(),
            vae=AutoencoderConfig.kl_f4(),
            # upscale/config.yaml:5-6 trains on the SD-default schedule
            linear_start=1e-4,
            linear_end=2e-2,
            latent_size=(128, 96),
            latent_channels=3,
            pose_input_dim=None,
        )
        return dataclasses.replace(base, **overrides)


def make_schedule(config: LatentDiffusionConfig) -> DiffusionSchedule:
    """The noise schedule of a model config."""
    return DiffusionSchedule.create(
        timesteps=config.timesteps,
        beta_schedule=config.beta_schedule,
        linear_start=config.linear_start,
        linear_end=config.linear_end,
        parameterization=config.parameterization,
    )


class LatentDiffusion(nn.Module):
    def __init__(self, config: LatentDiffusionConfig):
        super().__init__()
        self.config = config
        self.unet = UNetModel(config.unet)
        self.vae = AutoencoderKL(config.vae)
        self.pose = (LinearProject(config.pose_input_dim, config.context_dim)
                     if config.pose_input_dim else None)
        # the trainable fusion (modules.py:274-278): CrossAttention(768,
        # 8 heads of 96), in the trainable set (reference ddpm.py:1501-1509)
        self.cond_fusion = (TextStyleCrossAttention(dim=config.context_dim)
                            if config.cond_fusion else None)
        self.schedule = make_schedule(config)

    @property
    def device(self) -> torch.device:
        return self.unet.conv_in.weight.device

    # ---------------- first stage ----------------

    def encode_first_stage(self, x: torch.Tensor,
                           noise: Optional[torch.Tensor] = None,
                           generator: Optional[torch.Generator] = None
                           ) -> torch.Tensor:
        """Image in [-1, 1], NHWC -> scaled posterior sample, float32, with
        no gradient into the VAE (ddpm.py:569-576, 891-929). `noise` is the
        posterior's standard normal draw, else drawn from `generator`."""
        with torch.no_grad():
            z = self.vae.encode(x.to(self.device)).sample(noise, generator)
        return self.config.scale_factor * z

    def encode_first_stage_mode(self, x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            z = self.vae.encode(x.to(self.device)).mode()
        return self.config.scale_factor * z

    def decode_first_stage(self, z: torch.Tensor) -> torch.Tensor:
        """Scaled latent -> float32 NHWC image in about [-1, 1]."""
        return self.vae.decode(z / self.config.scale_factor)

    # ---------------- conditioning ----------------

    def build_context(self, text_emb: torch.Tensor,
                      style_emb: Optional[torch.Tensor] = None,
                      smpl: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Token concat of text (77), styles (9) and pose (1)
        (reference ddpm.py:733-739). With `cond_fusion` (the
        cond_stage_key_2 route, ddpm.py:707-713) the styles are fused into
        the text tokens by the trainable CrossAttention, and the context
        is the fused text (77) and pose (1)."""
        if self.cond_fusion is not None:
            if style_emb is None:
                raise ValueError("cond_fusion: the fused context needs "
                                 "style_emb")
            parts = [self.cond_fusion(text_emb.float(), style_emb.float())]
        else:
            parts = [text_emb]
            if style_emb is not None:
                parts.append(style_emb)
        if smpl is not None:
            if self.pose is None:
                raise ValueError("this model variant has no pose stage")
            parts.append(self.pose(smpl))
        return torch.cat([p.float() for p in parts], dim=1)

    # ---------------- diffusion math ----------------

    def apply_model(self, x_noisy: torch.Tensor, t: torch.Tensor,
                    cond: Dict[str, Any]) -> torch.Tensor:
        """DiffusionWrapper conditioning router (ddpm.py:1550-1577)."""
        key = self.config.conditioning_key
        context = cond.get("c_crossattn")
        concat = cond.get("c_concat")
        if key in ("hybrid", "concat"):
            x_in = torch.cat([x_noisy, concat.to(x_noisy.dtype)], dim=-1)
            if key == "concat":
                context = None
        elif key == "crossattn":
            x_in = x_noisy
        elif key is None:
            x_in, context = x_noisy, None
        else:
            raise NotImplementedError(key)
        return self.unet(x_in, t, context, cross_kv=cond.get("cross_kv"))

    def cross_kv(self, context: torch.Tensor) -> Dict:
        """The cross-attention K/V of a fixed context, projected once for
        a sampling loop (`cond["cross_kv"]`)."""
        return precompute_cross_kv(self.unet, context)

    def _table(self, name: str, t: torch.Tensor, ndim: int) -> torch.Tensor:
        table = torch.from_numpy(np.asarray(getattr(self.schedule, name)))
        return table.to(t.device)[t.long()].reshape((-1,) + (1,) * (ndim - 1))

    def to_eps(self, model_out: torch.Tensor, x_t: torch.Tensor,
               t: torch.Tensor) -> torch.Tensor:
        """Network output -> eps prediction (identity for eps models;
        v and x0 by the exact conversions of arXiv:2202.00512 app. D)."""
        p = self.config.parameterization
        if p == "eps":
            return model_out
        a = self._table("sqrt_alphas_cumprod", t, x_t.dim())
        sg = self._table("sqrt_one_minus_alphas_cumprod", t, x_t.dim())
        x32, out32 = x_t.float(), model_out.float()
        if p == "v":
            return sg * x32 + a * out32
        if p == "x0":
            return (x32 - a * out32) / torch.clamp(sg, min=1e-8)
        raise NotImplementedError(p)

    # ---------------- training loss ----------------

    def q_sample(self, z0: torch.Tensor, t: torch.Tensor,
                 noise: torch.Tensor) -> torch.Tensor:
        """Forward noising (reference ddpm.py:281-284)."""
        a = self._table("sqrt_alphas_cumprod", t, z0.dim())
        b = self._table("sqrt_one_minus_alphas_cumprod", t, z0.dim())
        return a * z0 + b * noise

    def p_losses(self, z0: torch.Tensor, cond: Dict[str, Any],
                 t: torch.Tensor, noise: torch.Tensor,
                 loss_w: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Weighted eps/v/x0-prediction loss (ddpm.py:1083-1123, without the
        dead decode at 1088-1089)."""
        cfg = self.config
        model_out = self.apply_model(self.q_sample(z0, t, noise), t, cond)
        if cfg.parameterization == "eps":
            target = noise
        elif cfg.parameterization == "v":
            # v = alpha_t * eps - sigma_t * x0 (arXiv:2202.00512 eq. 10)
            a = self._table("sqrt_alphas_cumprod", t, z0.dim())
            sg = self._table("sqrt_one_minus_alphas_cumprod", t, z0.dim())
            target = a * noise - sg * z0
        else:
            target = z0
        err = (model_out.float() - target.float()).square()
        weighted = err if loss_w is None else err * loss_w.float()
        loss_simple = weighted.mean(dim=(1, 2, 3)).mean()
        loss_vlb = (self._table("lvlb_weights", t, 1)
                    * err.mean(dim=(1, 2, 3))).mean()
        loss = (cfg.l_simple_weight * loss_simple
                + cfg.original_elbo_weight * loss_vlb)
        return loss, {"loss_simple": loss_simple, "loss_vlb": loss_vlb,
                      "loss": loss}

    def training_draws(self, batch_size: int,
                       generator: Optional[torch.Generator] = None
                       ) -> Dict[str, torch.Tensor]:
        """The random tensors of one training loss, drawn from `generator`
        in this order: the posterior noise, t ~ U{0, ..., T-1}, then the
        diffusion noise (both noises standard normal, latent-shaped)."""
        cfg = self.config
        shape = (batch_size,) + tuple(cfg.latent_size) + (cfg.vae.embed_dim,)
        dev = self.device
        posterior_noise = torch.randn(shape, generator=generator, device=dev)
        t = torch.randint(0, self.schedule.num_timesteps, (batch_size,),
                          generator=generator, device=dev)
        noise = torch.randn(shape, generator=generator, device=dev)
        return {"posterior_noise": posterior_noise, "t": t, "noise": noise}

    def training_loss(self, batch: Dict[str, torch.Tensor],
                      generator: Optional[torch.Generator] = None,
                      draws: Optional[Dict[str, torch.Tensor]] = None
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One training loss from a raw batch: 'image' (B, H, W, 3) in
        [-1, 1], 'person_mask' (B, h, w, 1), 'text_emb' (B, 77, 768),
        'style_emb' (B, 9, 768), 'smpl' (B, 1, 85), optional 'loss_w'
        (B, h, w, 1). `draws` (from `training_draws`) overrides `generator`.
        """
        dev = self.device
        get = lambda k: (None if batch.get(k) is None
                         else batch[k].to(dev, torch.float32))
        image = get("image")
        if draws is None:
            draws = self.training_draws(image.shape[0], generator)
        z0 = self.encode_first_stage(image, noise=draws["posterior_noise"])
        cond = {"c_crossattn": self.build_context(
                    get("text_emb"), get("style_emb"), get("smpl")),
                "c_concat": get("person_mask")}
        return self.p_losses(z0, cond, draws["t"], draws["noise"],
                             get("loss_w"))
