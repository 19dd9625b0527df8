"""LatentDiffusion: the model family behind the samplers.

Port of `upgpt_tpu.diffusion.latent_diffusion` for sampling. The JAX class
is stateless over explicit parameter pytrees; here it is an nn.Module that
owns `unet`, `pose` and `vae` submodules (the same three subtrees as the JAX
params dict). Conditioning contract (DiffusionWrapper 'hybrid', reference
ddpm.py:1550-1577):

    cond = {
        "c_crossattn": (B, T, 768) context — text (77) | style (9) | pose (1),
        "c_concat":    (B, h, w, Cc) latent-resolution channel concat,
        "cross_kv":    optional precompute_cross_kv output,
    }

`p_losses` and `training_loss` belong to the training slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from upgpt_torch.diffusion.schedule import DiffusionSchedule
from upgpt_torch.models.pose import LinearProject
from upgpt_torch.models.unet import UNetConfig, UNetModel
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

    @classmethod
    def interp_256(cls, **overrides) -> "LatentDiffusionConfig":
        return dataclasses.replace(cls(), **overrides)


class LatentDiffusion(nn.Module):
    def __init__(self, config: LatentDiffusionConfig):
        super().__init__()
        self.config = config
        self.unet = UNetModel(config.unet)
        self.vae = AutoencoderKL(config.vae)
        self.pose = (LinearProject(config.pose_input_dim, config.context_dim)
                     if config.pose_input_dim else None)
        self.schedule = DiffusionSchedule.create(
            timesteps=config.timesteps,
            beta_schedule=config.beta_schedule,
            linear_start=config.linear_start,
            linear_end=config.linear_end,
            parameterization=config.parameterization,
        )

    @property
    def device(self) -> torch.device:
        return self.unet.conv_in.weight.device

    # ---------------- first stage ----------------

    def decode_first_stage(self, z: torch.Tensor) -> torch.Tensor:
        """Scaled latent -> float32 NHWC image in about [-1, 1]."""
        z = z / self.config.scale_factor
        return self.vae.decode(z.to(self.vae.post_quant_conv.weight.dtype))

    # ---------------- conditioning ----------------

    def build_context(self, text_emb: torch.Tensor,
                      style_emb: Optional[torch.Tensor] = None,
                      smpl: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Token concat of text (77), styles (9) and pose (1)
        (reference ddpm.py:733-739)."""
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
