"""The first stage's training loss: L1 + LPIPS + KL + an adaptive-weight
PatchGAN term.

Port of `upgpt_tpu.training.vae_loss` (reference LPIPSWithDiscriminator,
ldm/modules/losses/contperceptual.py:7-110, taming's NLayerDiscriminator):

- generator loss (the VAE's optimizer): weighted_nll + kl_weight * kl +
  d_weight * disc_factor * g_loss, where rec = |x - xrec| (+
  perceptual_weight * LPIPS where an `lpips_fn` is given), nll =
  rec / exp(logvar) + logvar, g_loss = -mean(D(xrec)) with D on its
  running statistics, and d_weight = ||d nll / d W|| / (||d g_loss / d W||
  + 1e-4) at the decoder's last kernel W, clamped to [0, 1e4], detached
  and times disc_weight. disc_factor is 0 before `disc_start` steps.
- discriminator loss: hinge (or vanilla) on real and fake logits, D on
  batch statistics; the real pass's running statistics feed the fake
  pass.

`FlaxBatchNorm` is flax's BatchNorm, which `nn.BatchNorm2d` is not:
momentum 0.99 keeps 0.99 of the running value (torch's 0.01), the
statistics are float32 with the variance as E[x^2] - E[x]^2 clipped at 0,
and the running variance takes that biased batch variance (torch's takes
the unbiased one).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from upgpt_torch.models.layers import Conv2d


class FlaxBatchNorm(nn.Module):
    """BatchNorm over the channels of NHWC tensors, flax's arithmetic."""

    def __init__(self, channels: int, momentum: float = 0.99,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:
            xf = x.float()
            dims = tuple(range(x.dim() - 1))
            mean = xf.mean(dims)
            var = torch.clamp(xf.square().mean(dims) - mean.square(), min=0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_((1 - m) * mean.detach())
                self.running_var.mul_(m).add_((1 - m) * var.detach())
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean) * mul + self.bias).to(x.dtype)


class NLayerDiscriminator(nn.Module):
    """PatchGAN discriminator (taming's NLayerDiscriminator), NHWC:
    4x4 convs (stride 2, the last two stride 1), LeakyReLU(0.2), flax
    BatchNorm after every inner conv."""

    def __init__(self, input_nc: int = 3, ndf: int = 64, n_layers: int = 3):
        super().__init__()
        self.n_layers = n_layers
        self.conv_in = Conv2d(input_nc, ndf, 4, stride=2, padding=1)
        nf = ndf
        for i in range(1, n_layers + 1):
            prev, nf = nf, min(ndf * 2 ** i, ndf * 8)
            stride = 2 if i < n_layers else 1
            self.add_module(f"conv_{i}", Conv2d(prev, nf, 4, stride=stride,
                                                padding=1, bias=False))
            self.add_module(f"bn_{i}", FlaxBatchNorm(nf))
        self.conv_out = Conv2d(nf, 1, 4, padding=1)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = F.leaky_relu(self.conv_in(x), 0.2)
        for i in range(1, self.n_layers + 1):
            x = getattr(self, f"conv_{i}")(x)
            x = F.leaky_relu(getattr(self, f"bn_{i}")(x, train), 0.2)
        return self.conv_out(x)


def hinge_d_loss(logits_real: torch.Tensor,
                 logits_fake: torch.Tensor) -> torch.Tensor:
    loss_real = torch.relu(1.0 - logits_real).mean()
    loss_fake = torch.relu(1.0 + logits_fake).mean()
    return 0.5 * (loss_real + loss_fake)


def vanilla_d_loss(logits_real: torch.Tensor,
                   logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (F.softplus(-logits_real).mean()
                  + F.softplus(logits_fake).mean())


def adopt_weight(weight: float, global_step: int, threshold: int = 0
                 ) -> float:
    return 0.0 if global_step < threshold else weight


@dataclasses.dataclass(frozen=True)
class VAELossConfig:
    disc_start: int = 50001
    kl_weight: float = 1e-6
    pixelloss_weight: float = 1.0
    perceptual_weight: float = 1.0
    disc_num_layers: int = 3
    disc_factor: float = 1.0
    disc_weight: float = 0.5
    disc_loss: str = "hinge"
    logvar_init: float = 0.0
    # the reference's default (contperceptual.py:15): logvar is fixed at
    # logvar_init and stays out of the VAE's optimizer
    learn_logvar: bool = False


def _norm_ratio(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(num) / (torch.linalg.vector_norm(den)
                                            + 1e-4)


class LPIPSWithDiscriminator(nn.Module):
    """The two-optimizer VAE loss: the discriminator (`disc`) and the
    scalar `logvar` (a float32 buffer). `lpips_fn(a, b) -> (B,)` is
    optional; without it the loss is L1 + KL + GAN, as if
    perceptual_weight were 0."""

    def __init__(self, config: VAELossConfig,
                 lpips_fn: Optional[Callable] = None):
        super().__init__()
        if config.disc_loss not in ("hinge", "vanilla"):
            raise ValueError(f"disc_loss {config.disc_loss!r}: expected "
                             f"hinge or vanilla")
        self.config = config
        self.disc = NLayerDiscriminator(n_layers=config.disc_num_layers)
        self.lpips_fn = lpips_fn
        self.d_loss = (hinge_d_loss if config.disc_loss == "hinge"
                       else vanilla_d_loss)
        self.register_buffer("logvar", torch.tensor(
            float(config.logvar_init), dtype=torch.float32))

    def generator_loss(
        self,
        inputs: torch.Tensor,
        recons: torch.Tensor,
        posterior,
        global_step: int,
        last_layer: Optional[torch.Tensor] = None,
        weights: Optional[torch.Tensor] = None,
        logvar: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Dict]:
        """(loss, log), the log detached. With `last_layer` (the decoder's
        last kernel, on the graph of `recons`) and a positive disc_factor,
        the adaptive weight comes from the two gradients there, the graph
        kept for the loss's own backward; without it d_weight is 0."""
        cfg = self.config
        logvar = self.logvar if logvar is None else logvar
        rec = (inputs - recons).abs() * cfg.pixelloss_weight
        if self.lpips_fn is not None and cfg.perceptual_weight > 0:
            p = self.lpips_fn(inputs, recons).reshape(-1, 1, 1, 1)
            rec = rec + cfg.perceptual_weight * p
        nll = rec / torch.exp(logvar) + logvar
        wnll = nll if weights is None else weights * nll
        weighted_nll = wnll.sum() / wnll.shape[0]
        nll_loss = nll.sum() / nll.shape[0]
        kl = posterior.kl().sum() / inputs.shape[0]
        logits_fake = self.disc(recons, train=False)
        g_loss = -logits_fake.mean()
        if last_layer is not None and cfg.disc_factor > 0:
            nll_g, = torch.autograd.grad(nll_loss, last_layer,
                                         retain_graph=True)
            gan_g, = torch.autograd.grad(g_loss, last_layer,
                                         retain_graph=True)
            d_weight = torch.clamp(_norm_ratio(nll_g, gan_g).detach(),
                                   0.0, 1e4) * cfg.disc_weight
        else:
            d_weight = torch.zeros((), device=inputs.device)
        disc_factor = adopt_weight(cfg.disc_factor, global_step,
                                   cfg.disc_start)
        loss = (weighted_nll + cfg.kl_weight * kl
                + d_weight * disc_factor * g_loss)
        log = {"total_loss": loss, "logvar": logvar, "kl_loss": kl,
               "nll_loss": nll_loss, "rec_loss": rec.mean(),
               "d_weight": d_weight, "g_loss": g_loss}
        log = {k: v.detach() for k, v in log.items()}
        log["disc_factor"] = disc_factor
        return loss, log

    def discriminator_loss(
        self,
        inputs: torch.Tensor,
        recons: torch.Tensor,
        global_step: int,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(loss, log): D on batch statistics, the real pass first; each
        pass moves the running statistics."""
        logits_real = self.disc(inputs.detach(), train=True)
        logits_fake = self.disc(recons.detach(), train=True)
        disc_factor = adopt_weight(self.config.disc_factor, global_step,
                                   self.config.disc_start)
        d_loss = disc_factor * self.d_loss(logits_real, logits_fake)
        log = {"disc_loss": d_loss, "logits_real": logits_real.mean(),
               "logits_fake": logits_fake.mean()}
        return d_loss, {k: v.detach() for k, v in log.items()}

    def checkpoint_state(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """{"disc", "disc_stats", "logvar"}: the discriminator's weights,
        its running statistics and logvar (JAX's loss_params)."""
        disc, stats = {}, {}
        for k, v in self.disc.state_dict().items():
            (stats if k.endswith(("running_mean", "running_var"))
             else disc)[k] = v
        return {"disc": disc, "disc_stats": stats, "logvar": self.logvar}

    def load_checkpoint_state(self, state: Dict) -> None:
        self.disc.load_state_dict({**state["disc"], **state["disc_stats"]},
                                  strict=True)
        self.logvar.copy_(state["logvar"])
