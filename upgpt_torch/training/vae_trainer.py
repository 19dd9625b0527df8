"""First-stage VAE training: the two-optimizer GAN step.

Port of `upgpt_tpu.training.vae_trainer` (reference
ldm/models/autoencoder.py:285-423 training_step with contperceptual's
loss): the VAE's optimizer takes rec + KL + the adaptive GAN term, then
the PatchGAN discriminator's takes the hinge loss; both Adam with betas
(0.5, 0.9) and eps 1e-8, as `optax.adam`.

The adaptive weight needs d(nll)/dW and d(g_loss)/dW at the decoder's last
kernel W (`decoder.conv_out.weight`; contperceptual.py:33-43). JAX runs
the VAE forward three times with one key for them; here one forward keeps
its graph through two `torch.autograd.grad` calls at W, then the loss's
backward reaches the VAE's parameters alone. The generator's and the
discriminator's forwards each draw a posterior sample (JAX's `k_g` and
`k_d`), given as noise or drawn from one generator in that order; the
discriminator's reads the VAE after its update. Every VAE call is
deterministic (no dropout), as JAX's are.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from upgpt_torch.models.vae import AutoencoderKL
from upgpt_torch.training.vae_loss import LPIPSWithDiscriminator

# the scalar SGD rate of a learned logvar (JAX's generator_step)
LOGVAR_LR = 1e-4


def make_vae_optimizers(learning_rate: float, vae: AutoencoderKL,
                        loss_mod: LPIPSWithDiscriminator
                        ) -> Tuple[torch.optim.Adam, torch.optim.Adam]:
    """Adam with betas (0.5, 0.9) over the VAE and over the
    discriminator."""
    kw = dict(lr=learning_rate, betas=(0.5, 0.9), eps=1e-8)
    return (torch.optim.Adam(vae.parameters(), **kw),
            torch.optim.Adam(loss_mod.disc.parameters(), **kw))


def _noise(vae: AutoencoderKL, x: torch.Tensor, generator):
    """A posterior draw for `x`, from `generator` (the card's draws are
    the generator's, not JAX's)."""
    f = 2 ** (len(vae.config.ch_mult) - 1)
    shape = (x.shape[0], x.shape[1] // f, x.shape[2] // f,
             vae.post_quant_conv.in_channels)
    return torch.randn(shape, generator=generator, device=x.device)


def generator_step(vae: AutoencoderKL, loss_mod: LPIPSWithDiscriminator,
                   opt: torch.optim.Optimizer, batch_images: torch.Tensor,
                   global_step: int, noise: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None) -> Dict:
    """One VAE update; the log of `generator_loss` with the adaptive
    weight. A learned logvar moves by scalar SGD."""
    cfg = loss_mod.config
    logvar = loss_mod.logvar.clone().requires_grad_(cfg.learn_logvar)
    recons, posterior = vae(batch_images, noise, generator)
    loss, log = loss_mod.generator_loss(
        batch_images, recons, posterior, global_step,
        last_layer=vae.decoder.conv_out.weight, logvar=logvar)
    params = [p for p in vae.parameters() if p.requires_grad]
    inputs = params + ([logvar] if cfg.learn_logvar else [])
    opt.zero_grad(set_to_none=True)
    loss.backward(inputs=inputs)
    opt.step()
    if cfg.learn_logvar:
        with torch.no_grad():
            loss_mod.logvar.sub_(LOGVAR_LR * logvar.grad)
    return log


def discriminator_step(vae: AutoencoderKL,
                       loss_mod: LPIPSWithDiscriminator,
                       opt: torch.optim.Optimizer,
                       batch_images: torch.Tensor, global_step: int,
                       noise: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None) -> Dict:
    """One discriminator update on the VAE's reconstruction; its running
    statistics move in the forwards."""
    with torch.no_grad():
        recons, _ = vae(batch_images, noise, generator)
    loss, log = loss_mod.discriminator_loss(batch_images, recons,
                                            global_step)
    opt.zero_grad(set_to_none=True)
    loss.backward(inputs=list(loss_mod.disc.parameters()))
    opt.step()
    return log


def vae_train_step(vae: AutoencoderKL, loss_mod: LPIPSWithDiscriminator,
                   opts: Sequence[torch.optim.Optimizer],
                   batch_images: torch.Tensor, global_step: int,
                   noises: Optional[Sequence[torch.Tensor]] = None,
                   generator: Optional[torch.Generator] = None
                   ) -> Dict:
    """The generator's update, then the discriminator's (Lightning's
    two-optimizer step). `noises` = (the generator's draw, the
    discriminator's), else both drawn from `generator` in that order.
    Returns the logs as `gen/<key>` and `disc/<key>`."""
    if noises is None:
        noises = (_noise(vae, batch_images, generator),
                  _noise(vae, batch_images, generator))
    g_opt, d_opt = opts
    g_log = generator_step(vae, loss_mod, g_opt, batch_images, global_step,
                           noises[0])
    d_log = discriminator_step(vae, loss_mod, d_opt, batch_images,
                               global_step, noises[1])
    return {**{f"gen/{k}": v for k, v in g_log.items()},
            **{f"disc/{k}": v for k, v in d_log.items()}}
