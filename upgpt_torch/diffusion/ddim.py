"""DDIM sampler as a Python loop over the model.

Port of `upgpt_tpu.diffusion.ddim` (reference DDIMSampler, ddim.py:25-54,
113-163, 166-204):

    pred_x0 = (x - sqrt(1-a_t) * eps) / sqrt(a_t)
    dir_xt  = sqrt(1 - a_prev - sigma_t^2) * eps
    x_prev  = sqrt(a_prev) * pred_x0 + dir_xt
              + sigma_t * N(0,1) * temperature

The update runs in float32. Randomness comes from an explicit
`torch.Generator`; a test can instead inject `x_T` and the per-step noise
(`noise`, shape (steps, B, h, w, C)). Classifier-free guidance doubles the
batch (ddim.py:171-178). Mask-inpaint blending (ddim.py:144-147) takes
`inpaint_mask`/`x0` and draws (or is given, `inpaint_noise`) one q-sample
noise per step before that step's eta noise, as the JAX package splits
its key. `ddim_img2img` and `ddim_stochastic_encode` are the img2img pair
(ddim.py:206-241).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from upgpt_torch.diffusion.schedule import DDIMSchedule, DiffusionSchedule

# eps-model signature: (x, t, cond) -> eps
EpsModel = Callable[[torch.Tensor, torch.Tensor, Dict[str, Any]], torch.Tensor]


def _concat_cond(u, c):
    if isinstance(u, torch.Tensor):
        return torch.cat([u, c], dim=0)
    if isinstance(u, dict):
        return {k: _concat_cond(u[k], c[k]) for k in u}
    if isinstance(u, (tuple, list)):
        return type(u)(_concat_cond(a, b) for a, b in zip(u, c))
    if u is None:
        return None
    raise TypeError(f"cannot batch-concat conditioning of type {type(u)}")


def cfg_eps_model(eps_model: EpsModel, cond: Dict[str, Any],
                  uncond: Optional[Dict[str, Any]],
                  guidance_scale: float) -> Callable:
    """Classifier-free guidance by batch doubling; a plain conditioned call
    without `uncond` or at scale 1.0."""
    use_cfg = uncond is not None and guidance_scale != 1.0

    def model_eps(x, t_b):
        if use_cfg:
            out = eps_model(torch.cat([x, x]), torch.cat([t_b, t_b]),
                            _concat_cond(uncond, cond))
            e_uncond, e_cond = out.chunk(2, dim=0)
            return e_uncond + guidance_scale * (e_cond - e_uncond)
        return eps_model(x, t_b, cond)

    return model_eps




def initial_latent(shape, generator, device, x_T) -> torch.Tensor:
    """x_T in float32, or a draw from `generator`."""
    if x_T is not None:
        return x_T.float()
    return torch.randn(shape, generator=generator, device=device)


def _draw(given: Optional[torch.Tensor], i: int, shape, generator,
          device) -> torch.Tensor:
    if given is not None:
        return given[i].to(device, torch.float32)
    return torch.randn(shape, generator=generator, device=device)


def _check_per_step(name: str, value, n: int, shape) -> None:
    if value is not None and tuple(value.shape) != (n,) + tuple(shape):
        raise ValueError(f"{name} must be {(n,) + tuple(shape)}, got "
                         f"{tuple(value.shape)}")


def ddim_sample(
    eps_model: EpsModel,
    ddim: DDIMSchedule,
    shape: Tuple[int, ...],
    cond: Dict[str, Any],
    *,
    generator: Optional[torch.Generator] = None,
    device: Optional[torch.device] = None,
    x_T: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
    temperature: float = 1.0,
    guidance_scale: float = 1.0,
    uncond: Optional[Dict[str, Any]] = None,
    schedule: Optional[DiffusionSchedule] = None,
    inpaint_mask: Optional[torch.Tensor] = None,
    x0: Optional[torch.Tensor] = None,
    inpaint_noise: Optional[torch.Tensor] = None,
    return_pred_x0: bool = False,
):
    """Run the DDIM reverse process; returns z_0 (float32, NHWC `shape`).

    `x_T` defaults to a draw from `generator`. With eta > 0, step i adds
    `noise[i]` when given, else a fresh draw from `generator`, scaled by
    `temperature`. With `inpaint_mask` (1 where `x0` is known) each step
    first blends `x0`, noised to the step's t with the diffusion
    `schedule`'s tables, into x. `return_pred_x0=True` also returns the
    per-step x0 predictions stacked as (steps, *shape), the reference's
    progressive-denoising rows.
    """
    x = initial_latent(shape, generator, device, x_T)
    n = ddim.num_steps
    _check_per_step("noise", noise, n, shape)
    _check_per_step("inpaint_noise", inpaint_noise, n, shape)
    if inpaint_mask is not None and (x0 is None or schedule is None):
        raise ValueError("inpainting needs x0 and the diffusion schedule")
    model_eps = cfg_eps_model(eps_model, cond, uncond, guidance_scale)
    stochastic = bool((ddim.sigmas != 0).any())
    f32 = np.float32
    preds = []
    for i in range(n):
        at, ap = f32(ddim.alphas[i]), f32(ddim.alphas_prev[i])
        soma, sig = f32(ddim.sqrt_one_minus_alphas[i]), f32(ddim.sigmas[i])
        t = int(ddim.timesteps[i])
        t_b = torch.full((shape[0],), t, dtype=torch.int32, device=x.device)
        if inpaint_mask is not None:
            # the known region, re-noised to this step's level
            q = _draw(inpaint_noise, i, shape, generator, x.device)
            x_orig = (float(schedule.sqrt_alphas_cumprod[t]) * x0.float()
                      + float(schedule.sqrt_one_minus_alphas_cumprod[t]) * q)
            x = x_orig * inpaint_mask + (1.0 - inpaint_mask) * x
        eps = model_eps(x, t_b).float()
        pred_x0 = (x - float(soma) * eps) / float(np.sqrt(at))
        dir_xt = float(np.sqrt(np.maximum(f32(1.0) - ap - sig * sig,
                                          f32(0.0)))) * eps
        x = float(np.sqrt(ap)) * pred_x0 + dir_xt
        if stochastic:
            z = _draw(noise, i, shape, generator, x.device)
            x = x + float(sig) * z * float(temperature)
        if return_pred_x0:
            preds.append(pred_x0)
    if return_pred_x0:
        return x, torch.stack(preds)
    return x


def ddim_stochastic_encode(
    ddim: DDIMSchedule,
    x0: torch.Tensor,
    t_index: torch.Tensor,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """img2img forward encode at DDIM step `t_index` (reference
    ddim.py:206-220): sqrt(a) x0 + sqrt(1 - a) noise, per sample.

    `t_index` (B,) indexes the DDIM sub-schedule in forward order (0 =
    cleanest), as the reference's `ddim_alphas[t]` does. `noise` defaults
    to a draw from `generator`.
    """
    idx = t_index.long().cpu().numpy()
    a_fwd = ddim.alphas[::-1]
    sqrt_a = np.sqrt(a_fwd)[idx]
    sqrt_oma = ddim.sqrt_one_minus_alphas[::-1][idx]
    if noise is None:
        noise = torch.randn(x0.shape, generator=generator, device=x0.device)
    view = (-1,) + (1,) * (x0.dim() - 1)

    def col(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(x0.device).view(
            view)

    return col(sqrt_a) * x0 + col(sqrt_oma) * noise


def ddim_img2img(
    eps_model: EpsModel,
    ddim: DDIMSchedule,
    x0: torch.Tensor,
    cond: Dict[str, Any],
    *,
    strength: float = 0.75,
    generator: Optional[torch.Generator] = None,
    encode_noise: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
    guidance_scale: float = 1.0,
    uncond: Optional[Dict[str, Any]] = None,
) -> torch.Tensor:
    """img2img: encode x0 to step t_enc = strength * steps, then run the
    last t_enc steps of the table back (the reference pairs
    stochastic_encode with DDIMSampler.decode, ddim.py:206-241).

    `encode_noise` replaces the encode's draw and `noise` (t_enc, *shape)
    the eta noise of the steps that run.
    """
    n = ddim.num_steps
    t_enc = max(1, min(int(strength * n), n))
    x_t = ddim_stochastic_encode(
        ddim, x0, torch.full((x0.shape[0],), t_enc - 1, dtype=torch.int32),
        noise=encode_noise, generator=generator)
    start = n - t_enc  # reverse-ordered tables: run the suffix
    sub = DDIMSchedule(
        timesteps=ddim.timesteps[start:], alphas=ddim.alphas[start:],
        alphas_prev=ddim.alphas_prev[start:],
        sqrt_one_minus_alphas=ddim.sqrt_one_minus_alphas[start:],
        sigmas=ddim.sigmas[start:])
    return ddim_sample(eps_model, sub, tuple(x0.shape), cond,
                       generator=generator, x_T=x_t, noise=noise,
                       guidance_scale=guidance_scale, uncond=uncond)
