"""DDIM sampler as a Python loop over the model.

Port of `upgpt_tpu.diffusion.ddim` (reference DDIMSampler, ddim.py:25-54,
113-163, 166-204):

    pred_x0 = (x - sqrt(1-a_t) * eps) / sqrt(a_t)
    dir_xt  = sqrt(1 - a_prev - sigma_t^2) * eps
    x_prev  = sqrt(a_prev) * pred_x0 + dir_xt + sigma_t * N(0,1)

The update runs in float32. Randomness comes from an explicit
`torch.Generator`; a test can instead inject `x_T` and the per-step noise
(`noise`, shape (steps, B, h, w, C)). Classifier-free guidance doubles the
batch (ddim.py:171-178).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from upgpt_torch.diffusion.schedule import DDIMSchedule

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
    guidance_scale: float = 1.0,
    uncond: Optional[Dict[str, Any]] = None,
) -> torch.Tensor:
    """Run the DDIM reverse process; returns z_0 (float32, NHWC `shape`).

    `x_T` defaults to a draw from `generator`. With eta > 0, step i adds
    `noise[i]` when given, else a fresh draw from `generator`.
    """
    if x_T is not None:
        device = x_T.device
    if x_T is None:
        x = torch.randn(shape, generator=generator, device=device)
    else:
        x = x_T.float()
    n = ddim.num_steps
    if noise is not None and tuple(noise.shape) != (n,) + tuple(shape):
        raise ValueError(f"noise must be {(n,) + tuple(shape)}, got "
                         f"{tuple(noise.shape)}")
    model_eps = cfg_eps_model(eps_model, cond, uncond, guidance_scale)
    stochastic = bool((ddim.sigmas != 0).any())
    f32 = np.float32
    for i in range(n):
        at, ap = f32(ddim.alphas[i]), f32(ddim.alphas_prev[i])
        soma, sig = f32(ddim.sqrt_one_minus_alphas[i]), f32(ddim.sigmas[i])
        t_b = torch.full((shape[0],), int(ddim.timesteps[i]),
                         dtype=torch.int32, device=x.device)
        eps = model_eps(x, t_b).float()
        pred_x0 = (x - float(soma) * eps) / float(np.sqrt(at))
        dir_xt = float(np.sqrt(np.maximum(f32(1.0) - ap - sig * sig,
                                          f32(0.0)))) * eps
        x = float(np.sqrt(ap)) * pred_x0 + dir_xt
        if stochastic:
            z = (noise[i].to(x.device, torch.float32) if noise is not None
                 else torch.randn(shape, generator=generator, device=x.device))
            x = x + float(sig) * z
    return x
