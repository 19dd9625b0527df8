"""PLMS (pseudo linear multistep) sampler as a Python loop.

Port of `upgpt_tpu.diffusion.plms` (reference PLMSSampler,
ldm/models/diffusion/plms.py:118-236): Adams-Bashforth orders 2-4 over the
eps history, with a pseudo improved-Euler bootstrap on the first step (an
extra model eval at t_next). eta must be 0, as the reference asserts
(plms.py:24-26); the port raises ValueError, where the JAX package has a
bare assert. t_next pairs each step with the next smaller timestep, 0 at
the end (plms.py:141-147).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from upgpt_torch.diffusion.ddim import EpsModel, cfg_eps_model, initial_latent
from upgpt_torch.diffusion.schedule import DDIMSchedule


def plms_sample(
    eps_model: EpsModel,
    ddim: DDIMSchedule,
    shape: Tuple[int, ...],
    cond: Dict[str, Any],
    *,
    generator: Optional[torch.Generator] = None,
    device: Optional[torch.device] = None,
    x_T: Optional[torch.Tensor] = None,
    guidance_scale: float = 1.0,
    uncond: Optional[Dict[str, Any]] = None,
) -> torch.Tensor:
    """Run the PLMS reverse process over an eta-0 DDIM table; returns z_0."""
    if (ddim.sigmas != 0).any():
        raise ValueError("PLMS requires eta=0 (reference plms.py:24-26)")
    x = initial_latent(shape, generator, device, x_T)
    model_eps = cfg_eps_model(eps_model, cond, uncond, guidance_scale)
    ts = np.asarray(ddim.timesteps)
    ts_next = np.concatenate([ts[1:], [0]]).astype(np.int32)
    f32 = np.float32

    def t_of(t):
        return torch.full((shape[0],), int(t), dtype=torch.int32,
                          device=x.device)

    hist = []  # eps of earlier steps, newest first
    for i in range(ddim.num_steps):
        at, ap = f32(ddim.alphas[i]), f32(ddim.alphas_prev[i])
        soma = float(ddim.sqrt_one_minus_alphas[i])
        sqrt_at, sqrt_ap = float(np.sqrt(at)), float(np.sqrt(ap))
        dir_scale = float(np.sqrt(np.maximum(f32(1.0) - ap, f32(0.0))))

        def x_prev_from(e, x=x):
            return sqrt_ap * ((x - soma * e) / sqrt_at) + dir_scale * e

        e_t = model_eps(x, t_of(ts[i])).float()
        if not hist:
            # pseudo improved Euler: an extra eval at t_next
            e_next = model_eps(x_prev_from(e_t), t_of(ts_next[i])).float()
            e_prime = (e_t + e_next) / 2.0
        elif len(hist) == 1:
            e_prime = (3.0 * e_t - hist[0]) / 2.0
        elif len(hist) == 2:
            e_prime = (23.0 * e_t - 16.0 * hist[0] + 5.0 * hist[1]) / 12.0
        else:
            e_prime = (55.0 * e_t - 59.0 * hist[0] + 37.0 * hist[1]
                       - 9.0 * hist[2]) / 24.0
        x = x_prev_from(e_prime)
        hist = [e_t] + hist[:2]
    return x
