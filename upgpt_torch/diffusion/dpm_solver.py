"""DPM-Solver++(2M): a second-order multistep ODE sampler.

Port of `upgpt_tpu.diffusion.dpm_solver` (Lu et al. 2022, arXiv:2211.01095;
the formulation of diffusers' DPMSolverMultistepScheduler and k-diffusion's
sample_dpmpp_2m) for the discrete VP schedule. The per-step coefficients
are computed on the host in float64 and frozen to float32; the sampler is
a Python loop with one model evaluation per step, whose multistep state is
the previous x0 prediction.

    alpha_t = sqrt(acp_t); sigma_t = sqrt(1-acp_t); lam = log(alpha/sigma)
    x0_i    = (x - sigma_i * eps(x, t_i)) / alpha_i
    h_i     = lam_{i+1} - lam_i
    c_i     = h_i / (2 h_{i-1})                       (c_0 = 0: 1st order)
    D_i     = (1 + c_i) x0_i - c_i x0_{i-1}
    x_{i+1} = (sigma_{i+1}/sigma_i) x - alpha_{i+1} expm1(-h_i) D_i

With c = 0 a step is the DDIM eta-0 update.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from upgpt_torch.diffusion.ddim import EpsModel, cfg_eps_model, initial_latent
from upgpt_torch.diffusion.schedule import DiffusionSchedule, grid_timesteps
from upgpt_torch.utils.diagnostics import span


@dataclasses.dataclass(frozen=True)
class DPMSolverSchedule:
    """Per-step solver tables, ordered by sampling step (reverse time)."""

    timesteps: np.ndarray  # (S,) int32, descending: model-eval t per step
    alphas: np.ndarray  # acp at the eval t (for the x0 prediction)
    coef_x: np.ndarray  # sigma_next / sigma_cur
    coef_d: np.ndarray  # -alpha_next * expm1(-h)
    c2: np.ndarray  # h_i / (2 h_{i-1}); 0 => first-order step

    @property
    def num_steps(self) -> int:
        return int(self.timesteps.shape[0])


def make_dpm_solver_schedule(
    schedule: DiffusionSchedule,
    num_steps: int,
    method: str = "uniform",
) -> DPMSolverSchedule:
    """Solver tables over the t-grid of `method` (uniform, quad, karras)."""
    ts = grid_timesteps(schedule, num_steps, method)
    acp = schedule.alphas_cumprod.astype(np.float64)
    a_cur = acp[ts]
    a_next = np.asarray([acp[0]] + acp[ts[:-1]].tolist())
    rev = slice(None, None, -1)
    a_cur, a_next, ts = a_cur[rev], a_next[rev], ts[rev]

    alpha_c, sigma_c = np.sqrt(a_cur), np.sqrt(1.0 - a_cur)
    alpha_n, sigma_n = np.sqrt(a_next), np.sqrt(1.0 - a_next)
    # lam diverges at sigma -> 0; guard, then zero the affected coefficients
    lam_c = np.log(alpha_c / np.maximum(sigma_c, 1e-20))
    lam_n = np.log(alpha_n / np.maximum(sigma_n, 1e-20))
    h = lam_n - lam_c

    coef_x = sigma_n / sigma_c
    coef_d = -alpha_n * np.expm1(-h)
    c2 = np.zeros_like(h)
    c2[1:] = h[1:] / (2.0 * h[:-1])
    # first order where the target is (numerically) noise-free
    c2 = np.where(sigma_n <= 1e-10, 0.0, c2)
    coef_d = np.where(sigma_n <= 1e-10, alpha_n, coef_d)

    f32 = lambda x: np.ascontiguousarray(x).astype(np.float32)  # noqa: E731
    return DPMSolverSchedule(
        timesteps=np.ascontiguousarray(ts).astype(np.int32),
        alphas=f32(a_cur), coef_x=f32(coef_x), coef_d=f32(coef_d), c2=f32(c2),
    )


def dpm_solver_pp_sample(
    eps_model: EpsModel,
    solver: DPMSolverSchedule,
    shape: Tuple[int, ...],
    cond: Dict[str, Any],
    *,
    generator: Optional[torch.Generator] = None,
    device: Optional[torch.device] = None,
    x_T: Optional[torch.Tensor] = None,
    guidance_scale: float = 1.0,
    uncond: Optional[Dict[str, Any]] = None,
) -> torch.Tensor:
    """Run DPM-Solver++(2M); returns z_0 (float32, NHWC). Deterministic
    given x_T (an ODE solver: there is no eta)."""
    x = initial_latent(shape, generator, device, x_T)
    model_eps = cfg_eps_model(eps_model, cond, uncond, guidance_scale)
    x0_prev = torch.zeros_like(x)
    f32 = np.float32
    for i in range(solver.num_steps):
        with span("sampler.step", step=i):
            a, c2 = f32(solver.alphas[i]), f32(solver.c2[i])
            t_b = torch.full((shape[0],), int(solver.timesteps[i]),
                             dtype=torch.int32, device=x.device)
            eps = model_eps(x, t_b).float()
            x0 = (x - float(np.sqrt(f32(1.0) - a)) * eps) / float(np.sqrt(a))
            d = float(f32(1.0) + c2) * x0 - float(c2) * x0_prev
            x = float(solver.coef_x[i]) * x + float(solver.coef_d[i]) * d
            x0_prev = x0
    return x
