"""UniPC (order 2, bh2, data prediction): a predictor-corrector sampler with
one model evaluation per step.

Port of `upgpt_tpu.diffusion.unipc` (Zhao et al. 2023, arXiv:2302.04867,
the formulation of diffusers' UniPCMultistepScheduler). The corrector
reuses the model output at the freshly predicted point, which the next
predictor step needs anyway, so it costs no evaluation.

Every per-step coefficient is computed on the host in float64 over the
uniform, quad or karras t-grid and frozen to float32, the same numpy code
as the JAX package's tables. The sampler is a Python loop over those
stacked constants whose carry is four float32 latents: the current
uncorrected sample, the x0 predictions one and two steps back, and the
corrector base.

Math (x0 prediction; lam = log(alpha/sigma), h_i = lam_{i+1} - lam_i,
hh = -h, phi1 = expm1(hh), B_h = phi1 for bh2):

  base_i     = (sig_{i+1}/sig_i) x_i - alpha_{i+1} phi1 x0_i
  predictor  x~_{i+1} = base_i - alpha_{i+1} B_h rho_p D1_i,
             D1_i = (x0_{i-1} - x0_i)/r_i,  r_i = (lam_{i-1} - lam_i)/h_i
  corrector  (at step i+1, on its model eval)
             x_{i+1} = base_i - alpha_{i+1} B_h (c0 D1_i + c1 D1_t),
             D1_t = x0(x~_{i+1}) - x0_i,
             [c0, c1] solves [[1,1],[r_i,1]] c = [b1, b2]

With the D1 terms dropped (first and terminal steps) a step is the DDIM
eta-0 update. The 1/r_i factors are folded into the tables.
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
class UniPCSchedule:
    """Per-step tables, ordered by sampling step (reverse time). Step i
    applies the corrector of the i-1 -> i transition and the predictor of
    i -> i+1."""

    timesteps: np.ndarray  # (S,) int32 descending: model-eval t per step
    alphas: np.ndarray     # acp at eval t (x0 conversion)
    corr_hist: np.ndarray  # multiplies (x0_{i-2} - x0_{i-1})  [c0/r folded]
    corr_new: np.ndarray   # multiplies (x0(x~_i) - x0_{i-1})  [c1]
    coef_x: np.ndarray     # sig_next/sig_cur
    coef_0: np.ndarray     # -alpha_next * phi1   (multiplies x0_i)
    pred_hist: np.ndarray  # multiplies (x0_{i-1} - x0_i)  [rho_p/r folded]

    @property
    def num_steps(self) -> int:
        return int(self.timesteps.shape[0])


def make_unipc_schedule(
    schedule: DiffusionSchedule,
    num_steps: int,
    method: str = "uniform",
) -> UniPCSchedule:
    """Order-2 bh2 UniPC tables over the t-grid of `method`."""
    ts = grid_timesteps(schedule, num_steps, method)
    acp = schedule.alphas_cumprod.astype(np.float64)
    a_cur = acp[ts]
    a_next = np.asarray([acp[0]] + acp[ts[:-1]].tolist())
    rev = slice(None, None, -1)
    a_cur, a_next, ts = a_cur[rev], a_next[rev], ts[rev]
    S = len(ts)

    alpha_c, sigma_c = np.sqrt(a_cur), np.sqrt(1.0 - a_cur)
    alpha_n, sigma_n = np.sqrt(a_next), np.sqrt(1.0 - a_next)
    lam_c = np.log(alpha_c / np.maximum(sigma_c, 1e-20))
    lam_n = np.log(alpha_n / np.maximum(sigma_n, 1e-20))
    h = lam_n - lam_c                      # (S,) > 0
    hh = -h
    phi1 = np.expm1(hh)
    B_h = phi1                             # bh2
    b1 = (phi1 / hh - 1.0) / B_h
    b2 = 2.0 * (phi1 / hh - 1.0 - hh / 2.0) / (hh * B_h)

    coef_x = sigma_n / sigma_c
    coef_0 = -alpha_n * phi1

    # history spacing r_i = (lam_{i-1} - lam_i) / h_i; step 0 has none
    r = np.zeros(S)
    r[1:] = (lam_c[:-1] - lam_c[1:]) / h[1:]

    pred_hist = np.zeros(S)
    pred_hist[1:] = -alpha_n[1:] * B_h[1:] * b1[1:] / r[1:]

    # corrector of transition i (applied at step i+1): order 2 with
    # history (i >= 1), else the order-1 corrector (c0 = 0, c1 = b1)
    i2 = np.arange(S) >= 1
    denom = np.where(1.0 - r == 0.0, 1.0, 1.0 - r)
    c0 = np.where(i2, (b1 - b2) / denom, 0.0)
    c1 = np.where(i2, (b2 - r * b1) / denom, b1)
    corr_hist_t = np.zeros(S)
    corr_hist_t[1:] = -alpha_n[1:] * B_h[1:] * c0[1:] / r[1:]
    corr_new_t = -alpha_n * B_h * c1

    # terminal guard (sigma_next ~ 0): first order, no corrector into it
    term = sigma_n <= 1e-10
    coef_0 = np.where(term, alpha_n, coef_0)
    pred_hist = np.where(term, 0.0, pred_hist)
    corr_hist_t = np.where(term, 0.0, corr_hist_t)
    corr_new_t = np.where(term, 0.0, corr_new_t)

    # step i applies transition i-1's corrector; step 0 applies none
    corr_hist = np.zeros(S)
    corr_new = np.zeros(S)
    corr_hist[1:] = corr_hist_t[:-1]
    corr_new[1:] = corr_new_t[:-1]

    f32 = lambda x: np.ascontiguousarray(x).astype(np.float32)  # noqa: E731
    return UniPCSchedule(
        timesteps=np.ascontiguousarray(ts).astype(np.int32),
        alphas=f32(a_cur), corr_hist=f32(corr_hist), corr_new=f32(corr_new),
        coef_x=f32(coef_x), coef_0=f32(coef_0), pred_hist=f32(pred_hist),
    )


def unipc_sample(
    eps_model: EpsModel,
    solver: UniPCSchedule,
    shape: Tuple[int, ...],
    cond: Dict[str, Any],
    *,
    generator: Optional[torch.Generator] = None,
    device: Optional[torch.device] = None,
    x_T: Optional[torch.Tensor] = None,
    guidance_scale: float = 1.0,
    uncond: Optional[Dict[str, Any]] = None,
) -> torch.Tensor:
    """Run the UniPC-2 reverse process; returns z_0 (float32, NHWC).

    Deterministic given x_T (an ODE solver). The final point is the last
    predictor output: its corrector would need one more model eval.
    """
    x = initial_latent(shape, generator, device, x_T)
    model_eps = cfg_eps_model(eps_model, cond, uncond, guidance_scale)
    # x: current sample, uncorrected; x0_a / x0_b: x0 predictions one /
    # two steps back; base: corrector base of the transition that made x
    x0_a, x0_b, base = torch.zeros_like(x), torch.zeros_like(x), x
    f32 = np.float32
    for i in range(solver.num_steps):
        with span("sampler.step", step=i):
            a = f32(solver.alphas[i])
            t_b = torch.full((shape[0],), int(solver.timesteps[i]),
                             dtype=torch.int32, device=x.device)
            eps = model_eps(x, t_b).float()
            x0 = (x - float(np.sqrt(f32(1.0) - a)) * eps) / float(np.sqrt(a))
            # corrector for this point (a no-op at step 0: base is x,
            # ch = cn = 0)
            x_corr = (base + float(solver.corr_hist[i]) * (x0_b - x0_a)
                      + float(solver.corr_new[i]) * (x0 - x0_a))
            # predictor for the next point (first order at step 0)
            base = (float(solver.coef_x[i]) * x_corr
                    + float(solver.coef_0[i]) * x0)
            x = base + float(solver.pred_hist[i]) * (x0_a - x0)
            x0_a, x0_b = x0, x0_a
    return x
