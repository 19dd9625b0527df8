"""Diffusion noise schedules and DDIM sub-schedules (numpy only).

Port of `upgpt_tpu.diffusion.schedule`, kept free of any framework import so
the tables are bit-equal to the JAX package's. All tables are derived in
float64 on the host and frozen to float32, exactly as the reference does
(make_beta_schedule, diffusionmodules/util.py:21-43 — fp64 linspace of
sqrt-betas squared; DDPM.register_schedule, ddpm.py:125-177; DDIM tables,
util.py:46-74 and ddim.py:25-54). The samplers read them per step on the host.

Quirks deliberately preserved (the released checkpoints were trained on them):
- DDIM uniform timestep subset is shifted by +1 (util.py:57).
- `lvlb_weights[0] = lvlb_weights[1]` patch (ddpm.py:176).
"""

from __future__ import annotations

import dataclasses

import numpy as np


def make_beta_schedule(
    schedule: str,
    n_timestep: int,
    linear_start: float = 1e-4,
    linear_end: float = 2e-2,
    cosine_s: float = 8e-3,
) -> np.ndarray:
    """Beta schedule in float64 (reference util.py:21-43)."""
    if schedule == "linear":
        betas = (
            np.linspace(linear_start**0.5, linear_end**0.5, n_timestep, dtype=np.float64)
            ** 2
        )
    elif schedule == "cosine":
        timesteps = np.arange(n_timestep + 1, dtype=np.float64) / n_timestep + cosine_s
        alphas = np.cos(timesteps / (1 + cosine_s) * np.pi / 2) ** 2
        alphas = alphas / alphas[0]
        betas = 1 - alphas[1:] / alphas[:-1]
        betas = np.clip(betas, 0, 0.999)
    elif schedule == "sqrt_linear":
        betas = np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64)
    elif schedule == "sqrt":
        betas = np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64) ** 0.5
    else:
        raise ValueError(f"schedule {schedule!r} unknown")
    return betas


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """Frozen per-model diffusion tables (all float32, shape (T,))."""

    betas: np.ndarray
    alphas_cumprod: np.ndarray
    alphas_cumprod_prev: np.ndarray
    sqrt_alphas_cumprod: np.ndarray
    sqrt_one_minus_alphas_cumprod: np.ndarray
    log_one_minus_alphas_cumprod: np.ndarray
    sqrt_recip_alphas_cumprod: np.ndarray
    sqrt_recipm1_alphas_cumprod: np.ndarray
    posterior_variance: np.ndarray
    posterior_log_variance_clipped: np.ndarray
    posterior_mean_coef1: np.ndarray
    posterior_mean_coef2: np.ndarray
    lvlb_weights: np.ndarray

    @property
    def num_timesteps(self) -> int:
        return int(self.betas.shape[0])

    @classmethod
    def create(
        cls,
        timesteps: int = 1000,
        beta_schedule: str = "linear",
        linear_start: float = 1e-4,
        linear_end: float = 2e-2,
        cosine_s: float = 8e-3,
        given_betas: np.ndarray | None = None,
        v_posterior: float = 0.0,
        parameterization: str = "eps",
    ) -> "DiffusionSchedule":
        """Replicates DDPM.register_schedule (reference ddpm.py:125-177)."""
        if given_betas is not None:
            betas = np.asarray(given_betas, dtype=np.float64)
        else:
            betas = make_beta_schedule(
                beta_schedule, timesteps, linear_start, linear_end, cosine_s
            )
        alphas = 1.0 - betas
        alphas_cumprod = np.cumprod(alphas, axis=0)
        alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])

        posterior_variance = (1 - v_posterior) * betas * (
            1.0 - alphas_cumprod_prev
        ) / (1.0 - alphas_cumprod) + v_posterior * betas

        if parameterization in ("eps", "v"):
            # posterior_variance[0] == 0 -> inf at index 0, patched below
            # exactly as the reference does (ddpm.py:169-177). The "v"
            # branch (velocity prediction, arXiv:2202.00512 §2.4 — used by
            # the progressive-distillation students, training/distill.py)
            # reuses the eps weights: every config here trains with
            # original_elbo_weight=0, so lvlb_weights only gates the unused
            # ELBO term and the eps weighting is a documented stand-in.
            with np.errstate(divide="ignore"):
                lvlb_weights = betas**2 / (
                    2 * posterior_variance * alphas * (1 - alphas_cumprod)
                )
        elif parameterization == "x0":
            lvlb_weights = 0.5 * np.sqrt(alphas_cumprod) / (2.0 * 1 - alphas_cumprod)
        else:
            raise NotImplementedError(parameterization)
        lvlb_weights = lvlb_weights.copy()
        lvlb_weights[0] = lvlb_weights[1]
        if np.isnan(lvlb_weights).any():
            raise ValueError("lvlb_weights contain NaN for this beta schedule")

        f32 = lambda a: np.asarray(a, dtype=np.float32)
        return cls(
            betas=f32(betas),
            alphas_cumprod=f32(alphas_cumprod),
            alphas_cumprod_prev=f32(alphas_cumprod_prev),
            sqrt_alphas_cumprod=f32(np.sqrt(alphas_cumprod)),
            sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - alphas_cumprod)),
            log_one_minus_alphas_cumprod=f32(np.log(1.0 - alphas_cumprod)),
            sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod)),
            sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod - 1)),
            posterior_variance=f32(posterior_variance),
            posterior_log_variance_clipped=f32(
                np.log(np.maximum(posterior_variance, 1e-20))
            ),
            posterior_mean_coef1=f32(
                betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod)
            ),
            posterior_mean_coef2=f32(
                (1.0 - alphas_cumprod_prev) * np.sqrt(alphas) / (1.0 - alphas_cumprod)
            ),
            lvlb_weights=f32(lvlb_weights),
        )


def make_ddim_timesteps(
    ddim_discr_method: str, num_ddim_timesteps: int, num_ddpm_timesteps: int
) -> np.ndarray:
    """DDIM timestep subset incl. the reference's +1 shift (util.py:46-60)."""
    if ddim_discr_method == "uniform":
        c = num_ddpm_timesteps // num_ddim_timesteps
        ddim_timesteps = np.asarray(list(range(0, num_ddpm_timesteps, c)))
    elif ddim_discr_method == "quad":
        ddim_timesteps = (
            (np.linspace(0, np.sqrt(num_ddpm_timesteps * 0.8), num_ddim_timesteps)) ** 2
        ).astype(int)
    else:
        raise NotImplementedError(ddim_discr_method)
    steps_out = ddim_timesteps + 1
    if steps_out.max() >= num_ddpm_timesteps:
        # the reference crashes later on the same input (acp[T] gather);
        # fail early with a usable message instead
        raise ValueError(
            f"num_ddim_timesteps={num_ddim_timesteps} must divide "
            f"num_ddpm_timesteps={num_ddpm_timesteps} for the uniform method "
            f"(+1 shift would index step {steps_out.max()})"
        )
    return steps_out


def make_karras_timesteps(
    schedule: "DiffusionSchedule", num_steps: int, rho: float = 7.0
) -> np.ndarray:
    """Karras et al. 2022 sigma spacing (arXiv:2206.00364 eq. 5), quantized
    to the trained discrete t-grid.

    Beyond-parity: the reference grids are uniform/quad only (reference
    diffusionmodules/util.py:46-60). The VP schedule is read as VE sigmas
    sigma(t) = sqrt((1-acp_t)/acp_t); the rho-warped grid concentrates
    steps at LOW noise, where the probability-flow ODE's curvature lives —
    which is exactly where 2nd-order solvers lose accuracy on the uniform
    grid at <=10 steps. Each continuous Karras sigma is mapped back to the
    nearest trained integer t by log-sigma interpolation (the k-diffusion
    "quantize to the model's discrete sigmas" convention), so converted
    checkpoints are evaluated only at timesteps they trained on.

    Returns ascending unique int timesteps within [1, T-1]; t=0 is excluded
    to match the reference's +1-shifted uniform grid (a t=0 model eval
    would make the final transition onto acp[0] a no-op). Rounding
    collisions (possible at very high step counts) dedupe to fewer steps.
    """
    acp = schedule.alphas_cumprod.astype(np.float64)
    sigmas = np.sqrt((1.0 - acp) / acp)  # ascending in t
    log_s = np.log(sigmas)
    s_lo, s_hi = sigmas[1], sigmas[-1]
    if num_steps == 1:
        grid = np.asarray([s_hi], dtype=np.float64)
    else:
        i = np.arange(num_steps, dtype=np.float64)
        inv = 1.0 / rho
        grid = (
            s_hi**inv + i / (num_steps - 1) * (s_lo**inv - s_hi**inv)
        ) ** rho  # descending sigma, sigma_max -> sigma(t=1)
    t_cont = np.interp(np.log(grid), log_s, np.arange(len(sigmas), dtype=np.float64))
    return np.unique(np.clip(np.round(t_cont), 1, len(sigmas) - 1)).astype(np.int64)


def grid_timesteps(schedule: "DiffusionSchedule", num_steps: int,
                   method: str) -> np.ndarray:
    """The ascending t-grid of `method`: "uniform"/"quad" (the reference's
    DDIM grids) or "karras"; every sampler's tables are built over it."""
    if method == "karras":
        return make_karras_timesteps(schedule, num_steps)
    return make_ddim_timesteps(method, num_steps, schedule.num_timesteps)


@dataclasses.dataclass(frozen=True)
class DDIMSchedule:
    """Per-step DDIM tables, ordered by sampling *step* (reverse time).

    Index 0 is the first sampler update (largest t).
    """

    timesteps: np.ndarray  # (S,) int32, descending
    alphas: np.ndarray  # a_t per step
    alphas_prev: np.ndarray
    sqrt_one_minus_alphas: np.ndarray
    sigmas: np.ndarray

    @property
    def num_steps(self) -> int:
        return int(self.timesteps.shape[0])


def make_ddim_schedule(
    schedule: DiffusionSchedule,
    num_steps: int,
    eta: float = 0.0,
    method: str = "uniform",
    timesteps: np.ndarray | None = None,
) -> DDIMSchedule:
    """DDIM tables (reference util.py:63-74, ddim.py:25-54), reverse ordered.

    method: "uniform"/"quad" (reference grids) or "karras" (beyond-parity
    low-step spacing, `make_karras_timesteps`) — the table math is
    grid-generic. An explicit ascending int `timesteps` array overrides the
    method entirely (the distilled students sample on their own nested
    halving grids, training/distill.py).
    """
    if timesteps is not None:
        ts = np.asarray(timesteps, dtype=np.int64)
        if ts.ndim != 1 or not (np.diff(ts) > 0).all():
            raise ValueError(f"ascending 1-D timestep grid required, got {ts}")
        if not (0 < ts[0] and ts[-1] < schedule.num_timesteps):
            raise ValueError(
                f"timesteps must lie in [1, {schedule.num_timesteps - 1}], "
                f"got {ts}")
    else:
        ts = grid_timesteps(schedule, num_steps, method)
    acp = schedule.alphas_cumprod.astype(np.float64)
    alphas = acp[ts]
    alphas_prev = np.asarray([acp[0]] + acp[ts[:-1]].tolist())
    sigmas = eta * np.sqrt(
        (1 - alphas_prev) / (1 - alphas) * (1 - alphas / alphas_prev)
    )
    rev = slice(None, None, -1)
    return DDIMSchedule(
        timesteps=np.ascontiguousarray(ts[rev]).astype(np.int32),
        alphas=np.ascontiguousarray(alphas[rev]).astype(np.float32),
        alphas_prev=np.ascontiguousarray(alphas_prev[rev]).astype(np.float32),
        sqrt_one_minus_alphas=np.ascontiguousarray(
            np.sqrt(1.0 - alphas)[rev]
        ).astype(np.float32),
        sigmas=np.ascontiguousarray(sigmas[rev]).astype(np.float32),
    )
