"""Learning-rate multiplier schedules: step -> multiplier.

Port of `upgpt_tpu.training.lr` (reference `LambdaLinearScheduler` and
`LambdaWarmUpCosineScheduler`, ldm/lr_scheduler.py:4-97), in numpy float32
as the JAX versions compute in float32. Multiply by the base LR; the train
state does.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

f32 = np.float32


def lambda_linear_schedule(
    warm_up_steps: Sequence[int],
    f_min: Sequence[float],
    f_max: Sequence[float],
    f_start: Sequence[float],
    cycle_lengths: Sequence[int],
):
    """LambdaLinearScheduler (reference lr_scheduler.py:81-97): per cycle, a
    linear warm-up from f_start to f_max, then a linear path toward f_min
    over the rest of the cycle."""
    warm_up = np.asarray(warm_up_steps, f32)
    fmin = np.asarray(f_min, f32)
    fmax = np.asarray(f_max, f32)
    fstart = np.asarray(f_start, f32)
    lengths = np.asarray(cycle_lengths, f32)
    cum = np.concatenate([[0.0], np.cumsum(np.asarray(cycle_lengths,
                                                      np.float64))])
    ends = cum[1:].astype(f32)
    starts = cum[:-1].astype(f32)

    def schedule(step) -> float:
        n = f32(step)
        cycle = int(np.clip(np.sum(ends <= n), 0, len(lengths) - 1))
        wu, length = warm_up[cycle], lengths[cycle]
        n_c = n - starts[cycle]
        if n_c < wu:
            return float(fstart[cycle] + (fmax[cycle] - fstart[cycle])
                         / max(wu, f32(1.0)) * n_c)
        return float(fmin[cycle] + (fmax[cycle] - fmin[cycle]) * (
            f32(1.0) - (n_c - wu) / max(length - wu, f32(1.0))))

    return schedule


def lambda_warmup_cosine(warm_up_steps: int, lr_min: float, lr_max: float,
                         lr_start: float, max_decay_steps: int):
    """LambdaWarmUpCosineScheduler (reference lr_scheduler.py:4-33)."""

    def schedule(step) -> float:
        n = f32(step)
        if n < warm_up_steps:
            return float(f32(lr_start) + f32(lr_max - lr_start)
                         / f32(max(warm_up_steps, 1)) * n)
        t = (n - f32(warm_up_steps)) / f32(max(max_decay_steps
                                                - warm_up_steps, 1))
        t = np.clip(t, f32(0.0), f32(1.0))
        return float(f32(lr_min) + f32(0.5) * f32(lr_max - lr_min)
                     * (f32(1.0) + np.cos(t * f32(np.pi))))

    return schedule
