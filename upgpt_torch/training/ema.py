"""Exponential moving average of the trainable parameters.

Port of `upgpt_tpu.training.ema` (LitEma semantics, reference
ldm/modules/ema.py:5-76): effective decay min(decay, (1 + n) / (10 + n))
with n the number of updates so far, and shadow <- shadow - (1 - decay) *
(shadow - param). The shadow is float32 whatever the parameters' dtype: a
bf16 shadow freezes at decay 0.9999, where each update is below bf16's
resolution (the JAX package's fault R1, ROADMAP.md §3).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch


@dataclasses.dataclass
class EmaState:
    shadow: List[torch.Tensor]  # float32, one per trainable parameter
    num_updates: int
    decay: float


def ema_init(params: Sequence[torch.Tensor], decay: float = 0.9999
             ) -> EmaState:
    return EmaState(shadow=[p.detach().float().clone() for p in params],
                    num_updates=0, decay=decay)


def ema_decay(num_updates: int, decay: float) -> float:
    """min(decay, (1 + n) / (10 + n)) in float32, as the JAX package takes
    it."""
    n = np.float32(num_updates)
    return float(min(np.float32(decay), (np.float32(1.0) + n)
                     / (np.float32(10.0) + n)))


@torch.no_grad()
def ema_update(state: EmaState, params: Sequence[torch.Tensor]) -> EmaState:
    """One update in place: shadow moves toward params by 1 - decay."""
    state.num_updates += 1
    weight = 1.0 - ema_decay(state.num_updates, state.decay)
    # lerp: shadow + w * (param - shadow), the same update
    torch._foreach_lerp_(state.shadow, [p.float() for p in params], weight)
    return state
