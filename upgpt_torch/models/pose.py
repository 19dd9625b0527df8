"""Pose conditioning: SMPL parameter vector -> one 768-dim context token.

Port of `upgpt_tpu.models.pose.LinearProject` (reference
ldm/modules/poses/poses.py:3-16): one Linear(85, 768) over the SMPL body
pose (72) + betas (10) + camera (3) vector, computed in float32 whatever the
parameters' dtype, as the JAX module's float32 Dense does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class LinearProject(nn.Module):
    def __init__(self, input_dim: int = 85, output_dim: int = 768):
        super().__init__()
        self.proj = nn.Linear(input_dim, output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, n, input_dim) or (B, input_dim) -> (B, n, output_dim) float32."""
        if x.dim() == 2:
            x = x[:, None, :]
        return F.linear(x.float(), self.proj.weight.float(),
                        self.proj.bias.float())
