"""Parameter layers shared by the port's models, on NHWC tensors.

The JAX package runs NHWC everywhere. These layers keep NHWC at module
boundaries and run convolutions on `x.permute(0, 3, 1, 2)`, which is the
channels_last NCHW view of the same memory, so no copy is made. Every layer
computes in its parameters' dtype, as a flax layer computes in its `dtype`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Conv2d(nn.Conv2d):
    """nn.Conv2d taking and returning NHWC tensors."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, zero_init: bool = False):
        super().__init__(in_channels, out_channels, kernel_size,
                         stride=stride, padding=padding)
        if zero_init:  # the reference's zero_module (util.py:174-180)
            nn.init.zeros_(self.weight)
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x.to(self.weight.dtype).permute(0, 3, 1, 2), self.weight,
                     self.bias, self.stride, self.padding)
        return y.permute(0, 2, 3, 1)


class Dense(nn.Linear):
    """nn.Linear that casts its input to the weight dtype."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 zero_init: bool = False):
        super().__init__(in_features, out_features, bias=bias)
        if zero_init:
            nn.init.zeros_(self.weight)
            if bias:
                nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.weight.dtype), self.weight, self.bias)


class Norm(nn.Module):
    """Scale/shift holder of a GroupNorm or LayerNorm (weight 1, bias 0)."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
