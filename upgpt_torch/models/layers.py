"""Parameter layers shared by the port's models, on NHWC tensors.

The JAX package runs NHWC everywhere. These layers keep NHWC at module
boundaries and run convolutions on `x.permute(0, 3, 1, 2)`, which is the
channels_last NCHW view of the same memory, so no copy is made.

`dtype` is the compute dtype, with flax's semantics: the layer casts its
input, weight and bias to it in `forward`, so float32 master parameters
train under bf16 compute and their gradients reach the masters through the
casts. `dtype=None` computes in the parameters' own dtype (the sampling
path keeps bf16 parameters, where the casts are no-ops).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def _cast(x: Optional[torch.Tensor], dtype: torch.dtype):
    return None if x is None else x.to(dtype)


class Conv2d(nn.Conv2d):
    """nn.Conv2d taking and returning NHWC tensors."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 stride: int = 1, padding=0, zero_init: bool = False,
                 dtype: Optional[torch.dtype] = None, bias: bool = True):
        super().__init__(in_channels, out_channels, kernel_size,
                         stride=stride, padding=padding, bias=bias)
        self.compute_dtype = dtype
        if zero_init:  # the reference's zero_module (util.py:174-180)
            nn.init.zeros_(self.weight)
            if bias:
                nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        comp = self.compute_dtype or self.weight.dtype
        y = F.conv2d(x.to(comp).permute(0, 3, 1, 2), self.weight.to(comp),
                     _cast(self.bias, comp), self.stride, self.padding)
        return y.permute(0, 2, 3, 1)


class Dense(nn.Linear):
    """nn.Linear computing in its compute dtype."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 zero_init: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype
        if zero_init:
            nn.init.zeros_(self.weight)
            if bias:
                nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        comp = self.compute_dtype or self.weight.dtype
        return F.linear(x.to(comp), self.weight.to(comp),
                        _cast(self.bias, comp))


class Norm(nn.Module):
    """Scale/shift holder of a GroupNorm or LayerNorm (weight 1, bias 0)."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
