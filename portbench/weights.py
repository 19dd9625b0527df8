"""Seeded weights, drawn on the device in one call, shared by the program
and the reference.

The law is the one `chip_smoke.py`'s `_redraw` used: weights N(0,
1/fan_in), norm scales 1 + 0.1 N(0, 1), biases and norm shifts 0.1 N(0, 1),
so no output projection stays at its zero initialisation. The parameter
table comes from the reference (`reference.ldm.param_table`); the program
takes the same tensors by name through `load_state_dict(strict=True)`,
which also checks that its parameter tree matches the reference's.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from portbench.reference import ldm


class SeededWeights:
    """One flat buffer of every parameter, in `dtype`, on `device`."""

    def __init__(self, cfg: dict, seed: int, device, dtype: torch.dtype):
        self.table: List[Tuple[str, Tuple[int, ...]]] = ldm.param_table(cfg)
        sizes = [math.prod(s) for _, s in self.table]
        scale, shift = [], []
        for name, shape in self.table:
            if len(shape) >= 2:  # Linear (out, in) or Conv2d (O, I, kH, kW)
                scale.append(1.0 / math.sqrt(math.prod(shape[1:])))
                shift.append(0.0)
            elif name.endswith("weight"):  # the only 1-D weights are norms'
                scale.append(0.1)
                shift.append(1.0)
            else:
                scale.append(0.1)
                shift.append(0.0)
        g = torch.Generator(device=device).manual_seed(seed)
        counts = torch.tensor(sizes, device=device)
        flat = torch.randn(sum(sizes), generator=g, device=device)
        flat.mul_(torch.repeat_interleave(
            torch.tensor(scale, device=device), counts))
        flat.add_(torch.repeat_interleave(
            torch.tensor(shift, device=device), counts))
        self.flat = flat.to(dtype)
        del flat
        self.views: Dict[str, torch.Tensor] = {}
        off = 0
        for (name, shape), n in zip(self.table, sizes):
            self.views[name] = self.flat[off:off + n].view(shape)
            off += n

    def load_into(self, model: torch.nn.Module) -> None:
        """Copy every tensor into the program's parameters, by name."""
        with torch.no_grad():
            model.load_state_dict(self.views, strict=True)
