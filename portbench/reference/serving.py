"""The served engine's per-batch randomness, worked out again.

The engine (`upgpt_torch.inference.serving`, the JAX engine's
`fold_in(base_key, i)`) seeds batch i's host generator with
`base_seed * 2**32 + i`, draws one base from it (`randint(2**62)`), and
gives each row with `x_T_seed` s the x_T of a device generator seeded
`(base + s * 0x9E3779B97F4A7C15) % 2**63`. This restates that recipe
from its published description; it needs the batch index a request was
served in, which only the program's run can say.
"""

from __future__ import annotations

import torch


def row_x_T(base_seed: int, index: int, x_T_seed: int, shape, device
            ) -> torch.Tensor:
    host = torch.Generator().manual_seed(base_seed * 2**32 + int(index))
    base = int(torch.randint(2**62, (1,), generator=host).item())
    g = torch.Generator(device=device).manual_seed(
        (base + int(x_T_seed) * 0x9E3779B97F4A7C15) % 2**63)
    return torch.randn(tuple(shape), generator=g, device=device)
