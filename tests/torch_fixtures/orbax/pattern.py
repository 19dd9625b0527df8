"""The weights of the `interp_256_tiled` orbax fixture, without JAX.

Each leaf of the full-width interp_256 tree is `leaf(path, shape)`: a
seeded 64-value float32 vector, keyed by the CRC-32 of the leaf's path
("unet/out_conv/kernel"), repeated to fill the shape (`np.resize`). At
zstd level 1 the period turns into long matches, so ~2 GB of weights take
under a megabyte on disk, and a reader's output can be checked bit for
bit anywhere the fixture is read (`make_fixtures.py` writes it with the
JAX package; `chip_smoke.py` and `tests/test_torch_orbax.py` regenerate
it here).
"""

from __future__ import annotations

import zlib

import numpy as np

PERIOD = 64
SCALE = 0.05


def pattern(path: str) -> np.ndarray:
    """The period of the leaf at `path`."""
    rng = np.random.default_rng(zlib.crc32(path.encode("utf-8")))
    return (SCALE * rng.standard_normal(PERIOD)).astype(np.float32)


def leaf(path: str, shape) -> np.ndarray:
    """The leaf at `path`: its period repeated to `shape`."""
    return np.resize(pattern(path), tuple(shape))
