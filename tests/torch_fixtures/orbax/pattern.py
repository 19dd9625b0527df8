"""The weights of the `interp_256_tiled` and `interp_256_trainer_tiled`
orbax fixtures, without JAX.

Each leaf of the full-width interp_256 tree is `leaf(path, shape)`: a
seeded 64-value float32 vector, keyed by the CRC-32 of the leaf's path
("unet/out_conv/kernel"), repeated to fill the shape (`np.resize`). At
zstd level 1 the period turns into long matches, so ~2 GB of weights take
under a megabyte on disk, and a reader's output can be checked bit for
bit anywhere the fixture is read (`make_fixtures.py` writes it with the
JAX package; `chip_smoke.py` and `tests/test_torch_orbax.py` regenerate
it here). The trainer fixture's leaves are `trainer_leaf(path, shape)`.
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


# the trainer fixture's counts (step, both optax counts, ema_updates) and
# the epoch of its meta file
TRAINER_STEP, TRAINER_EPOCH = 7, 1
# Adam's second moment, which is not negative: its leaves are squared
SQUARED = "opt_state/0/nu/"


def trainer_leaf(path: str, shape) -> np.ndarray:
    """The trainer fixture's leaf at `path`: its pattern, squared under
    `SQUARED`."""
    value = leaf(path, shape)
    return value * value if path.startswith(SQUARED) else value
