"""SMPL pickles, read without running the code a pickle may name.

The DeepFashion tree's `smpl_256/<pose>.p` files, the app's pose
directory and `cli data-verify` hold one list of dicts of numpy arrays
(`pred_body_pose`, `pred_betas`, `pred_camera`). `pickle.load` would call
any global such a file names; `load_smpl_pickle` admits only what those
files are made of: plain containers, numpy arrays and dtypes through
numpy's `_reconstruct` (either module name numpy has given it), and
`_codecs.encode` (numpy's byte payloads in protocol 2). Any other global
raises `pickle.UnpicklingError` naming it.
"""

from __future__ import annotations

import _codecs
import builtins
import collections
import os
import pickle
from typing import Union

import numpy as np

try:  # numpy >= 2
    from numpy._core.multiarray import _reconstruct
except ImportError:  # pragma: no cover - numpy 1
    from numpy.core.multiarray import _reconstruct

_ADMITTED = {
    ("numpy", "ndarray"): np.ndarray,
    ("numpy", "dtype"): np.dtype,
    ("numpy.core.multiarray", "_reconstruct"): _reconstruct,
    ("numpy._core.multiarray", "_reconstruct"): _reconstruct,
    ("_codecs", "encode"): _codecs.encode,
    ("collections", "OrderedDict"): collections.OrderedDict,
    **{(module, name): getattr(builtins, name)
       for module in ("builtins", "__builtin__")
       for name in ("dict", "list", "tuple", "set", "frozenset")},
}


class _SmplUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        try:
            return _ADMITTED[(module, name)]
        except KeyError:
            raise pickle.UnpicklingError(
                f"SMPL pickle names the global {module}.{name}; only plain "
                f"containers and numpy arrays are admitted") from None


def load_smpl_pickle(path: Union[str, os.PathLike]):
    """The object in an SMPL pickle, through the restricted unpickler."""
    with open(path, "rb") as fh:
        return _SmplUnpickler(fh).load()
