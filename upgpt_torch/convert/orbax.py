"""The JAX package's orbax checkpoints, read without orbax, tensorstore or
JAX.

`orbax.checkpoint.StandardCheckpointer().save(path, tree)` writes
`_METADATA` (JSON: each leaf's path as a list of keys, each key a dict key
(`key_type` 2) or a sequence index (1), and its value type) and one zarr
v2 array per leaf, named by the path's keys joined with ".". With
`use_ocdbt` (orbax's default) the arrays live in the OCDBT store at the
directory's root (`convert.ocdbt`), under keys `<name>/.zarray` and
`<name>/<chunk>`; without it, each array is a directory of files.

`restore(path)` returns the tree orbax's `restore` returns: dicts and lists
rebuilt from the key types (tuples and named tuples come back as lists, as
orbax gives them), `None` and empty containers where orbax recorded them
(an empty tuple, such as `optax.MultiSteps`' `skip_state`, as `()`),
python scalars for its `scalar` leaves, and every array leaf a numpy array
of orbax's dtype, shape and bytes, or a torch tensor for bfloat16, which
numpy lacks. Zarr v2 is read with a `zstd` compressor or none, C or F
order, any chunk grid (missing chunks take the fill value), and scalars
(chunk key `0`). Zarr v3 (`use_zarr3`) is refused by name.
"""

from __future__ import annotations

import json
import math
import os
from itertools import product
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch

from upgpt_torch.convert.ocdbt import OcdbtStore
from upgpt_torch.native import zstd

PathLike = Union[str, os.PathLike]
_SEQUENCE = 1  # a key_type; 2 is a dict key
# the value types orbax records for None and empty containers
_EMPTY = {"None": lambda: None, "Dict": dict, "List": list, "Tuple": tuple}
_ARRAYS = ("np.ndarray", "jax.Array", "scalar")


def is_orbax_dir(path: PathLike) -> bool:
    """True where `path` is a directory orbax wrote a tree into."""
    return (Path(path) / "_METADATA").is_file()


class _DirStore:
    """The `use_ocdbt: false` layout: one file per zarr key."""

    def __init__(self, root: Path):
        self.root = root

    def __contains__(self, key: str) -> bool:
        return (self.root / key).is_file()

    def read(self, key: str) -> bytes:
        return (self.root / key).read_bytes()


def _dtype(name: str):
    """(numpy dtype of the stored bytes, torch dtype or None)."""
    if name == "bfloat16":
        return np.dtype("<u2"), torch.bfloat16
    return np.dtype(name), None


def _fill(meta: dict, dtype: np.dtype):
    value = meta.get("fill_value")
    if value is None:
        return 0
    if isinstance(value, str):  # zarr v2 spells NaN and the infinities
        return float({"NaN": "nan", "Infinity": "inf",
                      "-Infinity": "-inf"}.get(value, value))
    return value


class OrbaxCheckpoint:
    """One orbax checkpoint directory: its leaves and their arrays."""

    def __init__(self, path: PathLike):
        self.path = Path(path)
        if not is_orbax_dir(self.path):
            raise ValueError(f"{self.path}: no _METADATA; not a directory "
                             f"orbax's StandardCheckpointer wrote")
        meta = json.loads((self.path / "_METADATA").read_text())
        if meta.get("use_zarr3"):
            raise ValueError(f"{self.path}: use_zarr3 is true; zarr v3 "
                             f"arrays are not read (orbax writes zarr v2 "
                             f"by default)")
        self.use_ocdbt = bool(meta.get("use_ocdbt", True))
        self.leaves: List[Tuple[Tuple[Tuple[str, int], ...], dict]] = []
        for entry in meta["tree_metadata"].values():
            keys = tuple((k["key"], int(k["key_type"]))
                         for k in entry["key_metadata"])
            self.leaves.append((keys, entry["value_metadata"]))
        self._store = None

    @property
    def store(self):
        if self._store is None:
            self._store = (OcdbtStore(self.path) if self.use_ocdbt
                           else _DirStore(self.path))
        return self._store

    def read_array(self, name: str) -> Union[np.ndarray, torch.Tensor]:
        """The zarr v2 array `name` (a leaf's keys joined with ".")."""
        where = f"{self.path}: {name}"
        meta = json.loads(self.store.read(f"{name}/.zarray"))
        if meta.get("zarr_format") != 2:
            raise ValueError(f"{where}: zarr_format "
                             f"{meta.get('zarr_format')}, only 2 is read")
        if meta.get("filters"):
            raise ValueError(f"{where}: zarr filters {meta['filters']} are "
                             f"not read")
        compressor = meta.get("compressor")
        if compressor is not None and compressor.get("id") != "zstd":
            raise ValueError(f"{where}: compressor {compressor}; zstd or "
                             f"none is read")
        order = meta.get("order", "C")
        if order not in ("C", "F"):
            raise ValueError(f"{where}: order {order!r}")
        stored, as_torch = _dtype(meta["dtype"])
        shape = tuple(int(s) for s in meta["shape"])
        chunks = tuple(int(c) for c in meta["chunks"]) or shape
        sep = meta.get("dimension_separator", ".")
        grid = [math.ceil(s / c) if c else 0 for s, c in zip(shape, chunks)]
        chunk_bytes = math.prod(chunks) * stored.itemsize

        def chunk(index) -> Optional[np.ndarray]:
            key = f"{name}/" + (sep.join(map(str, index)) if index else "0")
            if key not in self.store:
                return None
            raw = self.store.read(key)
            buf = np.empty(chunk_bytes, np.uint8)
            if compressor is None:
                if len(raw) != chunk_bytes:
                    raise ValueError(f"{where}: chunk {key} holds "
                                     f"{len(raw)} bytes, {chunk_bytes} "
                                     f"expected")
                buf[:] = np.frombuffer(raw, np.uint8)
            else:
                got = zstd.decompress_into(raw, buf)
                if got != chunk_bytes:
                    raise ValueError(f"{where}: chunk {key} decoded to "
                                     f"{got} bytes, {chunk_bytes} expected")
            return buf.view(stored).reshape(chunks, order=order)

        if chunks == shape:  # one chunk: no copy
            out = chunk((0,) * len(shape))
            if out is None:
                out = np.full(shape, _fill(meta, stored), stored)
        else:
            out = np.full(shape, _fill(meta, stored), stored, order=order)
            for index in product(*(range(g) for g in grid)):
                block = chunk(index)
                if block is None:
                    continue
                region = tuple(slice(i * c, min((i + 1) * c, s))
                               for i, c, s in zip(index, chunks, shape))
                out[region] = block[tuple(slice(0, r.stop - r.start)
                                          for r in region)]
        if not stored.isnative:
            out = out.astype(stored.newbyteorder("="))
        if as_torch is not None:
            if not out.flags.c_contiguous:  # F order
                out = out.copy(order="C")
            return torch.from_numpy(out).view(as_torch)
        return out

    def _leaf(self, keys, value_meta):
        vtype = value_meta.get("value_type")
        if vtype in _EMPTY:
            return _EMPTY[vtype]()
        name = ".".join(k for k, _ in keys)
        if vtype not in _ARRAYS:
            raise ValueError(f"{self.path}: leaf {name} has value type "
                             f"{vtype!r}, not read")
        value = self.read_array(name)
        return np.asarray(value).item() if vtype == "scalar" else value

    def restore(self, top: Optional[Iterable[str]] = None):
        """The tree, or only its top-level entries named in `top`."""
        top = None if top is None else set(top)
        root = _Node()
        for keys, value_meta in self.leaves:
            if top is not None and keys[0][0] not in top:
                continue
            node = root
            for key, ktype in keys[:-1]:
                node = node.child(key, ktype)
            node.put(*keys[-1], self._leaf(keys, value_meta))
        return root.build()


class _Node:
    """A container being rebuilt: a dict, or a list where its keys are
    sequence indices (`key_type` 1)."""

    def __init__(self):
        self.kind: Optional[int] = None
        self.items: Dict = {}

    def _kind(self, ktype: int) -> None:
        if self.kind not in (None, ktype):
            raise ValueError("a container mixes dict keys and sequence "
                             "indices")
        self.kind = ktype

    def child(self, key: str, ktype: int) -> "_Node":
        self._kind(ktype)
        return self.items.setdefault(key, _Node())

    def put(self, key: str, ktype: int, value) -> None:
        self._kind(ktype)
        self.items[key] = value

    def build(self):
        items = {k: v.build() if isinstance(v, _Node) else v
                 for k, v in self.items.items()}
        if self.kind != _SEQUENCE:
            return items
        order = sorted(items, key=int)
        if [int(k) for k in order] != list(range(len(order))):
            raise ValueError(f"sequence indices {order} are not 0..n-1")
        return [items[k] for k in order]


def restore(path: PathLike, top: Optional[Iterable[str]] = None):
    """`ocp.StandardCheckpointer().restore(path)`'s tree, read directly;
    `top` restores only the named top-level entries."""
    return OrbaxCheckpoint(path).restore(top)
