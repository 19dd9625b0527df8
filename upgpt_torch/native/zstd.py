"""Zstandard decoding and CRC-32C through the native core
(`zstd_core.cpp`).

The orbax reader (`convert.ocdbt`, `convert.orbax`) decodes every OCDBT
node and zarr chunk with it. The core is compiled with g++ at first use
into `upgpt_torch/_build/native-<hash of the source>/libupgpt_zstd.so`
(under a second; an edited source builds anew) and bound with ctypes,
which releases the GIL for each call. There is no fallback: where the
build fails, the first call raises with the compiler's stderr.

tensorstore writes its zstd frames without a content size, so a caller
gives the size it expects (a zarr chunk's byte count) where it knows it;
otherwise the frames' declared sizes are used, and failing those the
output grows up to `cap` bytes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "zstd_core.cpp"
_BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"

_ERRORS = {-1: "truncated input", -2: "corrupt data",
           -3: "output larger than the buffer", -4: "needs a dictionary",
           -5: "content checksum mismatch", -6: "not a zstd frame",
           -7: "content size disagrees with the frame header"}
_DST_SIZE, _UNKNOWN_SIZE = -3, -8
_FIRST_GUESS = 1 << 16

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    """Where the built core lives, keyed by the source's contents."""
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return _BUILD_ROOT / f"native-{digest}" / "libupgpt_zstd.so"


def build() -> Path:
    """Compile the core (once per source) and return the library's path;
    raises RuntimeError with the compiler's stderr where g++ fails. The
    rename is atomic, so concurrent processes never load a half-written
    library."""
    so = library_path()
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=str(so.parent))
    os.close(fd)
    try:
        proc = subprocess.run(
            ["g++", "-O3", "-std=c++17", "-fPIC", "-shared", str(_SRC),
             "-o", tmp], capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as err:
        os.unlink(tmp)
        raise RuntimeError(f"building {_SRC.name} failed: {err}") from err
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"building {_SRC.name} failed "
                           f"(g++ exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, so)
    return so


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            buf = [ctypes.c_void_p, ctypes.c_size_t]
            lib.upgpt_zstd_decompress.restype = ctypes.c_int64
            lib.upgpt_zstd_decompress.argtypes = buf + buf
            lib.upgpt_zstd_content_size.restype = ctypes.c_int64
            lib.upgpt_zstd_content_size.argtypes = buf
            lib.upgpt_crc32c.restype = ctypes.c_uint32
            lib.upgpt_crc32c.argtypes = buf
            _lib = lib
    return _lib


def _address(buf) -> tuple:
    """(view, pointer, length) of a bytes-like object, without a copy;
    the view must outlive the call."""
    arr = np.frombuffer(buf, np.uint8)
    return arr, arr.ctypes.data, arr.size


def _check(rc: int) -> int:
    if rc < 0:
        raise ValueError(f"zstd: {_ERRORS.get(rc, f'error {rc}')}")
    return rc


def _decode(data, out) -> int:
    """The core's return code for decoding `data` into `out`."""
    _keep, src, n = _address(data)
    dst = (out if isinstance(out, np.ndarray)
           else np.frombuffer(out, np.uint8))
    if not (dst.flags.writeable and dst.flags.c_contiguous):
        raise ValueError("zstd: the output must be a writable contiguous "
                         "buffer")
    return _load().upgpt_zstd_decompress(src, n, dst.ctypes.data,
                                         dst.nbytes)


def decompress_into(data, out) -> int:
    """Decode every frame of `data` into the writable buffer `out`
    (a bytearray, a contiguous numpy array); returns the bytes written."""
    return _check(_decode(data, out))


def content_size(data) -> Optional[int]:
    """The summed content size `data`'s frames declare, or None where a
    frame declares none."""
    _keep, src, n = _address(data)
    rc = _load().upgpt_zstd_content_size(src, n)
    return None if rc == _UNKNOWN_SIZE else _check(rc)


def decompress(data, size: Optional[int] = None,
               cap: int = 1 << 31) -> bytearray:
    """Decode `data` (zstd frames and skippable frames, back to back).

    `size`, where given, is the exact decoded size (anything else raises).
    Without it the frames' declared size is used; where they declare none,
    the output doubles from a first guess until it fits, up to `cap`
    bytes."""
    if size is None:
        size = content_size(data)
    if size is not None:
        if size > cap:
            raise ValueError(f"zstd: {size} bytes exceed the cap of {cap}")
        out = bytearray(size)
        got = decompress_into(data, out)
        if got != size:
            raise ValueError(f"zstd: decoded {got} bytes, expected {size}")
        return out
    guess = min(cap, max(_FIRST_GUESS, 4 * len(data)))
    while True:
        out = bytearray(guess)
        rc = _decode(data, out)
        if rc != _DST_SIZE:
            del out[_check(rc):]
            return out
        if guess >= cap:
            raise ValueError(f"zstd: the content exceeds the cap of {cap} "
                             f"bytes")
        guess = min(cap, 2 * guess)


def crc32c(data) -> int:
    """CRC-32C (Castagnoli) of a bytes-like object."""
    _, src, n = _address(data)
    return int(_load().upgpt_crc32c(src, n))

