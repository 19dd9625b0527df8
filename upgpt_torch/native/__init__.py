"""Native (C++) host-runtime components.

The port's copy of `upgpt_tpu.native`: a libjpeg decode core
(`jpeg_core.cpp`) whose ctypes entry points release the GIL for the whole
decode, so the thread-pool `PrefetchDataLoader` decodes on real cores
without the worker-process loader's spawn and pickle transport (reference
analog: torch DataLoader's C-side decode workers, reference
main.py:208-250).

Build model: compiled with g++ on first use into
`upgpt_torch/_build/native-<hash of the source>/` (one small file, under a
second; the directory is not tracked, so the source is the only input).
Any failure (no compiler, no libjpeg header, an exotic platform) leaves
`available() == False` and callers fall back to PIL. The first load decodes
a probe JPEG through the core and through PIL and keeps the core only if
the two agree bit for bit: the same libjpeg with its default JDCT_ISLOW
IDCT gives the same bytes, another libjpeg would not.

Env:
  UPGPT_NATIVE_DECODE=0  disable the native path (PIL everywhere).
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

_SRC = Path(__file__).resolve().parent / "jpeg_core.cpp"
_BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_state = "unbuilt"  # unbuilt | ok | failed


def library_path() -> Path:
    """Where the built core lives: keyed by the source's contents, so an
    edited source builds anew and a stale library is never loaded."""
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return _BUILD_ROOT / f"native-{digest}" / "libupgpt_jpeg.so"


def _build(so: Path) -> bool:
    """Compile jpeg_core.cpp into `so` (atomic rename: concurrent processes,
    such as test workers, never load a half-written library)."""
    try:
        so.parent.mkdir(parents=True, exist_ok=True)
        with tempfile.NamedTemporaryFile(suffix=".so", dir=str(so.parent),
                                         delete=False) as tmp:
            tmp_path = tmp.name
        proc = subprocess.run(
            ["g++", "-O3", "-fPIC", "-shared", str(_SRC), "-o", tmp_path,
             "-ljpeg"],
            capture_output=True, timeout=120)
        if proc.returncode != 0:
            os.unlink(tmp_path)
            return False
        os.replace(tmp_path, so)
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def _decode_with(lib: ctypes.CDLL, data: bytes) -> Optional[np.ndarray]:
    h = ctypes.c_int()
    w = ctypes.c_int()
    if lib.upgpt_jpeg_header(data, len(data), ctypes.byref(h),
                             ctypes.byref(w)):
        return None
    out = np.empty((h.value, w.value, 3), np.uint8)
    if lib.upgpt_decode_jpeg(data, len(data), out.ctypes.data, h.value,
                             w.value):
        return None
    return out


def _probe_matches_pil(lib: ctypes.CDLL) -> bool:
    """Decode one in-memory probe JPEG through the native core and PIL.

    Bit-exactness with PIL holds only when both link the SAME libjpeg
    (same IDCT tables); on a host where PIL bundles a different
    libjpeg(-turbo) than the system one the .so found, output would
    silently diverge. This first-load probe disables the native path on
    any mismatch instead of trusting the build-host test.
    """
    try:
        import io

        from PIL import Image

        rng = np.random.default_rng(0)
        # low-frequency content so every libjpeg agrees it is decodable
        img = rng.integers(0, 256, size=(4, 4, 3), dtype=np.uint8)
        img = np.kron(img, np.ones((16, 16, 1), np.uint8))
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="JPEG", quality=88)
        data = buf.getvalue()
        pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        out = _decode_with(lib, data)
        return out is not None and out.shape == pil.shape and bool(
            np.array_equal(out, pil))
    except Exception:  # noqa: BLE001 — any probe hiccup -> PIL fallback
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _state
    if _state != "unbuilt":
        return _lib
    with _lock:
        if _state != "unbuilt":
            return _lib
        try:
            so = library_path()
            if not so.exists() and not _build(so):
                _state = "failed"
                return None
            lib = ctypes.CDLL(str(so))
            lib.upgpt_jpeg_header.restype = ctypes.c_int
            lib.upgpt_jpeg_header.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ]
            lib.upgpt_decode_jpeg.restype = ctypes.c_int
            lib.upgpt_decode_jpeg.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int,
            ]
            if not _probe_matches_pil(lib):
                _state = "failed"
                return None
            _lib = lib
            _state = "ok"
        except OSError:
            _state = "failed"
    return _lib


def available() -> bool:
    """True iff the native decoder is built (or buildable) and enabled."""
    if os.environ.get("UPGPT_NATIVE_DECODE", "1") == "0":
        return False
    return _load() is not None


def decode_jpeg(data: bytes) -> Optional[np.ndarray]:
    """Decode a JPEG byte string to an HWC uint8 RGB array.

    Returns None on any decode problem (caller falls back to PIL). The
    foreign call releases the GIL, so concurrent callers on a thread pool
    decode truly in parallel.
    """
    lib = _load()
    return None if lib is None else _decode_with(lib, data)


def decode_jpeg_file(path) -> Optional[np.ndarray]:
    """Read + decode a JPEG file; None on failure."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    return decode_jpeg(data)
