"""Build and load the port's CUDA kernels.

Every `upgpt_torch/csrc/*.cu` is compiled by one nvcc call into one shared
library with a plain C interface, loaded with ctypes at first use:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o libupgpt_kernels.so csrc/*.cu

The library lands in `upgpt_torch/_build/<hash>/`, keyed by a hash of the
sources and flags, so an edit rebuilds and an unchanged tree reuses the
library. Nothing here runs at import time: `library()` builds on the first
kernel launch. nvcc is found through $CUDA_HOME, then $PATH, then CUDA's
default install prefix. A missing nvcc or a failed build raises with nvcc's
output in the message.

Each C entry point launches on the stream it is given, allocates nothing,
does not synchronise, and returns `cudaGetLastError()`; `check` raises on a
non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float

# C signatures: name -> argtypes; every entry point returns cudaError_t (int)
SIGNATURES = {
    "upgpt_flash_attention": [P, P, P, P, I, I, I, I, I, P],
    "upgpt_fused_transformer_block": (
        [P, P]                      # x, out
        + [P, P, P, P]              # gn w/b, proj_in w/b
        + [P, P, P, P, P, P, P]     # ln1 w/b, to_q, to_k, to_v, to_out w/b
        + [P, P, P, P, P, P, P]     # ln2 w/b, to_q2, k, v, to_out2 w/b
        + [P, P, P, P, P, P]        # ln3 w/b, ff1 w/b, ff2 w/b
        + [P, P]                    # proj_out w/b
        + [P, P]                    # bf16 workspace, fp32 stats
        + [I, I, I, I, I, F, F, P]  # B, T, C, heads, Tk, gn_eps, q_scale, stream
    ),
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = []
    if cuda_home:
        candidates.append(os.path.join(cuda_home, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, $PATH and "
        "/usr/local/cuda/bin); the CUDA toolkit is needed to build "
        "upgpt_torch's kernels")


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def _compile(out: Path, cu_files) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, cu_files)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            sources = _sources()
            out = BUILD_ROOT / _digest(sources) / "libupgpt_kernels.so"
            if not out.exists():
                _compile(out, [s for s in sources if s.suffix == ".cu"])
            lib = ctypes.CDLL(str(out))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.upgpt_error_string.argtypes = [I]
            lib.upgpt_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = library().upgpt_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
