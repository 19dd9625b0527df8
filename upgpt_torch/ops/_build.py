"""Build and load the port's CUDA kernels.

Every `upgpt_torch/csrc/*.cu` is compiled by its own nvcc process, all
started together, and the objects are linked into one shared library with a
plain C interface, loaded with ctypes at first use:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -c -o <name>.o csrc/<name>.cu      (one per source)
    nvcc -shared -o libupgpt_kernels.so *.o

The library lands in `upgpt_torch/_build/<hash>/`, keyed by a hash of the
sources and flags, so an edit rebuilds and an unchanged tree reuses the
library. Nothing here runs at import time: `library()` builds on the first
kernel launch. nvcc is found through $CUDA_HOME, then $PATH, then CUDA's
default install prefix. A missing nvcc or a failed build raises with nvcc's
output in the message.

Each C entry point launches on the stream it is given, allocates nothing,
does not synchronise, and returns `cudaGetLastError()`; `check` raises on a
non-zero code. The wrappers call it through `launch`, which makes the
tensors' card the current device first: a kernel launches into the current
device's context, and a stream of another card is refused there.
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

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

P = ctypes.c_void_p
I = ctypes.c_int
L = ctypes.c_longlong
F = ctypes.c_float

# C signatures: name -> argtypes; every entry point returns cudaError_t (int)
SIGNATURES = {
    "upgpt_flash_attention": [P, P, P, P, I, I, I, I, I, P],
    # q, k, v, o, dout, dq, lse, di, B, H, T, D, is_bf16, stream
    "upgpt_flash_backward_dq": [P, P, P, P, P, P, P, P, I, I, I, I, I, P],
    # q, k, v, dout, lse, di, dk, dv, B, H, T, D, is_bf16, stream
    "upgpt_flash_backward_dkv": [P, P, P, P, P, P, P, P, I, I, I, I, I, P],
    # x, scale, shift, out, N, HW, C, G, cluster, rows, threads, eps,
    # with_silu, is_bf16, stream
    "upgpt_fused_group_norm": [P, P, P, P, I, I, I, I, I, I, I, F, I, I, P],
    # x, ws, out, gamma, beta, image counters, N, HW, C, G, chunks, eps,
    # is_bf16, stream
    "upgpt_gn_stats": [P] * 6 + [I] * 5 + [F, I, P],
    # x, stats, scale, shift, out, N, HW, C, chunks, with_silu, is_bf16,
    # stream
    "upgpt_gn_apply": [P] * 5 + [I] * 6 + [P],
    # blocks, cluster (0: a plain launch), stream
    "upgpt_empty": [I, I, P],
    # x, gamma, beta, w, conv bias, out, ws, coef, image counters, plan,
    # split ws, its floats, tile counters, their count, N, H, W, C, O, G,
    # chunks, eps, is_bf16, stream
    "upgpt_fused_resblock": ([P] * 11 + [L, P, I] + [I] * 7 + [F, I, P]),
    # x, four weights, bias, Q/K/V and o workspaces, out, plan, B, T, C,
    # heads, stream
    "upgpt_selfattn_fullwidth": [P] * 10 + [I] * 4 + [P],
    "upgpt_selfattn_perhead": [P] * 10 + [I] * 4 + [P],
    "upgpt_fused_transformer_block": (
        [P, P]                      # x, out
        + [P, P, P, P]              # gn w/b, proj_in w/b
        + [P, P, P, P, P, P, P]     # ln1 w/b, to_q, to_k, to_v, to_out w/b
        + [P, P, P, P, P, P, P]     # ln2 w/b, to_q2, k, v, to_out2 w/b
        + [P, P, P, P, P, P]        # ln3 w/b, ff1 w/b, ff2 w/b
        + [P, P]                    # proj_out w/b
        + [P, P, P]                 # context, attn2 to_k, to_v (or nulls)
        + [P, P]                    # bf16 workspace, fp32 stats
        + [P, P, L, P, I]           # plan, split ws, its floats, counters,
                                    # their count
        + [I, I, I, I, I, I]        # B, T, C, heads, Tk, ctx_dim
        + [F, F, P]                 # gn_eps, q_scale, stream
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
    """One nvcc per source, all at once, then one link into `out`."""
    out.parent.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=out.parent))
    try:
        nvcc = _nvcc()
        jobs = []
        for src in cu_files:
            obj = work / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        failed = []
        for cmd, _, proc in jobs:
            stdout, stderr = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed (exit {proc.returncode}): "
                              f"{' '.join(cmd)}\n{stdout}\n{stderr}")
        if failed:
            raise RuntimeError("\n".join(failed))
        lib = work / out.name
        cmd = [nvcc, "-shared", "-o", str(lib), *(str(o) for _, o, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed (exit {proc.returncode}): {' '.join(cmd)}"
                f"\n{proc.stdout}\n{proc.stderr}")
        os.replace(lib, out)  # atomic: a concurrent loader sees all or nothing
    finally:
        shutil.rmtree(work, ignore_errors=True)


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


def launch(device, entry: str, what: str, *args) -> None:
    """C entry point `entry`(*args) with `device` (the card of the tensors
    and of the stream in `args`) the current device, raising as `check`
    does where it reports a CUDA error."""
    with torch.cuda.device(device):
        check(getattr(library(), entry)(*args), what)


def check(code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = library().upgpt_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
