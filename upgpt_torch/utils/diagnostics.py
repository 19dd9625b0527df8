"""Spans and counters, memory stats, kernel launch counts and NaN guards.

The port's counterpart of `upgpt_tpu.utils.diagnostics` (the reference's
observability is a Lightning profiler summary and a commented-out
CUDACallback, main.py:453-473,818):

- the span recorder: one in-memory recorder per process, off by default.
  `span(name, ...)` times a block on the host (`with span("unet"): ...`);
  `begin` / `end` time an interval that starts on one thread and ends on
  another (a request's wait in the serving engine); `count` keeps
  counters. `start()` turns the recorder on, `stop()` off, and `drain()`
  hands over what it holds. Off, a span site costs one module-global
  check and returns one shared no-op object: no allocation, no clock, no
  tensor work and no sync, so it is safe inside a CUDA-graph capture.
  On, a span records its name, start and end, its own id, its parent
  (the span enclosing it on the same thread), its thread
  (`threading.get_ident()`) and optional `batch` and `step` ids, an id
  it is not given being its parent's; a linked span records a `request`
  id from `begin` and a `batch` id from `end`. The buffer holds at
  most `limit` spans and counts the ones it drops.
- `kernel_launches`: the kernel wrappers' launch counters, by kernel and
  by the routes away from one; `launch_state`, `launch_increase` and
  `add_launches` let a CUDA graph's replay count what its capture did.
- `device_memory_stats`: per-card memory from `torch.cuda.memory_stats`
  (the trainer's SIGUSR2 handler prints it).
- `nan_guard`: raises on a non-finite floating tensor (the reference's
  `assert not torch.isnan(...)`, ddpm.py:177). It reads the tensors on
  the host, a sync: call it where the host needs the answer.
- `count_params` and `cast_floating` (bf16 weights for serving).

Clock: spans read `time.time_ns()`, the host clock the benchmark's
ranges read (`portbench/trace.py`, `Ranges`). The offset that the
benchmark's marker kernel gives between that clock and the profiler's
(`clock_offset_ns`) therefore places these spans on the device trace's
timeline unchanged, and a span's thread is the one whose launches the
trace attributes to it (kineto keeps the low 32 bits of the launching
thread's pthread id, which `threading.get_ident()` is).
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, Iterable, Optional, Union

import torch

# ----------------------------------------------------------- span recorder

_on = False  # the one check a span site makes
_limit = 0
_spans: list = []  # recorded span tuples (see `_fields`)
_dropped = 0
_counters: Dict[str, int] = {}
_threads: Dict[int, str] = {}  # get_ident -> the thread's name
_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()
_fields = ("id", "parent", "name", "thread", "start_ns", "end_ns",
           "request", "batch", "step", "linked")


def _stack() -> list:
    """This thread's open spans, innermost last."""
    try:
        return _local.stack
    except AttributeError:
        _threads[threading.get_ident()] = threading.current_thread().name
        _local.stack = []
        return _local.stack


def _record(rec: tuple) -> None:
    global _dropped
    with _lock:
        if len(_spans) < _limit:
            _spans.append(rec)
        else:
            _dropped += 1


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "batch", "step", "id", "parent", "start")

    def __init__(self, name, batch, step):
        self.name, self.batch, self.step = name, batch, step

    def __enter__(self):
        stack = _stack()
        self.parent = 0
        if stack:
            up = stack[-1]
            self.parent = up.id
            if self.batch is None:
                self.batch = up.batch
            if self.step is None:
                self.step = up.step
        self.id = next(_ids)
        stack.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end_ns = time.time_ns()
        _stack().pop()
        if _on:
            _record((self.id, self.parent, self.name, threading.get_ident(),
                     self.start, end_ns, None, self.batch, self.step, False))
        return False


def span(name: str, batch: Optional[int] = None, step: Optional[int] = None):
    """A context manager that records the block as span `name` while the
    recorder is on; a shared no-op while it is off."""
    if not _on:
        return _NO_SPAN
    return _Span(name, batch, step)


class _Link:
    __slots__ = ("name", "id", "thread", "start", "request")


def begin(name: str, request: Optional[int] = None):
    """Open a linked span, which `end(token)` closes on any thread; its
    thread is the one that began it. None while the recorder is off."""
    if not _on:
        return None
    _stack()  # names this thread in `drain()`'s threads
    link = _Link()
    link.name, link.request = name, request
    link.id = next(_ids)
    link.thread = threading.get_ident()
    link.start = time.time_ns()
    return link


def end(token, batch: Optional[int] = None) -> None:
    """Close a linked span from `begin`, with the batch id given here."""
    if token is None or not _on:
        return
    end_ns = time.time_ns()
    _record((token.id, 0, token.name, token.thread, token.start, end_ns,
             token.request, batch, None, True))


def count(name: str, n: int = 1) -> None:
    """Add `n` to counter `name` while the recorder is on."""
    if not _on:
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def start(limit: int = 1_000_000) -> None:
    """Empty the recorder and turn it on; it keeps at most `limit` spans."""
    global _on, _limit, _dropped
    with _lock:
        _spans.clear()
        _counters.clear()
        _dropped = 0
        _limit = int(limit)
        _on = True


def stop() -> None:
    """Turn the recorder off; spans still open are not recorded."""
    global _on
    _on = False


def drain() -> dict:
    """What the recorder holds, which it then forgets: `spans` (dicts of
    `_fields`, in the order they closed), `counters`, `dropped` (spans
    past the limit) and `threads` ({thread: its name})."""
    global _dropped
    with _lock:
        out = {"spans": [dict(zip(_fields, r)) for r in _spans],
               "counters": dict(_counters), "dropped": _dropped,
               "threads": dict(_threads)}
        _spans.clear()
        _counters.clear()
        _dropped = 0
    return out


def _launch_counters():
    """(name, wrapper, attribute) of every count `kernel_launches` gives,
    and the wrappers that also count their launches by shape
    (`launches_by_shape`)."""
    from upgpt_torch.ops import flash_attention as fa
    from upgpt_torch.ops import fused_gn as fg
    from upgpt_torch.ops import fused_resblock as frb
    from upgpt_torch.ops import fused_transformer as ft
    from upgpt_torch.ops import selfattn_leg as sl

    counts = (
        ("fused_transformer_block", ft.fused_transformer_block, "launches"),
        ("flash_attention", fa.flash_attention, "launches"),
        ("flash_backward_dq", fa.flash_backward_dq, "launches"),
        ("flash_backward_dkv", fa.flash_backward_dkv, "launches"),
        ("fused_group_norm", fg.fused_group_norm, "launches"),
        ("tiled_group_norm", fg.tiled_group_norm, "launches"),
        ("fused_resblock", frb.fused_gn_silu_conv, "launches"),
        ("selfattn_fullwidth", sl.selfattn_fullwidth, "launches"),
        ("selfattn_perhead", sl.selfattn_perhead, "launches"),
        ("flash_attention_fma", fa.flash_attention, "fma_launches"),
        ("flash_backward_dq_fma", fa.flash_backward_dq, "fma_launches"),
        ("flash_backward_dkv_fma", fa.flash_backward_dkv, "fma_launches"),
        ("flash_reference_backwards", fa.flash_attention,
         "reference_backwards"),
        ("fused_group_norm_plain_routes", fg.fused_group_norm,
         "plain_routes"),
        ("fused_resblock_plain_routes", frb.fused_gn_silu_conv,
         "plain_routes"),
        ("fused_resblock_fp32", frb.fused_gn_silu_conv, "fp32_launches"),
    )
    return counts, (fg.fused_group_norm, fg.tiled_group_norm,
                    frb.fused_gn_silu_conv)


def kernel_launches() -> Dict[str, int]:
    """Each hand-written kernel's launches since its counter was last
    reset (a process starts at 0), and the counted routes away from the
    kernels: the flash kernels' FMA instantiations, the flash backward's
    plain autograd, the GroupNorm and half-step gates' plain routes and
    the half-step kernel's float32 instantiation."""
    counts, _ = _launch_counters()
    return {name: getattr(fn, attr) for name, fn, attr in counts}


def launch_state() -> Dict[tuple, int]:
    """Every launch counter the kernel wrappers keep, as {(wrapper,
    attribute, shape): count}: `kernel_launches`'s counts (shape None)
    and the per-shape counts (attribute `launches_by_shape`)."""
    counts, by_shape = _launch_counters()
    state = {(fn, attr, None): getattr(fn, attr) for _, fn, attr in counts}
    for fn in by_shape:
        for shape, n in fn.launches_by_shape.items():
            state[(fn, "launches_by_shape", shape)] = n
    return state


def launch_increase(before: Dict[tuple, int], after: Dict[tuple, int]
                    ) -> tuple:
    """The counters that rose from `before` to `after` (two
    `launch_state`s), as ((wrapper, attribute, shape, increase), ...)."""
    return tuple((*key, n - before.get(key, 0)) for key, n in after.items()
                 if n != before.get(key, 0))


def add_launches(increase) -> None:
    """Add a `launch_increase` to the counters: what a CUDA graph replay
    launches without running the wrappers that count."""
    for fn, attr, shape, n in increase:
        if shape is None:
            setattr(fn, attr, getattr(fn, attr) + n)
        else:
            counts = getattr(fn, attr)
            counts[shape] = counts.get(shape, 0) + n


def device_memory_stats() -> Dict[str, Dict[str, float]]:
    """Memory of each CUDA card, in MB: in use, peak and the card's total.
    Empty without a card."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use_mb": stats.get("allocated_bytes.all.current", 0)
            / 1e6,
            "peak_bytes_mb": stats.get("allocated_bytes.all.peak", 0) / 1e6,
            "bytes_limit_mb": torch.cuda.get_device_properties(i).total_memory
            / 1e6,
        }
    return out


def _tensors(tree) -> Iterable[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def nan_guard(tree, name: str = "tree") -> bool:
    """True if every floating tensor in `tree` (a tensor, or dicts, lists
    and tuples of them) is finite; raises FloatingPointError otherwise."""
    for t in _tensors(tree):
        if t.is_floating_point() and not bool(torch.isfinite(t).all()):
            raise FloatingPointError(f"non-finite values in {name}")
    return True


def count_params(tree: Union[torch.nn.Module, dict, list],
                 verbose: bool = False) -> int:
    """Elements of a module's parameters, or of the tensors in a tree."""
    tensors = (tree.parameters() if isinstance(tree, torch.nn.Module)
               else _tensors(tree))
    n = sum(t.numel() for t in tensors)
    if verbose:
        print(f"{n * 1e-6:.2f} M parameters")
    return n


def cast_floating(module: torch.nn.Module, dtype: torch.dtype
                  ) -> torch.nn.Module:
    """Cast the floating parameters of `module` to `dtype` in place (bf16
    for serving: half the weight traffic)."""
    for p in module.parameters():
        if p.is_floating_point():
            p.data = p.data.to(dtype)
    return module
