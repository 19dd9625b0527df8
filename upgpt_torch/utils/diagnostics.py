"""Tracing, profiling, memory stats and NaN guards.

The port's counterpart of `upgpt_tpu.utils.diagnostics` (the reference's
observability is a Lightning profiler summary and a commented-out
CUDACallback, main.py:453-473,818):

- `profile_trace`: `torch.profiler` around a phase, host and device
  activity, written as a Chrome trace.
- `PhaseTimer`: wall-clock phase accounting (data / step / eval / ckpt).
- `device_memory_stats`: per-card memory from `torch.cuda.memory_stats`
  (the trainer's SIGUSR2 handler prints it).
- `nan_guard`: raises on a non-finite floating tensor (the reference's
  `assert not torch.isnan(...)`, ddpm.py:177). It reads the tensors on
  the host, a sync: call it where the host needs the answer.
- `count_params` and `cast_floating` (bf16 weights for serving).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterable, Union

import torch


@contextlib.contextmanager
def profile_trace(logdir: str, name: str = "trace"):
    """Profile the block's host and device activity into
    `<logdir>/<name>.json` (chrome://tracing or Perfetto); yields the
    profiler for `key_averages()`."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    Path(logdir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(Path(logdir) / f"{name}.json"))


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


class PhaseTimer:
    """Accumulating wall-clock phase timer; .summary() like a profiler dump."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> str:
        lines = ["phase                 total_s    calls   mean_ms"]
        for name, tot in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:<20} {tot:8.2f} {n:8d} {tot / n * 1e3:9.2f}")
        return "\n".join(lines)


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
