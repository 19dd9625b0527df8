"""The traced window: torch.profiler's device activity over the whole
window, ranges the harness times on the host around the program's
modules, and the reduction from the two to busy time, idle gaps and device
time by layer.

The profiler records device activity only (CUDA activities: kernels,
copies, sets and the runtime calls that launched them). Recording every
host operator as well slowed the offline cell's window to half its
untraced rate (one process on an H100: 26.6 img/s untraced, 13.5 with host
operators from all threads, 17.9 from one, 21.6 device only), so host
ranges are kept by the harness itself.

Ranges are opened from outside the program: a forward pre-hook and a
forward hook on each instance of a layer's module class, and `wrap`
around a bound method, note the host clock (`time.time_ns`) at a call's
entry and exit. Each call also records its analytic work (FLOPs, bytes)
for the layer's roofline. `mark` launches one tiny kernel right after
reading the host clock; its launch in the trace gives the offset between
the host clock and the profiler's.

A device activity belongs to a layer where the runtime call that launched
it (the same CUPTI correlation id) started inside one of the layer's
ranges. One host thread launches the program's work in every cell (the
main thread, or the serving engine's dispatcher), so ranges are matched
by time alone.
"""

from __future__ import annotations

import bisect
import collections
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

MARKER_KERNEL = "spin_kernel"
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_KINDS = ("cuda_runtime", "cuda_driver")


class Ranges:
    """Host-clock ranges around layers, and each call's analytic work."""

    def __init__(self):
        self.calls: Dict[str, List[Tuple[float, float]]] = (
            collections.defaultdict(list))
        self.spans: List[Tuple[str, int, int]] = []
        self.marker_ns: Optional[int] = None
        self._local = threading.local()
        self._handles = []

    def _stack(self):
        if not hasattr(self._local, "stack"):
            self._local.stack = []
        return self._local.stack

    def enter(self, layer: str) -> None:
        self._stack().append((layer, time.time_ns()))

    def leave(self) -> None:
        layer, start = self._stack().pop()
        self.spans.append((layer, start, time.time_ns()))

    def mark(self) -> None:
        """The host clock, then a tiny kernel whose launch the trace
        holds: the two clocks' offset."""
        self.marker_ns = time.time_ns()
        if torch.cuda.is_available():
            torch.cuda._sleep(1000)

    def hook(self, model: torch.nn.Module, class_name: str, layer: str,
             work: Callable) -> int:
        """Range every instance of `class_name` in `model` as `layer`;
        `work(module, args, kwargs)` gives a call's (flops, bytes)."""
        n = 0
        for mod in model.modules():
            if type(mod).__name__ != class_name:
                continue

            def pre(m, args, kwargs, _layer=layer):
                self.calls[_layer].append(work(m, args, kwargs))
                self.enter(_layer)

            def post(m, args, kwargs, out):
                self.leave()

            self._handles.append(mod.register_forward_pre_hook(
                pre, with_kwargs=True))
            self._handles.append(mod.register_forward_hook(
                post, with_kwargs=True))
            n += 1
        return n

    def wrap(self, obj, method: str, layer: str,
             work: Callable = None) -> None:
        """Range `obj.method` (on the instance) as `layer`; `work(*args)`,
        where given, gives a call's (flops, bytes)."""
        inner = getattr(obj, method)

        def wrapped(*args, **kwargs):
            if work is not None:
                self.calls[layer].append(work(*args))
            self.enter(layer)
            try:
                return inner(*args, **kwargs)
            finally:
                self.leave()

        setattr(obj, method, wrapped)

    def remove(self) -> None:
        for h in self._handles:
            h.remove()
        self._handles = []


def profiler():
    """torch.profiler over device activity (and the launching runtime
    calls) only; on a machine without a card, host operators, so that a
    rehearsal runs the same code."""
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CUDA
                               if torch.cuda.is_available()
                               else ProfilerActivity.CPU])


def union_s(spans) -> float:
    """Length of the union of (start, end) ns intervals, in seconds."""
    total, end = 0, None
    for s, e in sorted(spans):
        if end is not None and e <= end:
            continue
        total += e - (s if end is None else max(s, end))
        end = e
    return total / 1e9


def _gaps(spans, lo: int, hi: int):
    """Idle (start, end) ns intervals of [lo, hi] outside the spans."""
    out, cur = [], lo
    for s, e in sorted(spans):
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(a, b) for a, b in out if b > a]


def _innermost(rs, starts, ts) -> Optional[str]:
    """The latest-starting (start, end, name) of `rs` (sorted by start)
    that holds `ts`, looking back over the 64 before it."""
    i = bisect.bisect_right(starts, ts)
    for s, t_end, name in reversed(rs[max(0, i - 64):i]):
        if s <= ts <= t_end:
            return name
    return None


def _kind(e) -> str:
    """The kineto activity type of an event (older torch releases lack
    `activity_type`: then by device, annotation and name)."""
    at = getattr(e, "activity_type", None)
    if at is not None:
        return at()
    on_device = e.device_type() == torch.autograd.DeviceType.CUDA
    if e.is_user_annotation():
        return "gpu_user_annotation" if on_device else "user_annotation"
    if on_device:
        return "kernel"
    if e.name().startswith(("cuda", "cu")):
        return "cuda_runtime"
    return "cpu_op"


def reduce(prof, ranges: Ranges, window: str, layers) -> dict:
    """The window's device busy time, length, top device ops, idle time by
    the harness range the host was in when each gap began, and device
    seconds by layer (see the module docstring)."""
    device, launches = [], {}
    for e in prof.profiler.kineto_results.events():
        kind = _kind(e)
        if kind in DEVICE_KINDS:
            device.append(e)
        elif kind in LAUNCH_KINDS:
            launches[e.correlation_id()] = e.start_ns()

    def launch_of(e) -> Optional[int]:
        # the CUPTI correlation id is the kernel's own on some releases and
        # its linked one on others: take the one whose launch precedes it
        for corr in (e.correlation_id(), e.linked_correlation_id()):
            ts = launches.get(corr)
            if ts is not None and ts <= e.start_ns():
                return ts
        return None

    offset = 0
    marks = [launch_of(e) for e in device if MARKER_KERNEL in e.name()]
    marks = [m for m in marks if m is not None]
    if marks and ranges.marker_ns is not None:
        offset = min(marks, key=lambda m: abs(m - ranges.marker_ns)) - (
            ranges.marker_ns)
    spans = [(name, s + offset, t + offset) for name, s, t in ranges.spans]
    win = [r for r in spans if r[0] == window]
    if not win:
        raise RuntimeError(f"no {window} range was recorded")
    lo, hi = win[0][1], win[0][2]
    inside = [e for e in device if lo <= e.start_ns() < hi
              and MARKER_KERNEL not in e.name()]
    busy = [(max(e.start_ns(), lo), min(e.end_ns(), hi)) for e in device
            if e.end_ns() > lo and e.start_ns() < hi]
    by_name = collections.Counter()
    for e in inside:
        by_name[e.name()] += e.duration_ns() / 1e9
    layer_rs = sorted((s, t, n) for n, s, t in spans if n in layers)
    starts = [r[0] for r in layer_rs]
    coarse = sorted((s, t, n) for n, s, t in spans
                    if n not in layers and n != window)
    layer_s = collections.Counter()
    in_layers = collections.Counter()  # device seconds by name, in a layer
    attributed = 0
    for e in inside:
        ts = launch_of(e)
        if ts is None:
            continue
        attributed += 1
        name = _innermost(layer_rs, starts, ts)
        if name is not None:
            layer_s[name] += e.duration_ns() / 1e9
            in_layers[e.name()] += e.duration_ns() / 1e9
    gap_names = collections.Counter()
    for a, b in _gaps(busy, lo, hi):
        label = _innermost(layer_rs, starts, a)
        if label is None:
            held = [r for r in coarse if r[0] <= a <= r[1]]
            label = held[-1][2] if held else "host"
        gap_names[label] += (b - a) / 1e9
    return {
        "busy_s": union_s(busy), "window_s": (hi - lo) / 1e9,
        "device_ops": [[n[:160], s] for n, s in by_name.most_common(10)],
        "idle_gaps": [[n, s] for n, s in gap_names.most_common(10)],
        "layer_device_s": dict(layer_s),
        "device_events": len(inside),
        # the top ops' seconds in all and inside a layer's ranges
        "top_ops_in_layers": [[n[:70], s, in_layers[n]]
                              for n, s in by_name.most_common(10)],
        "attributed_events": attributed,
        "clock_offset_ns": offset,
    }
