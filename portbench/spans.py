"""The program's own spans on the device trace.

The port records spans at its layer boundaries (`upgpt_torch/utils/
diagnostics.py`: the serving engine's request and batch life, the
sampler's steps, the U-Net and VAE layers, the train step's phases) on
the host clock that `trace.Ranges` reads, so `trace.reduce`'s
`clock_offset_ns` moves them onto the profiler's clock unchanged. Here:

- each device activity of the window belongs to the innermost span open
  on the thread that launched it, when the launch began (its runtime call,
  found by CUPTI correlation id as `trace.reduce` finds it). Kineto names
  that thread by the low 32 bits of its pthread id, which is the span's
  `thread`. A launch that reads later than its kernel's start (up to
  ~0.15 ms on an H100, where the kernel starts on an idle card) still
  counts, which `trace.reduce` does not. A launch from a thread with no
  span open (the autograd engine's device thread runs a CUDA backward)
  belongs to the innermost span open on any thread then;
- a span's `device_s` and `device_end_ns` are the device seconds and the
  last end of the activities launched inside it or its descendants;
- each idle gap of the window (`trace._gaps` over the same busy time as
  `idle_gaps`) is labelled by the innermost span open at its start on the
  launching thread, the thread that launched most of the window's device
  work (the main thread, or the serving engine's dispatcher), and `host`
  where none is open: `idle_spans`, which sums to the window's idle time;
- the span metrics (`METRICS`) and the lines a run prints.

`reduce` returns `facts["program"]`; every metric reads None where the run
has nothing to read (no spans, or no device activity where it needs one).
"""

from __future__ import annotations

import bisect
import collections
import math
from typing import Dict, List, Optional

from portbench import trace

LOW32 = 0xFFFFFFFF
TRAIN_PHASES = ("train.forward", "train.backward", "train.grad_norm",
                "train.optimizer", "train.ema")


def activities(prof):
    """The trace's device activities as (start_ns, end_ns, launch_ns or
    None, launching thread's resource id or None, is_marker), on the
    profiler's clock."""
    device, launches = [], {}
    for e in prof.profiler.kineto_results.events():
        kind = trace._kind(e)
        if kind in trace.DEVICE_KINDS:
            device.append(e)
        elif kind in trace.LAUNCH_KINDS:
            launches[e.correlation_id()] = (e.start_ns(),
                                            e.device_resource_id())
    out = []
    for e in device:
        # the correlation id is the kernel's own on some releases and its
        # linked one on others: take the one whose launch precedes it, else
        # the one there is (a kernel that starts on an idle card can read
        # up to ~0.15 ms before its launch: the two clocks' skew)
        got = [launches[c] for c in (e.correlation_id(),
                                     e.linked_correlation_id())
               if c in launches]
        launch = next((g for g in got if g[0] <= e.start_ns()),
                      got[0] if got else (None, None))
        out.append((e.start_ns(), e.end_ns(), launch[0], launch[1],
                    trace.MARKER_KERNEL in e.name()))
    return out


class _Index:
    """Innermost-span lookup per thread over properly nested spans: the
    latest-starting span at or before a time, then up its parents to the
    first that holds the time."""

    def __init__(self, spans: List[dict]):
        self.by_id = {s["id"]: s for s in spans}
        per = collections.defaultdict(list)
        for s in spans:
            if not s["linked"]:
                per[s["thread"]].append(s)
        # a parent that starts on the same ns as its child sorts first
        self.rows = {t: sorted(v, key=lambda s: (s["start_ns"], s["id"]))
                     for t, v in per.items()}
        self.starts = {t: [s["start_ns"] for s in v]
                       for t, v in self.rows.items()}

    def innermost(self, thread, ts: int) -> Optional[dict]:
        rows = self.rows.get(thread)
        if not rows:
            return None
        i = bisect.bisect_right(self.starts[thread], ts) - 1
        s = rows[i] if i >= 0 else None
        while s is not None and not s["start_ns"] <= ts <= s["end_ns"]:
            s = self.by_id.get(s["parent"])
        return s

    def innermost_any(self, ts: int) -> Optional[dict]:
        held = [s for s in (self.innermost(t, ts) for t in self.rows) if s]
        return max(held, key=lambda s: s["start_ns"]) if held else None


def _thread_map(resources, threads) -> Dict[int, int]:
    """Kineto resource id -> the recorder's thread (the low 32 bits of
    its pthread id)."""
    low = {t & LOW32: t for t in threads}
    return {r: low[r & LOW32] for r in resources
            if r is not None and r & LOW32 in low}


def attribute(recorded: dict, device, lo: int, hi: int,
              offset: int) -> dict:
    """`facts["program"]` from the recorder's `drain()` and `activities`
    of the window [lo, hi] (profiler clock; `offset` adds to a span's host
    time)."""
    spans = [dict(s, start_ns=s["start_ns"] + offset,
                  end_ns=s["end_ns"] + offset, device_s=0.0,
                  device_end_ns=None) for s in recorded["spans"]]
    index = _Index(spans)
    threads = recorded["threads"]
    tmap = _thread_map({a[3] for a in device}, threads)
    by_name = collections.Counter()
    launched_by = collections.Counter()
    attributed = matched = 0
    outside = 0.0
    for start, end, launch, res, marker in device:
        if marker or not lo <= start < hi or launch is None:
            continue
        attributed += 1
        thread = tmap.get(res)
        launched_by[thread] += 1
        s = index.innermost(thread, launch)
        if s is not None:
            matched += 1
        else:
            s = index.innermost_any(launch)
        dur = (end - start) / 1e9
        if s is None:
            outside += dur
            continue
        by_name[s["name"]] += dur
        while s is not None:
            s["device_s"] += dur
            if s["device_end_ns"] is None or end > s["device_end_ns"]:
                s["device_end_ns"] = end
            s = index.by_id.get(s["parent"])
    # the thread whose spans the gaps read: the one with spans that
    # launched most, else the one with most spans
    main = max(index.rows, default=None,
               key=lambda t: (launched_by.get(t, 0), len(index.rows[t])))
    busy = [(max(a[0], lo), min(a[1], hi)) for a in device
            if a[1] > lo and a[0] < hi]
    idle = collections.Counter()
    for a, b in trace._gaps(busy, lo, hi):
        s = index.innermost(main, a)
        idle[s["name"] if s else "host"] += (b - a) / 1e9
    return {
        "spans": spans, "window_ns": [lo, hi],
        "threads": {t: {"name": name, "launches": launched_by.get(t, 0)}
                    for t, name in threads.items()},
        # launches from a thread the recorder never saw
        "unmatched_thread_launches": launched_by.get(None, 0),
        "launching_thread": main,
        "counters": recorded["counters"],
        "dropped": recorded["dropped"],
        "attributed_events": attributed,
        "thread_matched_events": matched,
        "device_s_by_span": dict(by_name.most_common()),
        "device_s_outside_spans": outside,
        "idle_spans": [[n, s] for n, s in idle.most_common()],
    }


def reduce(prof, ranges: "trace.Ranges", window: str, red: dict,
           recorded: dict) -> dict:
    """`attribute` over a traced run: the profiler, the harness's ranges,
    the name of the window's range and `trace.reduce`'s result."""
    offset = red["clock_offset_ns"]
    (lo, hi), = [(s + offset, t + offset) for n, s, t in ranges.spans
                 if n == window]
    return attribute(recorded, activities(prof), lo, hi, offset)


# ------------------------------------------------------------- metrics


def _window(program: Optional[dict], name: str) -> List[dict]:
    """The spans called `name` that start in the window."""
    if not program:
        return []
    lo, hi = program["window_ns"]
    return [s for s in program["spans"]
            if s["name"] == name and lo <= s["start_ns"] < hi]


def _dur(s: dict) -> float:
    return (s["end_ns"] - s["start_ns"]) / 1e9


def _mean(xs) -> Optional[float]:
    xs = list(xs)
    return sum(xs) / len(xs) if xs else None


def _per_batch(program: dict, name: str) -> Dict[int, dict]:
    return {s["batch"]: s for s in program["spans"] if s["name"] == name}


def host_step_ms(program: Optional[dict]) -> Optional[float]:
    """Mean host duration of the window's `sampler.step` spans, in ms."""
    got = _mean(_dur(s) for s in _window(program, "sampler.step"))
    return None if got is None else 1e3 * got


def queue_wait_s(program: Optional[dict]) -> Optional[float]:
    """Mean `engine.queue` of the requests that entered in the window and
    whose batch was delivered, in s."""
    if not program:
        return None
    delivered = set(_per_batch(program, "engine.deliver"))
    return _mean(_dur(s) for s in _window(program, "engine.queue")
                 if s["batch"] in delivered)


def ready_wait_s(program: Optional[dict]) -> Optional[float]:
    """Mean over the window's batches of the start of the batch's
    `engine.copy` less the end of the last device activity launched
    inside its `engine.dispatch`, floored at 0, in s: how long finished
    images sat on the card."""
    if not program:
        return None
    copies = _per_batch(program, "engine.copy")
    return _mean(max(0, copies[s["batch"]]["start_ns"]
                     - s["device_end_ns"]) / 1e9
                 for s in _window(program, "engine.dispatch")
                 if s["batch"] in copies and s["device_end_ns"] is not None)


def opt_ema_ms(program: Optional[dict]) -> Optional[float]:
    """Device ms per window step of the activities launched inside
    `train.optimizer` and `train.ema`."""
    steps = _window(program, "train.step")
    if not steps or not program["attributed_events"]:
        return None
    dev = sum(s["device_s"] for name in ("train.optimizer", "train.ema")
              for s in _window(program, name))
    return 1e3 * dev / len(steps)


METRICS = {"host_step_ms.sample": (host_step_ms, "ms"),
           "queue_wait.serve": (queue_wait_s, "s"),
           "ready_wait.serve": (ready_wait_s, "s"),
           "opt_ema_ms.train": (opt_ema_ms, "ms")}


def metrics(program: Optional[dict]) -> Dict[str, dict]:
    """Each span metric the run has something to read for, as a result
    line's metrics: {name: {value, unit}}."""
    out = {}
    for name, (fn, unit) in METRICS.items():
        value = fn(program)
        if value is not None:
            out[name] = {"value": value, "unit": unit}
    return out


# --------------------------------------------------------------- lines


def _r(x: float, n: int = 4) -> float:
    return round(x, n)


def _step_line(program: dict) -> Optional[str]:
    steps = _window(program, "sampler.step")
    if not steps:
        return None
    unet = collections.defaultdict(float)
    for s in _window(program, "unet"):
        unet[s["parent"]] += _dur(s)
    return (f"program sampler steps: {len(steps)}, host ms a step "
            f"{_r(1e3 * _mean(_dur(s) for s in steps))}, of it outside "
            f"`unet` {_r(1e3 * _mean(_dur(s) - unet[s['id']] for s in steps))}"
            f"; device busy ms a step "
            f"{_r(1e3 * _mean(s['device_s'] for s in steps))}")


def _serve_line(program: dict) -> Optional[str]:
    parts = {n: _per_batch(program, f"engine.{n}") for n in
             ("dispatch", "fence", "copy", "deliver")}
    rows = []
    for q in _window(program, "engine.queue"):
        b = q["batch"]
        if not all(b in p for p in parts.values()):
            continue
        d, f, c = parts["dispatch"][b], parts["fence"][b], parts["copy"][b]
        rows.append((parts["deliver"][b]["end_ns"] - q["start_ns"],
                     {"queue": _dur(q), "dispatch": _dur(d),
                      "behind": (f["start_ns"] - d["end_ns"]) / 1e9,
                      "fence": _dur(f), "copy": _dur(c)}))
    if not rows:
        return None
    rows.sort(key=lambda r: r[0])
    total, split = rows[max(0, math.ceil(0.95 * len(rows)) - 1)]
    mean = {k: _r(_mean(r[1][k] for r in rows)) for k in split}
    return (f"program serve: {len(rows)} requests; p95 request "
            f"{_r(total / 1e9)} s = queue, dispatch, behind later "
            f"dispatches, fence, copy {[_r(v) for v in split.values()]} s; "
            f"mean of each {mean}; ready wait (mean over batches) "
            f"{ready_wait_s(program)} s")


def _train_line(program: dict) -> Optional[str]:
    steps = _window(program, "train.step")
    if not steps:
        return None
    host = {n.split(".")[1]: _r(1e3 * sum(_dur(s) for s in
                                          _window(program, n)) / len(steps))
            for n in ("train.step",) + TRAIN_PHASES}
    dev = {n.split(".")[1]: _r(1e3 * sum(s["device_s"] for s in
                                         _window(program, n)) / len(steps))
           for n in ("train.step",) + TRAIN_PHASES}
    return (f"program train: {len(steps)} steps; host ms a step by phase "
            f"{host}; device ms a step by phase {dev}")


def lines(program: Optional[dict]) -> List[str]:
    """What a run prints of its spans."""
    if not program:
        return ["program: no spans"]
    launches = {v["name"]: v["launches"]
                for v in program["threads"].values()}
    by_span = {n: _r(s) for n, s in program["device_s_by_span"].items()}
    out = [f"program: {len(program['spans'])} spans ({program['dropped']} "
           f"dropped); launches in the window by thread {launches}, "
           f"{program['unmatched_thread_launches']} from threads without "
           f"spans; {program['attributed_events']} device activities "
           f"matched to a launch, {program['thread_matched_events']} to a "
           f"span of the launching thread; device s outside any span "
           f"{_r(program['device_s_outside_spans'])}; device s by innermost "
           f"span {by_span}; counters {program['counters']}"]
    out += [x for x in (_step_line(program), _serve_line(program),
                        _train_line(program)) if x]
    out.append(f"program idle by span "
               f"{[[n, _r(s)] for n, s in program['idle_spans']]}")
    return out
