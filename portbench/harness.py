"""One run of one cell: set-up, the measured window, the check.

`execute` takes the cell (from `spec.cell`), builds the mode that its
traffic file names (`modes/<mode>.py`), times its set-up from `t0`, runs the window (under the profiler,
with the layer ranges, when `trace`), reads the peak device memory, lets
the mode free the program and check what the window produced against
the reference, and returns the result line's object with the lines to
print before it.
"""

from __future__ import annotations

import dataclasses
import importlib
import math
import time
from typing import Dict, List

import torch

from portbench import judge, spec, trace

@dataclasses.dataclass
class Run:
    """What a mode is given, and what it reports back in `facts`."""

    name: str
    cfg: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t0: float
    # also read the control (the reference in the precision below the
    # configuration's) into facts["control"]: for setting limits only
    control: bool = False
    facts: Dict[str, object] = dataclasses.field(default_factory=dict)
    lines: List[str] = dataclasses.field(default_factory=list)
    ranges: "trace.Ranges" = None

    def say(self, line: str) -> None:
        self.lines.append(line)

    def mark(self, phase: str) -> None:
        """The end of a set-up phase, in seconds from the process start."""
        self.facts.setdefault("setup_marks", []).append(
            (phase, time.perf_counter() - self.t0))


def mode(run: Run):
    """The traffic's mode, found by name: `modes/<mode>.py`'s `Mode`."""
    return importlib.import_module(
        f"portbench.modes.{run.traffic['mode']}").Mode(run)


def device_info(dev: torch.device) -> dict:
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": 1,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0}


def execute(bench: dict, cell: dict, seed: int, seconds: float,
            traced: bool, device, t0: float, control: bool = False):
    """(result, lines, rows, facts): the result line's object, the lines
    to print on standard output before it, the compared numbers as (name,
    value, limit) and the run's facts."""
    dev = torch.device(device)
    run = Run(cell["name"], cell["cfg"], cell["traffic_spec"], seed, seconds,
              traced, dev, t0, control)
    drv = mode(run)
    run.mark("imports")
    drv.setup()
    prof = None
    if traced:
        run.ranges = trace.Ranges()
        layers = drv.hook(run.ranges)
        prof = trace.profiler()
        prof.__enter__()
    run.facts["setup_s"] = time.perf_counter() - t0
    run.say("setup: " + ", ".join(f"{p} {t:.3f} s" for p, t in
                                  run.facts["setup_marks"])
            + f", window starts {run.facts['setup_s']:.3f} s")
    if traced:
        run.ranges.enter("window")
        run.ranges.mark()
    try:
        drv.window()
    finally:
        if traced:
            run.ranges.leave()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            prof.__exit__(None, None, None)
    dinfo = device_info(dev)
    if traced:
        red = trace.reduce(prof, run.ranges, "window", layers)
        del prof
        run.ranges.remove()
        run.facts["trace"] = red
        run.facts["layer_calls"] = dict(run.ranges.calls)
        dinfo["busy_s"] = red["busy_s"]
        dinfo["window_s"] = red["window_s"]
        run.say(f"trace: {red['device_events']} device activities in the "
                f"window, {red['attributed_events']} matched to their launch;"
                f" device seconds by layer {red['layer_device_s']}; top "
                f"ops [name, s, s in a layer] {red['top_ops_in_layers']}")
    numbers = drv.check()
    correct, rows = judge.verdict(numbers, cell["limits"])
    metrics_spec = (spec.per_layer(bench, cell["name"]) if traced
                    else spec.end_to_end(bench, cell["name"]))
    if traced:
        metrics = spec.read_metrics(metrics_spec, run.facts)
    else:
        metrics = {m["name"]: {"value": float(run.facts[m["name"]]),
                               "unit": m["unit"]} for m in metrics_spec}
    result = {"correct": bool(correct),
              "attempted": int(run.facts["attempted"]),
              "failed": int(run.facts["failed"]),
              "metrics": metrics, "device": dinfo}
    if traced:
        result["breakdown"] = {"device_ops": run.facts["trace"]["device_ops"],
                               "idle_gaps": run.facts["trace"]["idle_gaps"]}
    result["checked"] = {n: {"value": v if math.isfinite(v) else str(v),
                             "limit": lim} for n, v, lim in rows}
    return result, run.lines, rows, run.facts
