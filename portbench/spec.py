"""BENCHMARK.json and the files it names, found by name.

A cell (`workloads` entry) names a configuration (`configs/<name>.json`
through the configuration's `file`) and a traffic mix
(`traffic/<traffic>.json`); its limits are `limits/<cell>.json`; a
per-layer metric's reader is `metrics/<metric>.py`, whose `read(facts)`
returns the value or None.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(bench: dict, name: str, root: str = ROOT) -> dict:
    """The cell's entry with its configuration, traffic and limits read."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; have {sorted(cells)}")
    w = dict(cells[name])
    configs = {c["name"]: c for c in bench["configs"]}
    w["cfg"] = _json(os.path.join(root, configs[w["config"]]["file"]))
    w["traffic_spec"] = _json(os.path.join(HERE, "traffic",
                                           f"{w['traffic']}.json"))
    w["limits"] = _json(os.path.join(HERE, "limits", f"{name}.json"))["numbers"]
    return w


def applies(metric: dict, cell_name: str, reported: List[str]) -> bool:
    """Whether a metric belongs to a cell: its `workloads` list, else (a
    per-layer metric) every cell that reports the metric it moves."""
    if "workloads" in metric:
        return cell_name in metric["workloads"]
    return metric.get("moves") is None or metric["moves"] in reported


def end_to_end(bench: dict, cell_name: str) -> List[dict]:
    return [m for m in bench["end_to_end"] if applies(m, cell_name, [])]


def per_layer(bench: dict, cell_name: str) -> List[dict]:
    reported = [m["name"] for m in end_to_end(bench, cell_name)]
    return [m for m in bench["per_layer"] if applies(m, cell_name, reported)]


def reader(metric_name: str):
    """`read(facts)` of metrics/<metric_name>.py."""
    path = os.path.join(HERE, "metrics", f"{metric_name}.py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric_name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(metrics: List[dict], facts: dict) -> Dict[str, dict]:
    out = {}
    for m in metrics:
        value: Optional[float] = reader(m["name"])(facts)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
