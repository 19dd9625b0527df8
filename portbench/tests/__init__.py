"""CPU tests of the benchmark (`python -m pytest portbench/tests`), and a
cell of BENCHMARK.json run on the CPU at the tiny geometry: the cell's own
traffic file with its sizes cut (batch, steps, rate), its own limits, and
`tiny.json` in place of its configuration."""

import json
import os
import time

import torch

from portbench import harness, spec

HERE = os.path.dirname(os.path.abspath(__file__))
SMALL = {
    "offline": {"batch": 2, "steps": 5, "warm_steps": 2, "check_images": 64},
    "serve": {"batch": 2, "steps": 3, "rate_per_s": 4.0, "check_images": 64},
    "train": {"batch": 2, "reference_rows": 1, "learning_rate": 1e-3},
}


def tiny_cell(name: str) -> dict:
    bench = spec.load_benchmark()
    cell = spec.cell(bench, name)
    with open(os.path.join(HERE, "tiny.json")) as f:
        cell["cfg"] = json.load(f)
    cell["traffic_spec"].update(SMALL[cell["traffic_spec"]["mode"]])
    return cell


def run_tiny(name: str, seconds: float = 1.5, seed: int = 2**31 + 5,
             traced: bool = False):
    """(result, lines, rows, facts) of one CPU run of the tiny cell."""
    torch.set_num_threads(1)
    bench = spec.load_benchmark()
    return harness.execute(bench, tiny_cell(name), seed, seconds, traced,
                           "cpu", time.perf_counter())
