"""Readings for setting a cell's limits and for sizing its traffic; not
run by the benchmark's own runs.

    python3 portbench/calibrate.py --workload <name> --seeds 11 12 13 \
        --seconds 10 [--trace 1] [--control 1] [--set rate_per_s=12] \
        [--fault ema_skipped]

Runs the cell once a seed in one process (the kernel library and the card
initialised once), each run as `run.py` runs it, and prints one JSON line
a run: the compared numbers of the program against the reference, with
`--control 1` the control's (the reference computed in float8 e4m3
against the float32 reference, on the same inputs), the end-to-end and
per-layer facts, and the lines the run printed. `--set key=value`
overrides a traffic parameter, for a sweep of the served rate. `--fault`
plants one of `FAULTS` in the program, for a fault's reading on the card.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# name: (module, attribute, replacement) planted under the timed path
FAULTS = {
    # the train step leaves the EMA shadow unchanged
    "ema_skipped": ("upgpt_torch.training.train_state", "ema_update",
                    lambda state, params: state),
}


def _value(text: str):
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        return text


def _clean(x):
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    if isinstance(x, dict):
        return {k: _clean(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_clean(v) for v in x]
    return x


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--control", type=int, default=0)
    p.add_argument("--set", nargs="*", default=[])
    p.add_argument("--fault", choices=sorted(FAULTS))
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    from portbench.run import set_caches

    set_caches()
    import torch

    from portbench import harness, spec

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    if args.fault:
        import importlib

        module, attr, planted = FAULTS[args.fault]
        setattr(importlib.import_module(module), attr, planted)
    bench = spec.load_benchmark(ROOT)
    cell = spec.cell(bench, args.workload, ROOT)
    for kv in args.set:
        key, val = kv.split("=", 1)
        cell["traffic_spec"][key] = _value(val)
    t0 = T0
    for seed in args.seeds:
        torch.cuda.reset_peak_memory_stats()
        result, lines, rows, facts = harness.execute(
            bench, cell, seed, args.seconds, bool(args.trace), "cuda:0", t0,
            control=bool(args.control))
        keep = {k: v for k, v in facts.items()
                if k not in ("trace", "layer_calls")}
        print(json.dumps(_clean({
            "workload": args.workload, "seed": seed, "fault": args.fault,
            "traffic": cell[
                "traffic_spec"], "numbers": {n: v for n, v, _ in rows},
            "control": facts.get("control"), "facts": keep,
            "result": result, "lines": lines})), flush=True)
        t0 = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
