"""Run one cell of BENCHMARK.json once, on the card this process is given.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (imports, the card, the program's model built on the card with
weights drawn from the seed, the kernel library's load, the cell's own
shapes warmed) is timed from this file's first statement to the first
timed unit (`setup_s`). The window then runs for `--seconds`; with
`--trace 1` it runs under the profiler and the line reports the cell's
per-layer metrics instead of its end-to-end ones. After the window the
program is freed and the reference checks a seeded sample of what the
window produced. The last lines of standard error give each compared
number beside its limit; the last line of standard output is the result
object. Exits non-zero, with no result, without enough CUDA cards, or
where the process has loaded JAX or the JAX package.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "upgpt_tpu")
# build and kernel caches at fixed paths inside the checkout
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR":
          "torch_extensions", "CUDA_CACHE_PATH": "nv"}


def loaded_forbidden():
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as err:
        return f"nvidia-smi unavailable ({err})"


def set_caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    for var, sub in CACHES.items():
        os.environ[var] = os.path.join(ROOT, ".portbench_cache", sub)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    set_caches()
    sys.path.insert(0, ROOT)
    import torch

    from portbench import harness, spec

    bench = spec.load_benchmark(ROOT)
    cell = spec.cell(bench, args.workload, ROOT)
    need = int(cell["chips"])
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < need:
        print(f"portbench: {args.workload} needs {need} CUDA device(s), "
              f"this process sees {have}; no result", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    print(f"card: {card_line()}", file=sys.stderr, flush=True)
    result, lines, rows, _ = harness.execute(
        bench, cell, args.seed, args.seconds, bool(args.trace), "cuda:0", T0)
    bad = loaded_forbidden()
    if bad:
        print(f"portbench: the process loaded {bad}; no result",
              file=sys.stderr)
        return 3
    for line in lines:
        print(line)
    for name, value, limit in rows:
        print(f"checked {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
