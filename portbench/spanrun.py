"""One traced run of a cell with the program's span recorder on.

    python3 portbench/spanrun.py --workload <name> --seed <n> --seconds <s>

The run is `run.py --trace 1`'s: the same command line, harness,
profiler, ranges, reduction and check. It adds the recorder of
`upgpt_torch.utils.diagnostics`, on from the profiler's start to its end,
and after the window `spans.reduce` puts the program's spans on the device
trace. The lines `spans.lines` gives follow run.py's; the result line adds `program`
(the span metrics, `spans.METRICS`) and `breakdown.idle_spans`. `run.py`
leaves the recorder off, so its runs time nothing more than before. Exits
non-zero, with no result, without enough CUDA cards or where the program
has no recorder.
"""

import time

T0 = time.perf_counter()

import functools  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


class _Recording:
    """A profiler that starts the recorder after itself and stops it
    before itself; anything else is the profiler's."""

    def __init__(self, prof, recorder):
        self.prof, self.recorder = prof, recorder

    def __enter__(self):
        self.prof.__enter__()
        self.recorder.start()
        return self

    def __exit__(self, *exc):
        self.recorder.stop()
        return self.prof.__exit__(*exc)

    def __getattr__(self, name):
        return getattr(self.prof, name)


def execute(bench: dict, cell: dict, seed: int, seconds: float,
            traced: bool, device, t0: float, inner=None):
    """`inner`'s traced run (whatever `traced` says) with the recorder on:
    (result, lines, rows, facts), facts["program"] from `spans.reduce`.
    `inner` is `harness.execute` unless given."""
    from portbench import harness, spans, trace
    from upgpt_torch.utils import diagnostics

    got = {}
    profiler, reduce = trace.profiler, trace.reduce

    def recording_profiler():
        return _Recording(profiler(), diagnostics)

    def reduce_with_spans(prof, ranges, window, layers):
        red = reduce(prof, ranges, window, layers)
        got["program"] = spans.reduce(prof, ranges, window, red,
                                      diagnostics.drain())
        return red

    trace.profiler, trace.reduce = recording_profiler, reduce_with_spans
    try:
        result, lines, rows, facts = (inner or harness.execute)(
            bench, cell, seed, seconds, True, device, t0)
    finally:
        trace.profiler, trace.reduce = profiler, reduce
        diagnostics.stop()
    facts["program"] = program = got["program"]
    result["program"] = spans.metrics(program)
    result["breakdown"]["idle_spans"] = program["idle_spans"]
    return result, lines + spans.lines(program), rows, facts


def main(argv=None) -> int:
    """`run.main(argv + ["--trace", "1"])` with `execute` in the harness's
    place, timed from this file's first statement."""
    sys.path.insert(0, ROOT)
    from portbench import run

    run.set_caches()
    try:
        from upgpt_torch.utils.diagnostics import drain  # noqa: F401
    except ImportError:
        print("spanrun: the program has no span recorder; no result",
              file=sys.stderr)
        return 2
    from portbench import harness

    run.T0 = T0
    harness.execute = functools.partial(execute, inner=harness.execute)
    return run.main(list(sys.argv[1:] if argv is None else argv)
                    + ["--trace", "1"])


if __name__ == "__main__":
    sys.exit(main())
