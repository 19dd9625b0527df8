"""The program's spans on the device trace (`spans.py`): attribution of
device activities to the launching thread's innermost span, the idle gaps
by span, the four span metrics on synthetic spans and activities (the
`ready_wait` floor, None without spans), and `spanrun.py` on the CPU at
the tiny geometry."""

import os
import subprocess
import sys
import time

import pytest

from portbench import spans, spanrun, spec, trace
from portbench.tests import tiny_cell

MAIN, ENGINE, AUTOGRAD = 0x7F00_0000_1000, 0x7F00_0000_2000, 0x7F00_0000_3000


def _span(id_, name, start, end, parent=0, thread=MAIN, batch=None,
          linked=False, request=None):
    return {"id": id_, "parent": parent, "name": name, "thread": thread,
            "start_ns": start, "end_ns": end, "request": request,
            "batch": batch, "step": None, "linked": linked}


def _recorded(span_list, threads=(MAIN, ENGINE)):
    return {"spans": span_list, "counters": {}, "dropped": 0,
            "threads": {t: f"t{i}" for i, t in enumerate(threads)}}


def _res(thread):
    """Kineto's resource id: the pthread id's low 32 bits, as int32."""
    low = thread & 0xFFFFFFFF
    return low - 2**32 if low >= 2**31 else low


def test_activities_go_to_the_launching_threads_innermost_span():
    rec = _recorded([
        _span(1, "sampler.step", 0, 100),
        _span(2, "unet", 10, 90, parent=1),
        _span(3, "unet.resblock", 20, 40, parent=2),
        _span(4, "engine.collect", 0, 100, thread=ENGINE),
    ])
    device = [
        # (start, end, launch, resource, marker)
        (30, 50, 25, _res(MAIN), False),        # in the resblock
        (55, 60, 45, _res(MAIN), False),        # in unet, after the block
        (61, 70, 50, _res(ENGINE), False),      # the engine's span
        (71, 75, 60, _res(AUTOGRAD), False),    # no spans: innermost of any
        (76, 77, None, None, False),            # no launch found
        (78, 79, 70, _res(MAIN), True),         # the marker: not counted
        (200, 210, 195, _res(MAIN), False),     # outside the window
    ]
    prog = spans.attribute(rec, device, 0, 150, offset=0)
    by_id = {s["id"]: s for s in prog["spans"]}
    assert by_id[3]["device_s"] == pytest.approx(20e-9)
    assert by_id[2]["device_s"] == pytest.approx(20e-9 + 5e-9 + 4e-9)
    assert by_id[1]["device_s"] == pytest.approx(29e-9)
    assert by_id[4]["device_s"] == pytest.approx(9e-9)
    assert by_id[2]["device_end_ns"] == 75
    assert prog["device_s_by_span"] == pytest.approx(
        {"unet.resblock": 20e-9, "unet": 9e-9, "engine.collect": 9e-9})
    assert prog["attributed_events"] == 4
    assert prog["thread_matched_events"] == 3
    assert prog["unmatched_thread_launches"] == 1
    assert prog["launching_thread"] == MAIN


def test_idle_gaps_by_span_sum_to_the_idle_time():
    # in the order they close: a child first, on the ns its parent starts
    rec = _recorded([
        _span(2, "train.forward", 0, 40, parent=1),
        _span(3, "train.backward", 40, 80, parent=1),
        _span(1, "train.step", 0, 100),
    ])
    device = [(0, 10, 0, _res(MAIN), False), (20, 45, 5, _res(MAIN), False),
              (50, 60, 41, _res(MAIN), False)]
    prog = spans.attribute(rec, device, 0, 120, offset=0)
    idle = dict(prog["idle_spans"])
    # gaps 10-20 (forward), 45-50 and 60-120 (backward at their starts)
    assert idle == pytest.approx({"train.forward": 10e-9,
                                  "train.backward": 65e-9})
    assert sum(idle.values()) == pytest.approx(120e-9 - 45e-9)
    prog = spans.attribute(_recorded([]), device, 0, 120, offset=0)
    assert prog["idle_spans"] == [["host", pytest.approx(75e-9)]]


def test_offset_moves_spans_onto_the_device_clock():
    rec = _recorded([_span(1, "sampler.step", 0, 100)])
    prog = spans.attribute(rec, [(1010, 1020, 1005, _res(MAIN), False)],
                           1000, 1200, offset=1000)
    (s,) = prog["spans"]
    assert (s["start_ns"], s["end_ns"]) == (1000, 1100)
    assert s["device_s"] == pytest.approx(10e-9)
    assert spans.host_step_ms(prog) == pytest.approx(100e-6)


def _served(copy_start):
    """One request in batch 0: queued 0-100, dispatched 100-300 (its last
    device activity ends at 500), fenced and copied from `copy_start`."""
    rec = _recorded([
        _span(1, "engine.queue", 0, 100, batch=0, linked=True, request=0),
        _span(2, "engine.dispatch", 100, 300, thread=ENGINE, batch=0),
        _span(3, "engine.deliver", copy_start - 10, copy_start + 50,
              thread=ENGINE, batch=0),
        _span(4, "engine.fence", copy_start - 10, copy_start, parent=3,
              thread=ENGINE, batch=0),
        _span(5, "engine.copy", copy_start, copy_start + 40, parent=3,
              thread=ENGINE, batch=0),
    ])
    device = [(150, 500, 120, _res(ENGINE), False)]
    return spans.attribute(rec, device, 0, 2000, offset=0)


def test_serve_metrics_and_the_ready_wait_floor():
    prog = _served(copy_start=900)
    assert spans.queue_wait_s(prog) == pytest.approx(100e-9)
    assert spans.ready_wait_s(prog) == pytest.approx(400e-9)
    # a copy that starts before the batch's last activity ends: 0, not < 0
    assert spans.ready_wait_s(_served(copy_start=450)) == 0
    line = "\n".join(spans.lines(prog))
    assert "p95 request" in line and "ready wait" in line


def test_opt_ema_per_step():
    rec = _recorded([
        _span(1, "train.step", 0, 100),
        _span(2, "train.optimizer", 50, 80, parent=1),
        _span(3, "train.ema", 80, 90, parent=1),
        _span(4, "train.step", 100, 200),
        _span(5, "train.optimizer", 150, 180, parent=4),
    ])
    device = [(55, 65, 51, _res(MAIN), False), (85, 90, 81, _res(MAIN), False),
              (160, 175, 151, _res(MAIN), False),
              (10, 20, 5, _res(MAIN), False)]
    prog = spans.attribute(rec, device, 0, 300, offset=0)
    assert spans.opt_ema_ms(prog) == pytest.approx(1e3 * 30e-9 / 2)
    # no device activity at all (a CPU run): nothing to read
    assert spans.opt_ema_ms(spans.attribute(rec, [], 0, 300, 0)) is None


def test_no_spans_reads_nothing():
    assert spans.metrics(None) == {}
    empty = spans.attribute(_recorded([]), [], 0, 100, offset=0)
    assert spans.metrics(empty) == {}
    assert spans.lines(None) == ["program: no spans"]


@pytest.mark.parametrize("name, metric", [
    ("interp256_ddim50_b64", "host_step_ms.sample"),
    ("mm512_serve_unipc8", "queue_wait.serve"),
])
def test_spanrun_on_the_tiny_cell(name, metric):
    """The harness's traced run with the recorder on, on the CPU: the span
    metric reads a value, the idle time by span is the idle time by
    range, and the recorder is off again afterwards."""
    from upgpt_torch.utils import diagnostics

    bench = spec.load_benchmark()
    result, lines, _, facts = spanrun.execute(
        bench, tiny_cell(name), 2**31 + 7, 1.5, True, "cpu",
        time.perf_counter())
    assert result["correct"]
    assert result["program"][metric]["value"] > 0
    bd = result["breakdown"]
    assert sum(s for _, s in bd["idle_spans"]) == pytest.approx(
        sum(s for _, s in bd["idle_gaps"]))
    assert any(line.startswith("program:") for line in lines)
    assert facts["program"]["spans"]
    with diagnostics.span("after"):
        pass
    assert diagnostics.drain()["spans"] == []


def test_spanrun_without_a_card_gives_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, os.path.join(spec.HERE, "spanrun.py"), "--workload",
         "interp256_ddim50_b64", "--seed", str(2**31 + 3), "--seconds", "1"],
        capture_output=True, text=True, env=env, cwd=spec.ROOT, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == "" and "CUDA" in proc.stderr


def test_program_spans_read_the_ranges_clock(monkeypatch):
    """A program span inside a harness range reads the same clock: with
    `time.time_ns` replaced by a counter, the range takes the first and
    last readings and the span the two between, so `clock_offset_ns`
    moves both onto the device trace alike."""
    from upgpt_torch.utils import diagnostics

    ticks = iter(range(100, 200))
    monkeypatch.setattr(time, "time_ns", lambda: next(ticks))
    ranges = trace.Ranges()
    diagnostics.start()
    try:
        ranges.enter("window")
        with diagnostics.span("inner"):
            pass
        ranges.leave()
    finally:
        diagnostics.stop()
    (s,) = diagnostics.drain()["spans"]
    assert ranges.spans == [("window", 100, 103)]
    assert (s["start_ns"], s["end_ns"]) == (101, 102)
