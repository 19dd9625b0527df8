"""The control comes out not correct: the reference computed with float8
e4m3 products, put in the program's place, judged by each cell's own
limits, at the tiny geometry on the CPU (on the card it was read at each
cell's own size: PERF.md)."""

import time

import pytest

from portbench import harness, judge, spec
from portbench.tests import tiny_cell


@pytest.mark.parametrize("cell", ["interp256_ddim50_b64",
                                  "mm512_serve_unipc8",
                                  "interp256_train_b48"])
def test_control_fails_the_limits(cell):
    c = tiny_cell(cell)
    _, _, _, facts = harness.execute(spec.load_benchmark(), c, 2**31 + 11,
                                     1.0, False, "cpu", time.perf_counter(),
                                     control=True)
    ok, rows = judge.verdict(facts["control"], c["limits"])
    assert not ok, rows
