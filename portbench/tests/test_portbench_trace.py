"""The trace arithmetic: the union of device intervals and the idle gaps
between them."""

import pytest

from portbench import trace


def test_union_and_gaps():
    spans = [(0, 10), (5, 20), (30, 40), (35, 38)]
    assert trace.union_s(spans) == pytest.approx(30e-9)
    assert trace._gaps(spans, 0, 50) == [(20, 30), (40, 50)]
    assert trace._gaps(spans, -5, 15) == [(-5, 0)]


def test_innermost_range():
    rs = [(0, 100, "batch"), (10, 20, "xformer"), (30, 40, "resblock")]
    starts = [r[0] for r in rs]
    assert trace._innermost(rs, starts, 15) == "xformer"
    assert trace._innermost(rs, starts, 25) == "batch"
    assert trace._innermost(rs, starts, 200) is None
