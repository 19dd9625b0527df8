"""BENCHMARK.json's names, units, cells and metrics, and the files each
entry names."""

import json
import os
import re

import pytest

from portbench import spec

ROOT = spec.ROOT
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_.%/-]{1,16}")


@pytest.fixture(scope="module")
def bench():
    return spec.load_benchmark()


def test_names_and_units(bench):
    names = ([c["name"] for c in bench["configs"]]
             + [w["name"] for w in bench["workloads"]]
             + [m["name"] for m in bench["end_to_end"] + bench["per_layer"]])
    names += [w["traffic"] for w in bench["workloads"]]
    names += [k for c in bench["configs"] for k in c["reduced"]]
    for n in names:
        assert NAME.fullmatch(n), n
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.fullmatch(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        seen = [x["name"] for x in bench[group]]
        assert len(seen) == len(set(seen)), group


def test_cells_resolve(bench):
    configs = {c["name"] for c in bench["configs"]}
    for w in bench["workloads"]:
        assert w["config"] in configs
        cell = spec.cell(bench, w["name"])
        assert cell["traffic_spec"]["mode"] in ("offline", "serve", "train")
        assert cell["limits"]
        assert w["chips"] in (1, 4)
    for c in bench["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert c["file"].startswith(tuple(p + "/" for p in bench["paths"]))


def test_metrics_belong_to_cells_that_report_what_they_move(bench):
    cells = {w["name"] for w in bench["workloads"]}
    for w in cells:
        e2e = [m["name"] for m in spec.end_to_end(bench, w)]
        assert "setup_s" in e2e and len(e2e) >= 2, w
        assert spec.per_layer(bench, w), w
    for m in bench["per_layer"]:
        assert os.path.isfile(os.path.join(spec.HERE, "metrics",
                                           m["name"] + ".py")), m["name"]
        for w in m.get("workloads", []):
            assert w in cells
            assert m["moves"] in [x["name"] for x in
                                  spec.end_to_end(bench, w)], (m, w)
    for m in bench["end_to_end"]:
        assert 0 < m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_command_and_paths(bench):
    assert bench["command"] == ["python3", "portbench/run.py"]
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) < 64 * 1024
