"""BENCHMARK.json against the rules of its contract that a file can be
checked for, and every file it names found."""

import json
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
LINE = re.compile(r"[^\t\n]{1,200}")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["rtbench"]
    assert 1 <= bench["run_seconds"] <= 51
    assert all(LINE.fullmatch(w) for w in bench["command"])


def test_names_and_units(bench):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in bench[group]:
            assert NAME.fullmatch(entry["name"]), entry["name"]
            names.append((group in ("end_to_end", "per_layer"),
                          entry["name"]))
            if "unit" in entry:
                assert UNIT.fullmatch(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in entry:
                    assert LINE.fullmatch(entry[key]), entry[key]
    assert len(names) == len(set(names))
    metrics = [n for is_metric, n in names if is_metric]
    assert len(metrics) == len(set(metrics))


def test_cells_find_their_files(bench):
    from rtbench import cells
    here = os.path.join(ROOT, "rtbench")
    configs = {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert c["file"].startswith("rtbench/")
    for w in bench["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.fullmatch(w["traffic"])
        assert os.path.exists(os.path.join(here, "traffic",
                                           w["traffic"] + ".json"))
        assert os.path.exists(os.path.join(here, "limits",
                                           w["name"] + ".json"))
    for m in bench["per_layer"]:
        assert callable(cells.metric_reader(m["name"]))
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}


def test_bounds(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert {"fps", "frame_ms_p90", "setup_s"} <= set(e2e)
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
