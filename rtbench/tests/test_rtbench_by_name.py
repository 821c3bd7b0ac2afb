"""A configuration, a traffic mix and a per-layer metric added as files
only are found by name: the harness needs no edit for a new cell."""

import json
import os
import shutil

from rtbench import cells


def test_new_files_are_found_by_name(tmp_path, monkeypatch):
    here = tmp_path / "rtbench"
    for d in ("traffic", "limits", "metrics"):
        shutil.copytree(os.path.join(cells.HERE, d), here / d)
    monkeypatch.setattr(cells, "HERE", str(here))
    (here / "traffic" / "still_64p.json").write_text(json.dumps(
        {"width": 64, "height": 64, "path": "graph",
         "camera": {"kind": "still"}, "gb_reuse": True,
         "tap_batch": False, "refit": None, "warm_frames": 2,
         "check_frames": 1, "check_within": 4, "trace_frames": 2}))
    config = tmp_path / "tiny.json"
    config.write_text(json.dumps({"name": "tiny", "scene": "cornell",
                                  "kernel": "mxuf2"}))
    (here / "limits" / "tiny.still_64p.json").write_text(json.dumps(
        {"hdr_gap": 0.01}))
    (here / "metrics" / "frames_traced.py").write_text(
        "def read(run):\n    return float(run.trace.frames)\n")
    bench = {"configs": [{"name": "tiny", "file": str(config)}],
             "workloads": [{"name": "tiny.still_64p", "config": "tiny",
                            "traffic": "still_64p", "chips": 1}],
             "end_to_end": [{"name": "fps", "unit": "frames/s"}],
             "per_layer": [{"name": "frames_traced", "unit": "frames",
                            "workloads": ["tiny.still_64p"]},
                           {"name": "other", "unit": "x",
                            "workloads": ["elsewhere"]}]}
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    cell = cells.load("tiny.still_64p", str(path))
    assert cell.traffic["width"] == 64 and cell.config["name"] == "tiny"
    assert cell.limits == {"hdr_gap": 0.01}
    assert [m["name"] for m in cell.per_layer] == ["frames_traced"]

    class View:
        class trace:
            frames = 3
    assert cells.metric_reader("frames_traced")(View) == 3.0
