"""A whole run of a cell on the CPU at a tiny size: set-up, the window,
the check against the reference, and the faults the check must catch.
The harness's look for a card is skipped (`run.measure` takes the CPU
device and the program's eager frame in place of its CUDA graphs)."""

import time

import pytest
import torch

from rtbench import cells, run
from rtbench.tests import cpu_frame

CELLS = ["cornell.still_720p", "cornell.flythrough_1080p_refit",
         "knot.still_720p"]


def _cell(name):
    cell = cells.load(name)
    cell.traffic.update(width=32, height=24, check_within=3,
                        trace_frames=2)
    if cell.config["scene"] == "knot":
        cell.config.update(knot_major=60, knot_minor=20)
    return cell


def _measure(name, frame, control=None, trace=False):
    return run.measure(_cell(name), 2 ** 31 + 7, 0.5, trace,
                       [torch.device("cpu")], time.perf_counter(),
                       control=control, frame_factory=frame,
                       sync=lambda: None, log=lambda *a: None)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    r = _measure(name, cpu_frame.EagerFrame)
    assert r["correct"], r["checked"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert list(r)[-1] == "checked"
    assert set(r["metrics"]) == {"fps", "frame_ms_p90", "setup_s"}
    want = {"hdr_gap", "ldr_px_pct", "state_px_pct", "rays_gap"}
    if cells.load(name).traffic.get("refit"):
        want.add("refit_gap")
    assert set(r["checked"]) == want
    assert all(v["limit"] is not None for v in r["checked"].values())


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered"])
@pytest.mark.parametrize("name", ["cornell.still_720p",
                                  "cornell.flythrough_1080p_refit"])
def test_faults_are_caught(name, fault):
    frame = {"state_unchanged": cpu_frame.StateUnchanged,
             "half_batch": cpu_frame.HalfBatch,
             "answer_altered": cpu_frame.EagerFrame}[fault]
    undo = cpu_frame.altered_answers() if fault == "answer_altered" \
        else (lambda: None)
    try:
        r = _measure(name, frame)
    finally:
        undo()
    assert not r["correct"], r["checked"]


def test_skipped_refit_is_caught():
    r = _measure("cornell.flythrough_1080p_refit", cpu_frame.RefitSkipped)
    assert not r["correct"]
    c = r["checked"]["refit_gap"]
    assert c["value"] > c["limit"], c


@pytest.mark.parametrize("control", ["bf16", "bf16_shading"])
def test_control_is_caught(control):
    r = _measure("cornell.still_720p", cpu_frame.EagerFrame, control=control)
    assert not r["correct"]
    failed = [k for k, v in r["checked"].items() if v["value"] > v["limit"]]
    assert failed, r["checked"]


def test_traced_run_reports_per_layer_metrics():
    r = _measure("cornell.still_720p", cpu_frame.EagerFrame, trace=True)
    assert r["correct"]
    assert {"scene_build_s", "capture_s"} <= set(r["metrics"])
    assert not {"fps", "frame_ms_p90", "setup_s"} & set(r["metrics"])
    assert r["device"]["window_s"] > 0
    assert len(r["breakdown"]["idle_gaps"]) <= 10


def test_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(time.perf_counter(), [
        "--workload", "cornell.still_720p", "--seed", "1", "--seconds",
        "1", "--trace", "0"])
    out, err = capsys.readouterr()
    assert rc != 0 and out == ""
    assert "needs 1 CUDA device" in err


def test_refuses_with_too_few_cards(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    rc = run.main(time.perf_counter(), [
        "--workload", "cornell.still_720p", "--seed", "1", "--seconds",
        "1", "--trace", "0"])
    out, _ = capsys.readouterr()
    assert rc != 0 and out == ""


@pytest.mark.card
@pytest.mark.parametrize("control", ["bf16", "bf16_shading"])
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_the_cells_size(card, name, control):
    """The controls on the card at the cell's own size: the reference in
    bfloat16, or with its shading alone in bfloat16, in the program's
    place reads above a limit."""
    r = run.measure(cells.load(name), 7, 2.0, False, [card],
                    time.perf_counter(), control=control,
                    log=lambda *a: None)
    assert not r["correct"], r["checked"]


def _bands_cell():
    """The bands cell at a size the CPU holds: 4 bands of 16 rows, on one
    device."""
    cell = cells.load("cornell.bands4_still_1080p")
    cell.traffic.update(width=32, height=64, check_within=3, trace_frames=2)
    cell.chips = 1
    return cell


@pytest.mark.parametrize("fault", [None, "no_exchange"])
def test_bands(fault):
    frame = {None: cpu_frame.EagerBands,
             "no_exchange": cpu_frame.BandsWithoutExchange}[fault]
    r = run.measure(_bands_cell(), 99, 0.5, False, [torch.device("cpu")],
                    time.perf_counter(), frame_factory=frame,
                    sync=lambda: None, log=lambda *a: None)
    assert r["correct"] == (fault is None), r["checked"]
