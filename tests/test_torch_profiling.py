"""The frame's stage marks and host spans (`utils/profiling.py`) on the
CPU at 16^2.

On a CPU tensor a mark launches nothing; `profiling.watch_marks` reads
the order in which a frame makes them, which on a card is the order of
the `tpurt_mark_<stage>` kernels a captured frame replays
(`rtbench/stages.py` attributes the device trace by it). The kernels
themselves run under the host emulation in
`tests/test_torch_kernel_emulation.py`. A span records nothing while no
profiler runs, and under a CPU `torch.profiler` its name, parent and
frame id. The app's status line reads a graph's stage stamps.
"""

import dataclasses
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tpu_raytracer_torch.app import interactive
from tpu_raytracer_torch.models import scenes
from tpu_raytracer_torch.ops import refit
from tpu_raytracer_torch.render import camera as camera_mod
from tpu_raytracer_torch.render import graph as graph_mod
from tpu_raytracer_torch.render import pipeline, renderer
from tpu_raytracer_torch.utils import profiling

W = H = 16
# one ReSTIR frame's marks: each outermost stage ends with "end", and the
# path traces nested in the two ReSTIR passes return to their caller's
FRAME_MARKS = ["gbuffer", "end",
               "restir_temporal", "path_trace", "restir_temporal", "end",
               "restir_spatial", "path_trace", "restir_spatial", "end",
               "post", "end"]

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def cornell():
    return scenes.create_cornell_box("cpu")


def _uniform(scene, frame_count=0):
    cam = camera_mod.CameraController()
    return renderer.camera_to_device(
        cam.uniform(W / H, frame_count, scene.num_lights), "cpu")


def _refit_frame(scene, static_ok, gb_reuse):
    """FrameGraph._render with its refit in front, on the CPU: a
    FrameGraph captures only on a card, so the test sets what its
    constructor would (a refit copy of the scene, the crystal moved)."""
    g = graph_mod.FrameGraph.__new__(graph_mod.FrameGraph)
    g.scene = dataclasses.replace(scene, **{
        n: getattr(scene, n).clone() for n in refit.refit_fields(scene)})
    g.transforms = g.scene.inst_transform.clone()
    g.changed = (6,)
    g.camera, g.frame_count = _uniform(scene), torch.zeros((),
                                                           dtype=torch.int64)
    g.width, g.height, g.progressive, g.tap_batch = W, H, False, False
    g.transforms[6, 1, 3] += 0.05
    return g._render(pipeline.init_state(W, H, "cpu"), static_ok, gb_reuse,
                     True)


@pytest.mark.parametrize("case,static_ok,gb_reuse,first", [
    ("static", True, False, []),
    ("not_static", False, False, []),
    ("gb_reuse", True, True, []),
    ("refit_first", False, False, ["refit", "end"]),
])
def test_frame_marks_in_order(cornell, case, static_ok, gb_reuse, first):
    with profiling.watch_marks() as seen:
        if case == "refit_first":
            _refit_frame(cornell, static_ok, gb_reuse)
        else:
            pipeline.render_frame(cornell, _uniform(cornell, 1), 1,
                                  pipeline.init_state(W, H, "cpu"), W, H,
                                  static_ok=static_ok, gb_reuse=gb_reuse)
    assert seen == first + FRAME_MARKS
    assert set(seen) <= set(profiling.STAGES)


def test_nested_stage_returns_to_the_callers():
    """Leaving a stage marks its caller's again, or "end" at the
    outermost; a stage left by an exception marks nothing (its capture
    fails) but leaves the stack as it found it."""
    with profiling.watch_marks() as seen:
        with profiling.stage("restir_temporal"):
            with profiling.stage("path_trace"):
                with profiling.stage("post"):
                    pass
            with pytest.raises(KeyError):
                with profiling.stage("path_trace"):
                    raise KeyError("a failing stage leaves the stack")
        with profiling.stage("state_copy"):
            pass
    assert seen == ["restir_temporal", "path_trace", "post", "path_trace",
                    "restir_temporal", "path_trace", "end", "state_copy",
                    "end"]


def test_marks_launch_nothing_on_the_cpu():
    """A mark target on a CPU device launches nothing and writes no
    stamp: the kernels are never loaded."""
    stamps = profiling.Stamps("cpu")
    with profiling.marking("cpu", stamps), profiling.stage("gbuffer"):
        pass
    assert stamps.names == [] and not stamps.row.any()


def test_stamps_time_each_stage():
    """Stamps.ms: each stage from its mark to the next, summed over its
    turns, "end" owning nothing."""
    stamps = profiling.Stamps("cpu")
    stamps.names = ["restir_temporal", "path_trace", "restir_temporal",
                    "end", "post", "end"]
    stamps.row[:6] = torch.tensor([0, 1_000_000, 4_000_000, 4_500_000,
                                   4_600_000, 5_600_000])
    assert stamps.ms() == {"restir_temporal": 1.5, "path_trace": 3.0,
                           "post": 1.0}


def test_span_records_nothing_without_a_profiler(cornell):
    before = len(profiling.SPANS)
    with profiling.span("frame.call"):
        camera_mod.CameraController().update(0.1)
        _uniform(cornell)
    assert len(profiling.SPANS) == before


def test_span_records_under_a_cpu_profiler(cornell):
    profiling.SPANS.clear()
    cam = camera_mod.CameraController()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            cam.press("w")
            cam.update(0.1)
            with profiling.span("frame.call"):
                with profiling.span("frame.replay", card=1, segment=0):
                    renderer.camera_to_device(
                        cam.uniform(W / H, 0, cornell.num_lights), "cpu")
    spans = list(profiling.SPANS)
    assert [s.name for s in spans] == [
        "camera.update", "camera.to_device", "frame.replay", "frame.call"
    ] * 2
    by_id = {s.id: s for s in spans}
    for s in spans:
        assert s.start_ns <= s.end_ns
        assert s.thread == threading.get_ident()
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    update, to_device, replay, call = spans[:4]
    assert update.parent is None and call.parent is None
    assert replay.parent == call.id and to_device.parent == replay.id
    assert replay.tags == {"card": 1, "segment": 0}
    # a frame's spans share its id; the update before a call takes it too
    assert {s.frame for s in spans[:4]} == {call.frame}
    assert {s.frame for s in spans[4:]} == {call.frame + 1}
    profiling.SPANS.clear()


def test_app_status_line_shows_the_stages():
    """The app's status line: the last frame's device ms by stage,
    summed over the cards, in STAGES' order, and with several cards each
    card's busy share of a frame at the line's fps; nothing before the
    first replay."""
    one = [{"gbuffer": 1.04, "restir_temporal": 2.0, "path_trace": 50.0}]
    assert interactive.stage_line(one, 10.0) == (
        " | device ms gbuffer 1.0 restir_temporal 2.0 path_trace 50.0")
    two = [{"path_trace": 40.0, "gbuffer": 2.0},
           {"gbuffer": 1.0, "path_trace": 18.0, "post": 1.0}]
    assert interactive.stage_line(two, 12.5) == (
        " | device ms gbuffer 3.0 path_trace 58.0 post 1.0 | busy 52% 25%")
    assert interactive.stage_line([], 10.0) == ""
