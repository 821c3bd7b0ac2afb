"""The stage and gap readers (`rtbench/stages.py`) on hand-built traces
of two cards: stages across nested marks, operations outside every
stage, the frames' gaps, the host spans' offset, and None where a trace
or a program lacks what they read."""

import collections

import pytest

from rtbench import profile, stages
from rtbench.cells import metric_reader

Span = collections.namedtuple(
    "Span", "id name frame parent thread start_ns end_ns tags")

MS = 1e-3


def _mark(stage, dev, t):
    return (f"(anonymous namespace)::tpurt_mark_{stage}(long*, int)", dev,
            t * MS, (t + 0.001) * MS)


def _op(name, dev, a, b):
    return (f"void at::native::{name}(float*)", dev, a * MS, b * MS)


def _card(dev, t0):
    """One frame on card `dev` from t0 ms: an input copy before it, then
    gbuffer 1 ms; restir_temporal 1 ms around a path trace of 3 ms;
    post 1 ms; state_copy 0.5 ms; each op 0.1 ms after its mark, so the
    frame holds 0.1 ms gaps."""
    k = [_op("input_fill", dev, t0 - 1.0, t0 - 0.9)]
    c = [("Memcpy DtoD", dev, (t0 - 0.5) * MS, (t0 - 0.4) * MS)]
    t = t0
    for stage, ms, nest in [("gbuffer", 1.0, None),
                            ("restir_temporal", 0.5, ("path_trace", 3.0)),
                            ("post", 1.0, None), ("state_copy", 0.5, None)]:
        k.append(_mark(stage, dev, t))
        k.append(_op(f"{stage}_work", dev, t + 0.1, t + ms))
        t += ms
        if nest:
            k.append(_mark(nest[0], dev, t))
            k.append(_op(f"{nest[0]}_work", dev, t + 0.1, t + nest[1]))
            t += nest[1]
            k.append(_mark(stage, dev, t))
            k.append(_op(f"{stage}_tail", dev, t + 0.1, t + 0.5))
            t += 0.5
        k.append(_mark("end", dev, t))
        t += 0.001
    return k, c, t


def _trace(frames=1, launches=(), devices=(0, 1), marks=True):
    kernels, copies, t0 = [], [], 2.0
    for _ in range(frames):
        end = t0
        for dev in devices:
            k, c, e = _card(dev, t0)
            kernels += k
            copies += c
            end = max(end, e)
        t0 = end + 3.0
    if not marks:
        kernels = [x for x in kernels if "tpurt_mark" not in x[0]]
    ops = kernels + copies
    window = (min(a for _, _, a, _ in ops), max(b for _, _, _, b in ops))
    return profile.Trace(kernels, copies, list(launches), [], window, frames)


def test_stages_across_nested_marks():
    tr = _trace()
    owned, frames = stages.walk(tr, 0)
    by = collections.defaultdict(float)
    for st, a, b in owned:
        by[st] += (b - a) / MS
    # each stage its marks and its work; restir_temporal its two parts
    # around the path trace, which is apart; "end" marks and the inputs
    # belong to none
    want = {"gbuffer": 0.901, "restir_temporal": 0.802,
            "path_trace": 2.901, "post": 0.901, "state_copy": 0.401,
            None: 0.004 + 0.2}
    assert by == pytest.approx(want)
    # two cards: each stage's metric sums them
    for st in ("gbuffer", "restir_temporal", "path_trace", "post",
               "state_copy"):
        assert stages.stage_ms(tr, st) == pytest.approx(2 * want[st])
    assert stages.stage_ms(tr, "refit") is None
    assert frames == [pytest.approx((2.0 * MS, 8.504 * MS))]


def test_an_operation_before_the_first_mark_has_no_stage():
    owned, _ = stages.walk(_trace(), 1)
    assert owned[0][0] is None and owned[1][0] is None      # input ops
    assert owned[2][0] == "gbuffer"
    # the inputs and the four "end" marks
    assert sum(o[0] is None for o in owned) == 2 + 4


def test_metric_files_read_the_stages():
    from rtbench.run import RunView
    view = RunView(None, {}, _trace(frames=2), {}, "cpu")
    assert metric_reader("path_trace_ms_per_frame")(view) == \
        pytest.approx(2 * 2.901)
    assert metric_reader("refit_ms_per_frame")(view) is None
    assert metric_reader("graph_gap_ms_per_frame")(view) == \
        pytest.approx(0.594)
    assert metric_reader("gbuffer_ms_per_frame")(
        RunView(None, {}, None, {}, "cpu")) is None


def test_graph_gap_is_the_frames_idle():
    # a frame of 6.504 ms on the busiest card holds 0.099 ms before the
    # work of each of its 6 stage turns
    assert stages.graph_gap_ms(_trace(frames=2)) == pytest.approx(0.594)
    assert stages.graph_gap_ms(_trace(marks=False)) is None


LAUNCH_AT = (1.9, 11.4)    # ms, 0.1 ms before each frame's first mark
BASE_NS = 1_700_000_000_000_000_000


def _spans(shift_s, t_replays, n_before=0):
    """Spans on a host clock `shift_s` s behind the trace's: each frame's
    camera update [t - 2, t - 1.5] ms and call [t - 0.5, t + 4] ms
    holding a replay [t - 0.2, t + 0.3] ms around its launch at
    [t, t + 0.1]; `n_before` frames at t = -100 ms, an earlier traced
    stretch's."""
    def ns(ms):
        return BASE_NS + int(round((ms * MS - shift_s) * 1e9))

    out = []
    for t in [-100.0] * n_before + list(t_replays):
        i = len(out)
        out += [Span(i, "camera.update", 0, None, 1, ns(t - 2.0),
                     ns(t - 1.5), {}),
                Span(i + 1, "frame.replay", 0, i + 2, 1, ns(t - 0.2),
                     ns(t + 0.3), {}),
                Span(i + 2, "frame.call", 0, None, 1, ns(t - 0.5),
                     ns(t + 4.0), {})]
    return out


def _launched(times=LAUNCH_AT):
    return _trace(frames=2, launches=[("cudaGraphLaunch", t * MS,
                                       (t + 0.1) * MS) for t in times])


@pytest.mark.parametrize("shift_s", [0.25, -3.0])
@pytest.mark.parametrize("n_before", [0, 1])
def test_offset_solved_from_spans_with_a_known_shift(shift_s, n_before):
    """The trace's clock is the spans' (ns since the first span's start)
    plus o; the first span starts 2 ms before its frame's replay time t,
    so o = t_first - 2 ms. Each replay holds its launch with 0.2 ms to
    spare on either side: o is found within +-0.2 ms, its midpoint
    exact."""
    spans = _spans(shift_s, LAUNCH_AT, n_before)
    lo, hi = stages.offset(spans, _launched())
    o = ((-100.0 if n_before else LAUNCH_AT[0]) - 2.0) * MS
    assert hi - lo == pytest.approx(0.4 * MS, abs=2e-9)
    assert 0.5 * (lo + hi) == pytest.approx(o, abs=2e-9)


def test_call_gap_counts_idle_under_spans():
    """Card 0's idle outside its frames, in the 1.0-18.008 ms window:
    [1.1, 1.5], [1.6, 2.0], [8.504, 10.504], [10.604, 11.004] and
    [11.104, 11.504] ms. Under the spans: 0.1 + 0.4 (frame 0's call from
    1.4), 0.5 (frame 1's camera update, 9.4-9.9), 0.104 + 0.4 (its call
    from 10.9): 1.504 ms over 2 frames."""
    got = stages.call_gap_ms(_launched(), _spans(0.25, LAUNCH_AT, 1))
    assert got == pytest.approx(0.752, abs=1e-6)


def test_none_without_marks_spans_or_offset():
    spans = _spans(0.25, LAUNCH_AT)
    unmarked = _trace(frames=2, marks=False, launches=_launched().launches)
    assert stages.call_gap_ms(unmarked, spans) is None
    assert stages.call_gap_ms(_launched(), []) is None
    assert stages.call_gap_ms(_launched(), None) is None
    # launches that no one offset puts inside their replay spans
    bad = _launched((1.9, 30.0))
    assert stages.offset(spans, bad) is None
    assert stages.call_gap_ms(bad, spans) is None
    # fewer replay spans than launches
    assert stages.offset(spans[:3], _launched()) is None
    assert stages.call_gap_ms(_launched(), spans[:3]) is None
