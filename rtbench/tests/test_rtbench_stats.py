"""The benchmark's arithmetic against hand-worked cases."""

import pytest

from rtbench import profile, stats
from rtbench.cells import metric_reader


def test_percentile_nearest_rank():
    xs = list(range(1, 11))              # 1..10
    assert stats.percentile(xs, 90) == 9
    assert stats.percentile(xs, 50) == 5
    assert stats.percentile(xs, 100) == 10
    assert stats.percentile([3.0], 90) == 3.0
    # 100 frames: the 90th is the 90th smallest, 10 lie beyond it
    ys = [float(i) for i in range(100, 0, -1)]
    assert stats.percentile(ys, 90) == 90.0
    with pytest.raises(ValueError):
        stats.percentile([], 90)


def test_frame_times_are_intervals_between_completions():
    assert stats.frame_times([0.1, 0.3, 0.35]) == pytest.approx(
        [0.1, 0.2, 0.05])


def test_union_and_gaps():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6)]
    assert stats.union_length(iv) == pytest.approx(3.0)
    assert stats.gaps(iv, 0.0, 5.0) == [(2.0, 3.0), (4.0, 5.0)]
    assert stats.gaps([], 1.0, 2.0) == [(1.0, 2.0)]


def test_idle_share_of_the_busiest_device():
    t = profile.Trace(
        kernels=[("k", 0, 0.0, 0.4), ("k", 0, 0.5, 0.9),
                 ("k", 1, 0.0, 0.2)],
        copies=[("Memcpy", 0, 0.35, 0.45)], launches=[], host=[],
        window=(0.0, 1.0), frames=2)
    # device 0: [0, 0.45] and [0.5, 0.9] busy
    assert profile.busy(t, 0) == pytest.approx(0.85)
    assert profile.busiest_idle_share(t) == pytest.approx(15.0)
    b = profile.breakdown(t)
    assert b["device_ops"][0] == ["k", pytest.approx(1.0)]
    assert [g[1] for g in b["idle_gaps"]] == [pytest.approx(0.1),
                                              pytest.approx(0.05)]


def test_trace_bytes_by_hand():
    tb = metric_reader("trace_roofline").__globals__["trace_bytes"]
    # a query: o, d (24 B), t_min, t_max (8 B) in, t and tri (8 B) out;
    # a stage reads each triangle's 9 floats once
    assert tb(1000, 0, 0) == 40_000
    assert tb(0, 2, 10) == 2 * 10 * 36
    assert tb(10, 3, 7) == 400 + 756


def test_parse_keeps_the_window():
    """On a card the window runs from the first call that hands the
    device work to the end of the last device operation; a trace with no
    device operation (the CPU) keeps the harness's annotation."""
    ev = [{"ph": "X", "cat": "kernel", "name": "closest_hit_kernel",
           "ts": 200.0, "dur": 100.0, "pid": 0, "args": {"device": 0}},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD",
           "ts": 320.0, "dur": 80.0, "args": {"device": 0}},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch",
           "ts": 150.0, "dur": 10.0},
          {"ph": "X", "cat": "cuda_runtime",
           "name": "cudaStreamSynchronize", "ts": 300.0, "dur": 110.0}]
    t = profile.parse(ev, frames=1)
    assert [k[0] for k in t.kernels] == ["closest_hit_kernel"]
    assert len(t.copies) == 1 and len(t.launches) == 1
    assert t.window == pytest.approx((1.5e-4, 4e-4))
    host = [{"ph": "X", "cat": "user_annotation", "name": "rtbench.window",
             "ts": 100.0, "dur": 1000.0},
            {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 200.0,
             "dur": 100.0}]
    t = profile.parse(host, frames=1)
    assert t.kernels == [] and t.window == pytest.approx((1e-4, 1.1e-3))
