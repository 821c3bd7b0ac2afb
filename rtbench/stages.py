"""The frame's stages and gaps in a traced run, read from the program's
stage marks and host spans (`tpu_raytracer_torch/utils/profiling.py`).

The program launches a one-thread kernel `tpurt_mark_<stage>` at each
change of stage inside its captured frames (`csrc/marks.cu`), and
`tpurt_mark_end` where the outermost stage ends. On each card, with its
kernels and copies in order of start, a mark opens its stage (the mark
itself included) and every operation up to the next mark belongs to it;
after `end`, and before a card's first mark, an operation belongs to no
stage. A frame's interval on a card runs from its first mark's start to
the end of the `end` mark that closes its `state_copy`, the last stage of
every captured frame.

The host spans (`profiling.SPANS`, recorded while the profiler ran) are
stamped with `time.time_ns()`, which the trace's clock follows less a
fixed offset: each "frame.replay" span contains its `cudaGraphLaunch`
call, which bounds the offset. A program without marks or spans (an
older checkout) gives None throughout.
"""

from __future__ import annotations

import re

from . import profile, stats

MARK = re.compile(r"\btpurt_mark_([a-z_]+?)(?![a-z_])")
LAST_STAGE = "state_copy"


def _ops(trace: profile.Trace, device) -> list:
    """The card's kernels and copies, (name, start, end), by start."""
    return sorted(((n, a, b) for n, d, a, b in trace.kernels + trace.copies
                   if d == device), key=lambda op: op[1])


def walk(trace: profile.Trace, device) -> tuple:
    """The card's operations each with its stage, and its frames:
    ([(stage or None, start, end)], [(frame start, frame end)])."""
    owned, frames = [], []
    stage = last = first = None
    for name, a, b in _ops(trace, device):
        m = MARK.search(name)
        if m is None:
            owned.append((stage, a, b))
            continue
        mark = m.group(1)
        if first is None:
            first = a
        if mark == "end":
            owned.append((None, a, b))
            if last == LAST_STAGE:
                frames.append((first, b))
                first = None
            stage = None
        else:
            stage = mark
            owned.append((stage, a, b))
        last = mark
    return owned, frames


def has_marks(trace) -> bool:
    return trace is not None and any(MARK.search(n)
                                     for n, _, _, _ in trace.kernels)


def stage_ms(trace, stage: str):
    """Device ms a frame of the operations of `stage`, summed over the
    cards; None where the trace has no marks or the stage no operation."""
    if not has_marks(trace) or trace.frames == 0:
        return None
    s = sum(b - a for d in trace.devices()
            for st, a, b in walk(trace, d)[0] if st == stage)
    return 1e3 * s / trace.frames if s > 0 else None


def _busiest(trace):
    return max(trace.devices(), key=lambda d: profile.busy(trace, d))


def graph_gap_ms(trace):
    """Idle ms a frame inside the frames' intervals on the busiest card:
    each interval less the union of its operations. None without marks
    or without a closed frame."""
    if not has_marks(trace) or trace.frames == 0:
        return None
    dev = _busiest(trace)
    owned, frames = walk(trace, dev)
    if not frames:
        return None
    inside = sum(hi - lo for lo, hi in frames)
    busy = _overlap([(a, b) for _, a, b in owned], frames)
    return 1e3 * (inside - busy) / trace.frames


def _merge(intervals) -> list:
    """The union of (start, end) intervals as disjoint ones, in order."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        elif b > a:
            out.append((a, b))
    return out


def _overlap(xs, ys) -> float:
    """Length of the intersection of the unions of xs and ys."""
    xs, ys = _merge(xs), _merge(ys)
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        lo = max(xs[i][0], ys[j][0])
        hi = min(xs[i][1], ys[j][1])
        if hi > lo:
            total += hi - lo
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def graph_launches(trace) -> list:
    """The trace's graph launches, (start s, end s) in order: the
    `cudaGraphLaunch` calls, or the `cuGraphLaunch` calls where there
    are none."""
    calls = [x for x in trace.launches if "GraphLaunch" in x[0]]
    runtime = [x for x in calls if x[0].startswith("cuda")]
    return sorted((a, b) for _, a, b in (runtime or calls))


def offset(spans, trace):
    """(lo, hi) seconds: the offsets o with which every "frame.replay"
    span [a, b] (its ns since the first span's start, in s) contains its
    graph launch [c, d] of the trace, a + o <= c and d <= b + o, pairing
    the last replay spans with the trace's launches in order. None where
    there is no launch, fewer replay spans than launches, or no such o."""
    launches = graph_launches(trace)
    replays = sorted((s.start_ns, s.end_ns) for s in spans
                     if s.name == "frame.replay")
    if not launches or len(replays) < len(launches):
        return None
    base = min(s.start_ns for s in spans)
    pairs = list(zip(replays[len(replays) - len(launches):], launches))
    lo = max(d - (b - base) * 1e-9 for (_, b), (_, d) in pairs)
    hi = min(c - (a - base) * 1e-9 for (a, _), (c, _) in pairs)
    return (lo, hi) if lo <= hi else None


def call_gap_ms(trace, spans):
    """Idle ms a frame of the busiest card outside every frame's
    interval while one of the program's spans was open, the spans moved
    onto the trace's clock by the midpoint of `offset`. None without
    marks, spans or an offset."""
    if not spans or not has_marks(trace) or trace.frames == 0:
        return None
    o = offset(spans, trace)
    if o is None:
        return None
    mid = 0.5 * (o[0] + o[1])
    base = min(s.start_ns for s in spans)
    host = [((s.start_ns - base) * 1e-9 + mid,
             (s.end_ns - base) * 1e-9 + mid) for s in spans]
    dev = _busiest(trace)
    owned, frames = walk(trace, dev)
    lo, hi = trace.window
    idle = stats.gaps([(a, b) for _, a, b in owned] + frames, lo, hi)
    return 1e3 * _overlap(idle, host) / trace.frames


def program_spans():
    """The program's host spans (`profiling.SPANS`), or None where the
    program has none."""
    from tpu_raytracer_torch.utils import profiling
    spans = getattr(profiling, "SPANS", None)
    return list(spans) if spans else None
