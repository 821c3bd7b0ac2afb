"""The device trace of a traced run: `torch.profiler` (CUPTI) over a
stretch of frames, read back from its Chrome trace into plain lists.

On a card the profiler records the device's activity alone (kernels,
copies, sets) and the CUDA runtime's and driver's calls on the host,
not PyTorch's host operations: recording those slows the row bands'
host threads, which then hold the cards idle. The window runs from the
first call that hands the device work to the end of the last device
operation. Without a card (tests) the profiler records the host's
operations, and the window is the "rtbench.window" annotation around
the traced frames.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import tempfile

from . import stats

WINDOW = "rtbench.window"
# host calls that hand the device work: a graph, a kernel or a copy
LAUNCH_WORDS = ("LaunchKernel", "GraphLaunch", "Memcpy", "Memset",
                "cuLaunch")


@dataclasses.dataclass
class Trace:
    kernels: list    # (name, device, start s, end s)
    copies: list     # (name, device, start s, end s): memcpy and memset
    launches: list   # (name, start s, end s): host calls that launch
    host: list       # (name, start s, end s): host ops and annotations
    window: tuple    # (start s, end s)
    frames: int

    def device_intervals(self, device=None) -> list:
        return [(a, b) for _, d, a, b in self.kernels + self.copies
                if device is None or d == device]

    def devices(self) -> list:
        return sorted({d for _, d, _, _ in self.kernels + self.copies})


def parse(events: list, frames: int) -> Trace:
    """A Trace from Chrome trace events (`traceEvents`), times in s."""
    kernels, copies, launches, host = [], [], [], []
    window = None
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        a = float(e["ts"]) * 1e-6
        b = a + float(e.get("dur", 0.0)) * 1e-6
        dev = (e.get("args") or {}).get("device", e.get("pid"))
        if cat == "kernel":
            kernels.append((name, dev, a, b))
        elif cat in ("gpu_memcpy", "gpu_memset"):
            copies.append((name, dev, a, b))
        elif cat in ("cuda_runtime", "cuda_driver"):
            if any(w in name for w in LAUNCH_WORDS):
                launches.append((name, a, b))
            host.append((name, a, b))
        elif cat in ("cpu_op", "user_annotation", "python_function"):
            if name == WINDOW and cat == "user_annotation":
                window = (a, b)
            host.append((name, a, b))
    ops = kernels + copies
    if ops:
        lo = min([a for _, _, a, _ in ops] + [a for _, a, _ in launches])
        window = (lo, max(b for _, _, _, b in ops))
    if window is None:
        raise RuntimeError("the trace holds no device operation and no "
                           f"{WINDOW!r} annotation")
    lo, hi = window

    def inside(xs, t0, t1):
        return [x for x in xs if x[t0] < hi and x[t1] > lo]

    return Trace(inside(kernels, 2, 3), inside(copies, 2, 3),
                 inside(launches, 1, 2), inside(host, 1, 2), window, frames)


@contextlib.contextmanager
def profiled(frames: int):
    """Profile the block (the device's activity on a card, the host's
    without one); yields a list that holds the Trace once the block has
    ended. The Chrome trace goes to a temporary file under TMPDIR and is
    deleted once read."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    out = []
    activity = (ProfilerActivity.CUDA if torch.cuda.is_available()
                else ProfilerActivity.CPU)
    with profile(activities=[activity]) as prof:
        with record_function(WINDOW):
            yield out
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json", prefix="rtbench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    out.append(parse(events, frames))


def busy(trace: Trace, device=None) -> float:
    """Seconds of the window in which the device (every device: their
    union) ran a kernel, a copy or a set."""
    lo, hi = trace.window
    return stats.union_length([(max(a, lo), min(b, hi)) for a, b in
                               trace.device_intervals(device)])


def busiest_idle_share(trace: Trace) -> float:
    """The idle share of the window on the busiest device, in %."""
    lo, hi = trace.window
    devices = trace.devices() or [None]
    top = max(busy(trace, d) for d in devices)
    return 100.0 * (1.0 - top / (hi - lo))


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time (summed by name) and
    the longest idle gaps of the busiest device, each named by the
    innermost host operation running at its middle."""
    total = {}
    for name, _, a, b in trace.kernels + trace.copies:
        total[name] = total.get(name, 0.0) + (b - a)
    ops = sorted(total.items(), key=lambda kv: -kv[1])[:top]
    devices = trace.devices()
    dev = max(devices, key=lambda d: busy(trace, d)) if devices else None
    lo, hi = trace.window
    idle = []
    for a, b in stats.gaps(trace.device_intervals(dev), lo, hi)[:top]:
        mid = 0.5 * (a + b)
        around = [(e - s, n) for n, s, e in trace.host if s <= mid <= e]
        idle.append([min(around)[1] if around else "host: none", b - a])
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": idle}
