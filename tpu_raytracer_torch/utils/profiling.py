"""Frame telemetry (`tpu_raytracer/utils/profiling.py`, less its JAX
profiler trace; `rtbench --trace 1` traces a frame with torch.profiler).

  * `FrameStats`: rolling fps and Mrays/s from the pipeline's exact ray
    counts (the reference app's window-title telemetry, main.rs:81-95);
    the app prints it,
  * `stage`: the frame's stages as device marks (`csrc/marks.cu`), one
    one-thread kernel a stage, so that a device trace of a replayed CUDA
    graph tells them apart by kernel name, and a graph's `Stamps` time
    each stage of its last replay without a profiler,
  * `span`: host spans of the frame call, on the clock a
    `torch.profiler` trace uses (`time.time_ns`), kept in `SPANS` while
    a profiler runs and nowhere otherwise,
  * `SETUP`: set-up steps that run once, always recorded: host seconds
    summed over the process (`setup_span`) and counts.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time

import torch
from torch.autograd import profiler as _profiler

from ..ops import trace_api


class FrameStats:
    """Rolling window over frame time + ray counts (the window-title
    telemetry, main.rs:81-95, plus a Mrays/s counter)."""

    def __init__(self, window: int = 60):
        self.times = collections.deque(maxlen=window)
        self.rays = collections.deque(maxlen=window)
        self._last = None

    def frame(self, ray_count) -> None:
        """Close a frame of `ray_count` rays: a number or a 0-d tensor,
        which is read only by `mrays_per_s`, so a frame waits for no
        device."""
        now = time.time()
        if self._last is not None:
            self.times.append(now - self._last)
            self.rays.append(ray_count)
        self._last = now

    @property
    def fps(self) -> float:
        return len(self.times) / sum(self.times) if self.times else 0.0

    @property
    def mrays_per_s(self) -> float:
        t = sum(self.times)
        return (sum(float(r) for r in self.rays) / t / 1e6) if t else 0.0

    def summary(self) -> str:
        return f"{self.fps:.2f} fps, {self.mrays_per_s:.1f} Mrays/s"


# ---------------------------------------------------------------------------
# Stage marks
# ---------------------------------------------------------------------------

# The marks of `csrc/marks.cu`, in its order: the stages, then `end`,
# which closes the outermost stage.
STAGES = ("refit", "gbuffer", "restir_temporal", "path_trace",
          "restir_spatial", "post", "state_copy", "end")
# a captured frame's marks on one card (a ReSTIR frame with its refit
# makes 14)
STAMP_SLOTS = 64

_LOCAL = threading.local()     # each thread's open stages and mark target
_HOOKS = []                    # callables given each mark's stage name


class Stamps:
    """The stamp row of one captured frame on one card: the device's
    nanosecond timer at each of its marks (`row`, written by every
    replay) and the stage each mark opens (`names`, recorded at
    capture)."""

    def __init__(self, device):
        self.row = torch.zeros((STAMP_SLOTS,), dtype=torch.int64,
                               device=device)
        self.names = []

    def _slot(self, name: str) -> int:
        if len(self.names) == STAMP_SLOTS:
            raise RuntimeError(f"a frame of more than {STAMP_SLOTS} stage "
                               f"marks")
        self.names.append(name)
        return len(self.names) - 1

    def ms(self) -> dict:
        """Device ms of each stage in the last replay, from its mark to
        the next mark (gaps included), summed over the stage's turns.
        Reads the row: call it once the replay has finished."""
        t = self.row[:len(self.names)].tolist()
        out = {}
        for name, a, b in zip(self.names, t, t[1:]):
            if name != "end":
                out[name] = out.get(name, 0.0) + (b - a) * 1e-6
        return out


def _stack() -> list:
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


def _mark(name: str) -> None:
    for hook in _HOOKS:
        hook(name)
    target = getattr(_LOCAL, "target", None)
    if target is None:
        return
    device, stamps = target
    ptr, slot = (0, 0) if stamps is None else (stamps.row.data_ptr(),
                                               stamps._slot(name))
    err = trace_api.load_kernels().tpurt_mark(
        STAGES.index(name), ptr, slot,
        torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mark {name!r} launch failed: CUDA error {err}")


@contextlib.contextmanager
def marking(device, stamps: Stamps | None = None):
    """Launch the calling thread's stage marks on `device`'s current
    stream inside the block, each writing its stamp into `stamps` where
    given (a graph captured in the block replays them). Marks launch
    nothing outside such a block, or on a device that is not CUDA."""
    device = torch.device(device)
    old = getattr(_LOCAL, "target", None)
    _LOCAL.target = (device, stamps) if device.type == "cuda" else None
    try:
        yield
    finally:
        _LOCAL.target = old


@contextlib.contextmanager
def stage(name: str):
    """The block is stage `name` (one of STAGES but "end"): entering
    marks it, leaving marks the enclosing stage again, or "end" at the
    outermost. So a stage owns exactly the device operations queued
    between its mark and the next mark."""
    stack = _stack()
    stack.append(name)
    _mark(name)
    try:
        yield
    finally:
        stack.pop()
    _mark(stack[-1] if stack else "end")


@contextlib.contextmanager
def watch_marks():
    """Yields a list that collects the name of every mark made in the
    block, on any device (tests read the order of a frame's stages)."""
    seen = []
    _HOOKS.append(seen.append)
    try:
        yield seen
    finally:
        _HOOKS.remove(seen.append)


# ---------------------------------------------------------------------------
# Host spans
# ---------------------------------------------------------------------------

Span = collections.namedtuple(
    "Span", "id name frame parent thread start_ns end_ns tags")
# the spans of the last traced stretch and those before it, oldest
# dropped first
SPANS = collections.deque(maxlen=1 << 16)

_SPAN_IDS = itertools.count()
_FRAME = [0]       # the frame id the next span takes


class _Open:
    """A span being recorded (`span`)."""

    __slots__ = ("name", "tags", "id", "parent", "frame", "start")

    def __init__(self, name: str, tags: dict):
        self.name, self.tags = name, tags

    def __enter__(self):
        stack = getattr(_LOCAL, "spans", None)
        if stack is None:
            stack = _LOCAL.spans = []
        self.id = next(_SPAN_IDS)
        self.parent = stack[-1].id if stack else None
        self.frame = _FRAME[0]
        stack.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _LOCAL.spans.pop()
        SPANS.append(Span(self.id, self.name, self.frame, self.parent,
                          threading.get_ident(), self.start, end,
                          self.tags))
        if self.name == "frame.call":
            _FRAME[0] += 1
        return False


_OFF = contextlib.nullcontext()


def span(name: str, **tags):
    """A host span around the block, recorded into SPANS only while a
    torch.profiler runs (else one attribute read): its name, the frame
    it belongs to (the id of the enclosing "frame.call", or outside one
    the id the next "frame.call" takes), its parent span's id, the
    thread, start and end in `time.time_ns()` ns, and `tags` (a band
    segment's card and index)."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Open(name, tags)


# ---------------------------------------------------------------------------
# Set-up record
# ---------------------------------------------------------------------------

# Set-up runs once, so its record is always kept, summed over the process:
#   texture_prep      host seconds of the scene builder's texture
#                     preparation (`scene/builder.py:_prep_texture`)
#   texture_resizes   images that preparation Lanczos-resized
SETUP = {"texture_prep": 0.0, "texture_resizes": 0}


@contextlib.contextmanager
def setup_span(name: str):
    """Adds the block's host seconds to SETUP[name]."""
    start = time.perf_counter()
    try:
        yield
    finally:
        SETUP[name] = SETUP.get(name, 0.0) + time.perf_counter() - start
