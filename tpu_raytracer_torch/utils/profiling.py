"""Frame telemetry (`tpu_raytracer/utils/profiling.py`, less its JAX
profiler trace; `profile_frame.py` traces a frame with torch.profiler).

  * `FrameStats`: rolling fps and Mrays/s from the pipeline's exact ray
    counts (the reference app's window-title telemetry, main.rs:81-95);
    the app prints it,
  * `timed`: a wall-clock stage timer that waits for the device at exit,
  * `device_memory`: live and peak bytes of each CUDA device.
"""

from __future__ import annotations

import collections
import contextlib
import time

import torch


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


@contextlib.contextmanager
def timed(label: str, results: dict | None = None):
    """Wall-clock a stage; at exit wait for the current CUDA device's
    work, where there is one."""
    t0 = time.time()
    yield
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    dt = time.time() - t0
    if results is not None:
        results[label] = dt
    else:
        print(f"[timed] {label}: {dt * 1e3:.2f} ms")


def device_memory() -> dict:
    """Live and peak allocated bytes of each CUDA device
    (torch.cuda.memory_stats); empty without one."""
    out = {}
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
        }
    return out
