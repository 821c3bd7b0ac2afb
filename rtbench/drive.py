"""The window's traffic and the system under test.

`Sequence` makes a cell's inputs from the seed: the camera's start pose
(a small offset from the scene's default pose), the keys held in each
frame, and the moved instances' transforms. `Driver` runs the app's frame
loop (`tpu_raytracer_torch/app/interactive.py:run`, less the terminal)
on them: the camera controller's update, the camera uniform onto the
device, one call of the frame path, and a wait for the frame, as a
presented frame is waited for.

A traffic file (`rtbench/traffic/<mix>.json`) sets:
  width, height      the frame's size
  path               "graph": `render/graph.py:FrameGraph` on one device
                     (a test may hand `Driver` an eager frame function)
  camera             "still", or "sway": `keys` held in turns for
                     `dt` seconds a frame, reversing every `period` frames
  gb_reuse, tap_batch  as the app passes them
  refit              null, or {"ids": [...], "motion": name}: the scene
                     module's function `motion(base, i)` moves instances
  warm_frames        frames in set-up: every graph the window reaches is
                     captured in them
  check_frames, check_within   window frames the check compares, drawn
                     from the seed among the first `check_within` (fewer
                     than the slowest run completes; one the window does
                     not reach is rendered after it, untimed)
  trace_frames       frames a traced run profiles
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

# the start pose's offset from the scene's default: up to this many
# units along each axis and radians of yaw and pitch
POSE_JITTER = 0.05
ANGLE_JITTER = 0.02


@dataclasses.dataclass
class FrameInput:
    keys: tuple
    dt: float
    transforms: object   # [I, 3, 4] f32 or None


class Sequence:
    """A cell's frame inputs from its seed: frame i of the run (set-up's
    frames first) is `frame(i)`."""

    def __init__(self, traffic: dict, desc, seed: int, base_transforms):
        rng = np.random.default_rng(seed)
        pose = desc.camera
        self.position = (np.asarray(pose["position"], np.float32)
                         + rng.uniform(-POSE_JITTER, POSE_JITTER, 3)
                         .astype(np.float32))
        self.yaw = float(pose["yaw"] + rng.uniform(-ANGLE_JITTER,
                                                   ANGLE_JITTER))
        self.pitch = float(pose["pitch"] + rng.uniform(-ANGLE_JITTER,
                                                       ANGLE_JITTER))
        self.traffic = traffic
        self.motion = None
        refit = traffic.get("refit")
        if refit:
            self.motion = refit["motion"]
            self.phase = int(rng.integers(0, 1 << 16))
            self.base = np.asarray(base_transforms, np.float32)
        # the window frames the check compares
        n = traffic["check_within"]
        self.check = sorted(int(x) for x in rng.choice(
            n, size=traffic["check_frames"], replace=False))

    def frame(self, i: int, moves=None) -> FrameInput:
        """Frame i's inputs; the moved instances' transforms come from
        `moves(base, step)`, the scene module's motion, where given."""
        cam = self.traffic["camera"]
        keys = ()
        if cam["kind"] == "sway":
            first, second = cam["keys"]
            half = cam["period"] // 2
            keys = (first if ((i + half) // cam["period"]) % 2 == 0
                    else second,)
        tf = (moves(self.base, self.phase + i)
              if self.motion is not None and moves is not None else None)
        return FrameInput(keys, cam.get("dt", 0.0), tf)

    def controller(self, cls):
        """A camera controller of class `cls` at the start pose."""
        return cls(position=self.position.copy(), yaw=self.yaw,
                   pitch=self.pitch)


class Driver:
    """The app's frame loop over one frame path (`render(uniform,
    frame_count, static_ok, transforms) -> (ldr, hdr, state, aux)`).
    Keeps the app's bookkeeping: motion resets the accumulation counter,
    and a frame is static when the counter is above 0."""

    def __init__(self, seq: Sequence, render, camera_cls, to_device, aspect,
                 num_lights, moves, sync):
        self.seq, self.render = seq, render
        self.cam = seq.controller(camera_cls)
        self.to_device, self.aspect = to_device, aspect
        self.num_lights, self.moves, self.sync = num_lights, moves, sync
        self.frame_count = 0
        self.index = 0
        # host seconds of each frame's parts: inputs and uniform, the
        # frame path's call, the wait for the device
        self.host = []

    def step(self):
        """One frame: returns (its input record, ldr, hdr, state, aux)
        once the device has finished it."""
        inp = self.seq.frame(self.index, self.moves)
        for k in inp.keys:
            self.cam.press(k)
        moved = self.cam.update(inp.dt if inp.keys else 0.0)
        for k in list(self.cam.keys):
            self.cam.release(k)
        if moved:
            self.frame_count = 0
        record = {"index": self.index, "frame_count": self.frame_count,
                  "static_ok": self.frame_count > 0,
                  "camera": (self.cam.position.copy(), self.cam.yaw,
                             self.cam.pitch),
                  "transforms": inp.transforms}
        t0 = time.perf_counter()
        uniform = self.to_device(self.cam.uniform(
            self.aspect, self.frame_count, self.num_lights))
        record["uniform"] = uniform
        t1 = time.perf_counter()
        out = self.render(uniform, self.frame_count, self.frame_count > 0,
                          inp.transforms)
        t2 = time.perf_counter()
        self.sync()
        self.host.append((t1 - t0, t2 - t1, time.perf_counter() - t2))
        self.frame_count += 1
        self.index += 1
        return (record, *out)


def run_window(driver: Driver, seconds: float, on_frame=None):
    """Frames until `seconds` have passed on the host clock, the last
    frame waited for. Returns (frame completion times relative to the
    window's opening, window seconds)."""
    t_open = time.perf_counter()
    done = []
    while True:
        out = driver.step()
        t = time.perf_counter() - t_open
        done.append(t)
        if on_frame is not None:
            on_frame(len(done) - 1, out)
        if t >= seconds:
            return done, t
