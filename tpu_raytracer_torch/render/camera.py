"""Fly camera controller + camera uniform (src/camera.rs).

Host-side numpy in f64, identical to `tpu_raytracer/render/camera.py`;
`render/renderer.py:camera_to_device` moves a uniform onto a device.

Same controls and dynamics as the reference: WASD move (2.0 u/s), arrows
rotate (1.5 rad/s), Space/Shift up/down, pitch clamp +-1.5 rad
(camera.rs:113-180); 45 deg vfov, near 0.1, far 100 (camera.rs:219); Halton
jitter generator present but scaled by zero exactly like the reference
(camera.rs:196-204 multiplies by `0.` - TAA jitter disabled); the previous
frame's UNJITTERED view-proj is sent for motion vectors (camera.rs:234-241).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..utils import math3d, profiling, rng


def get_halton_jitter(index: int, width: int, height: int) -> tuple:
    """camera.rs:182-205 - note the deliberate `* 0.` (jitter disabled)."""
    hx = rng.halton(index + 1, 2) - 0.5
    hy = rng.halton(index + 1, 3) - 0.5
    return ((hx * 0.0) / width, (hy * 0.0) / height)


def build_camera_uniform(position, yaw: float, pitch: float, aspect: float,
                         frame_count: int, num_lights: int,
                         jitter=(0.0, 0.0), prev_view_proj=None) -> dict:
    """camera.rs:207-256. Returns the uniform dict + unjittered VP inside it.

    All matrices are row-major numpy (column-vector convention, M @ v).
    """
    position = np.asarray(position, np.float64)
    sin_y, cos_y = np.sin(yaw), np.cos(yaw)
    sin_p, cos_p = np.sin(pitch), np.cos(pitch)
    forward = np.array([cos_p * cos_y, sin_p, cos_p * sin_y], np.float64)
    forward /= np.linalg.norm(forward)

    view = math3d.look_at_rh(position, position + forward, [0.0, 1.0, 0.0]).astype(np.float64)
    proj_base = math3d.perspective_rh(np.radians(45.0), aspect, 0.1, 100.0).astype(np.float64)
    view_proj_unjittered = proj_base @ view

    # jitter shears the projection (camera.rs:225-228; glam col 2 = row idx 2)
    proj = proj_base.copy()
    proj[0, 2] += jitter[0]
    proj[1, 2] += jitter[1]
    view_proj = proj @ view

    if prev_view_proj is None:
        prev_view_proj = view_proj_unjittered

    view_inv = np.linalg.inv(view)
    proj_inv = np.linalg.inv(proj)
    return {
        "view_proj": view_proj.astype(np.float32),
        "view_inv": view_inv.astype(np.float32),
        "proj_inv": proj_inv.astype(np.float32),
        # ray matrix precomposed in f64 on host: f32 composition on device
        # loses the inverse-projection w cancellation.
        "ray_matrix": (view_inv @ proj_inv).astype(np.float32),
        "view_pos": np.array([*position, 1.0], np.float32),
        "prev_view_proj": np.asarray(prev_view_proj, np.float32),
        "frame_count": np.uint32(frame_count),
        "num_lights": np.uint32(num_lights),
        "view_proj_unjittered": view_proj_unjittered.astype(np.float32),
    }


@dataclasses.dataclass
class CameraController:
    """camera.rs:17-180: stateful fly camera."""

    position: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.0, 0.0, 3.0], np.float32))
    yaw: float = float(np.radians(-90.0))
    pitch: float = 0.0
    prev_view_proj: np.ndarray | None = None

    keys: set = dataclasses.field(default_factory=set)

    SPEED = 2.0
    ROTATE_SPEED = 1.5

    def press(self, key: str):
        self.keys.add(key)

    def release(self, key: str):
        self.keys.discard(key)

    def update(self, dt: float) -> bool:
        """Advance by dt seconds; returns `moved` (resets accumulation,
        state.rs:151-152). A host span, "camera.update"
        (`utils/profiling.py:span`)."""
        with profiling.span("camera.update"):
            return self._update(dt)

    def _update(self, dt: float) -> bool:
        speed = self.SPEED * dt
        rot = self.ROTATE_SPEED * dt
        moved = False

        if "right" in self.keys:
            self.yaw += rot
            moved = True
        if "left" in self.keys:
            self.yaw -= rot
            moved = True
        if "up" in self.keys:
            self.pitch += rot
            moved = True
        if "down" in self.keys:
            self.pitch -= rot
            moved = True
        old_pitch = self.pitch
        self.pitch = float(np.clip(self.pitch, -1.5, 1.5))
        if self.pitch != old_pitch:
            moved = True

        sin_y, cos_y = np.sin(self.yaw), np.cos(self.yaw)
        sin_p, cos_p = np.sin(self.pitch), np.cos(self.pitch)
        forward = np.array([cos_p * cos_y, sin_p, cos_p * sin_y], np.float32)
        forward /= np.linalg.norm(forward)
        right = np.cross(forward, [0.0, 1.0, 0.0])
        right /= np.linalg.norm(right)
        up = np.array([0.0, 1.0, 0.0], np.float32)

        if "w" in self.keys:
            self.position = self.position + forward * speed
            moved = True
        if "s" in self.keys:
            self.position = self.position - forward * speed
            moved = True
        if "d" in self.keys:
            self.position = self.position + right * speed
            moved = True
        if "a" in self.keys:
            self.position = self.position - right * speed
            moved = True
        if "space" in self.keys:
            self.position = self.position + up * speed
            moved = True
        if "shift" in self.keys:
            self.position = self.position - up * speed
            moved = True
        return moved

    def uniform(self, aspect: float, frame_count: int, num_lights: int) -> dict:
        jitter = get_halton_jitter(frame_count, 1, 1)
        cam = build_camera_uniform(
            self.position, self.yaw, self.pitch, aspect, frame_count,
            num_lights, jitter, self.prev_view_proj,
        )
        self.prev_view_proj = cam["view_proj_unjittered"]
        return cam
