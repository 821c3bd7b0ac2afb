"""Host-side 4x4 matrix math (numpy) for scene building and the camera.

Port of the numpy half of `tpu_raytracer/utils/math3d.py`: glam's
column-vector convention (``M @ v``), row-major arrays. The device-side
vector helpers of the reference live in `utils/vec3.py` here.
"""

from __future__ import annotations

import numpy as np


def perspective_rh(fov_y: float, aspect: float, z_near: float,
                   z_far: float) -> np.ndarray:
    """glam `Mat4::perspective_rh` (right-handed, 0..1 depth)."""
    f = 1.0 / np.tan(fov_y / 2.0)
    r = z_far / (z_near - z_far)
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = r
    m[2, 3] = r * z_near
    m[3, 2] = -1.0
    return m


def look_at_rh(eye, center, up) -> np.ndarray:
    """glam `Mat4::look_at_rh`."""
    eye = np.asarray(eye, dtype=np.float32)
    center = np.asarray(center, dtype=np.float32)
    up = np.asarray(up, dtype=np.float32)
    f = center - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4, dtype=np.float32)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -np.dot(s, eye)
    m[1, 3] = -np.dot(u, eye)
    m[2, 3] = np.dot(f, eye)
    return m


def translation(t) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = np.asarray(t, dtype=np.float32)
    return m


def scale(s) -> np.ndarray:
    s = np.asarray(s, dtype=np.float32)
    if s.ndim == 0:
        s = np.array([s, s, s], dtype=np.float32)
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[1, 1], m[2, 2] = s
    return m


def rotation_x(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    m = np.eye(4, dtype=np.float32)
    m[1, 1], m[1, 2], m[2, 1], m[2, 2] = c, -s, s, c
    return m


def rotation_y(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, s, -s, c
    return m


def rotation_z(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[0, 1], m[1, 0], m[1, 1] = c, -s, s, c
    return m


def transform_vector(m: np.ndarray, v):
    v = np.asarray(v, dtype=np.float32)
    return m[:3, :3] @ v
