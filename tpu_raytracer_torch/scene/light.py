"""Analytic light records (src/scene/light.rs:1-16).

Two light types:
  - quad  (type 0): `u`/`v` are half-extent vectors, area = 4*|u x v|
    (builder.rs:392-415)
  - sphere (type 1): radius stored in `v.x`, area = 4*pi*r^2
    (builder.rs:418-429)
Emission is rgb + intensity in `.a`.
"""

from __future__ import annotations

import dataclasses

import numpy as np

LIGHT_QUAD = 0
LIGHT_SPHERE = 1


@dataclasses.dataclass
class Light:
    position: tuple
    type_: int
    u: tuple
    area: float
    v: tuple
    emission: tuple  # (r, g, b, intensity)


def make_quad_light(position, u, v, emission) -> Light:
    u_np = np.asarray(u, np.float32)
    v_np = np.asarray(v, np.float32)
    area = float(np.linalg.norm(np.cross(u_np, v_np)) * 4.0)
    return Light(tuple(position), LIGHT_QUAD, tuple(u), area, tuple(v), tuple(emission))


def make_sphere_light(center, radius, emission) -> Light:
    area = float(4.0 * np.pi * radius * radius)
    return Light(
        tuple(center), LIGHT_SPHERE, (0.0, 0.0, 0.0), area,
        (float(radius), 0.0, 0.0), tuple(emission),
    )


def pack_lights(lights: list) -> dict:
    n = max(len(lights), 1)
    out = {
        "position": np.zeros((n, 3), np.float32),
        "type": np.zeros((n,), np.int32),
        "u": np.zeros((n, 3), np.float32),
        "area": np.ones((n,), np.float32),
        "v": np.zeros((n, 3), np.float32),
        "emission": np.zeros((n, 4), np.float32),
    }
    for i, l in enumerate(lights):
        out["position"][i] = l.position
        out["type"][i] = l.type_
        out["u"][i] = l.u
        out["area"][i] = l.area
        out["v"][i] = l.v
        out["emission"][i] = l.emission
    return out
