"""The Cornell box of fast-raytracing-wgpu (src/scene/scenes.rs:9-130):
checker floor, coloured walls, a quad ceiling light, a glass crystal
with a blue sphere light inside and a tall rough-metal box; 1,320
triangles. Instance 6 is the crystal, which config 4 of the reference's
bench moves every frame (`wobble`)."""

from __future__ import annotations

import numpy as np

from ..reference.math3d import (rotation_x, rotation_y, rotation_z, scale,
                                translation)
from . import SceneDesc, shapes

PI = np.pi
CRYSTAL = 6
CRYSTAL_POS = (0.4, -0.5, 0.3)


def describe(config: dict) -> SceneDesc:
    ops = [("mesh", shapes.create_plane()), ("mesh", shapes.create_cube()),
           ("mesh", shapes.create_sphere(3)),
           ("mesh", shapes.create_crystal())]
    plane, cube, sphere, crystal = range(4)
    ops += [("material", m) for m in (
        {"base_color": (0.65, 0.05, 0.05, 1.0)},
        {"base_color": (0.12, 0.45, 0.15, 1.0)},
        {"base_color": (0.73, 0.73, 0.73, 1.0)},
        {"base_color": (0.73, 0.73, 0.73, 1.0), "roughness": 0.99,
         "tex_id": 1},
        {"base_color": (0.8, 0.8, 0.8, 1.0), "metallic": 1.0,
         "roughness": 0.01},
        {"base_color": (0.5, 0.8, 1.0, 1.0), "metallic": 0.0,
         "roughness": 0.0, "ior": 1.5, "transmission": 1.0})]
    red, green, white, checker, metal, glass = range(6)
    ops += [
        ("instance", plane, checker, translation([0, -1, 0]) @ scale(2.0)),
        ("instance", plane, white,
         translation([0, 1, 0]) @ rotation_x(PI) @ scale(2.0)),
        ("instance", plane, white,
         translation([0, 0, -1]) @ rotation_x(PI / 2) @ scale(2.0)),
        ("instance", plane, red,
         translation([-1, 0, 0]) @ rotation_z(-PI / 2) @ scale(2.0)),
        ("instance", plane, green,
         translation([1, 0, 0]) @ rotation_z(PI / 2) @ scale(2.0)),
        ("quad_light", plane,
         translation([0, 0.99, 0]) @ rotation_x(PI) @ scale(0.5),
         [1.0, 1.0, 1.0], 10.0),
        ("instance", crystal, glass,
         translation(list(CRYSTAL_POS)) @ scale(0.5)),
        ("sphere_light", sphere,
         translation(list(CRYSTAL_POS)) @ scale(0.1), [0.02, 0.02, 0.9],
         10.0),
        ("instance", cube, metal,
         translation([-0.35, -0.4 + 0.002, -0.3]) @ rotation_y(0.4)
         @ scale([0.6, 1.2, 0.6])),
    ]
    return SceneDesc(ops, {"position": [0.0, 0.0, 3.0],
                           "yaw": float(np.radians(-90.0)), "pitch": 0.0})


def wobble(base, i: int):
    """Every instance's [I, 3, 4] affine at step i of config 4's sequence:
    the crystal raised by 0.02 (i mod 8) and turned by 0.1 i about y."""
    tf = np.array(base, np.float32, copy=True)
    crystal = (translation([CRYSTAL_POS[0], CRYSTAL_POS[1] + 0.02 * (i % 8),
                            CRYSTAL_POS[2]])
               @ rotation_y(0.1 * i) @ scale(0.5))
    tf[CRYSTAL] = crystal[:3, :4]
    return tf
