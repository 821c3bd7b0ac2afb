"""Ready-made scenes (src/scene/scenes.rs; `tpu_raytracer/models/scenes.py`).
Transform composition order is the reference's (T * R * S on column
vectors)."""

from __future__ import annotations

import numpy as np

from ..scene.builder import SceneBuilder
from ..scene.geometry import (create_crystal, create_cube, create_plane,
                              create_sphere)
from ..scene.material import Material
from ..utils.math3d import hsv_to_rgb, rotation_x, rotation_y, rotation_z, \
    scale, translation

PI = np.pi


def create_cornell_box(device):
    """scenes.rs:9-130: checker floor, colored walls, quad ceiling light,
    glass crystal with an internal blue sphere light, rough-metal tall
    box. 1,320 triangles in 11 chunks of 128."""
    b = SceneBuilder()

    plane_id = b.add_mesh(create_plane())
    cube_id = b.add_mesh(create_cube())
    sphere_id = b.add_mesh(create_sphere(3))
    crystal_id = b.add_mesh(create_crystal())

    mat_red = b.add_material(Material((0.65, 0.05, 0.05, 1.0)))
    mat_green = b.add_material(Material((0.12, 0.45, 0.15, 1.0)))
    mat_white = b.add_material(Material((0.73, 0.73, 0.73, 1.0)))
    mat_checker = b.add_material(
        Material((0.73, 0.73, 0.73, 1.0)).roughness(0.99).texture(1))
    mat_rough_metal = b.add_material(
        Material((0.8, 0.8, 0.8, 1.0)).metallic(0.01))
    mat_crystal = b.add_material(Material((0.5, 0.8, 1.0, 1.0)).glass(1.5))

    # floor / ceiling / back / left / right
    b.add_instance(plane_id, mat_checker, translation([0, -1, 0]) @ scale(2.0))
    b.add_instance(plane_id, mat_white,
                   translation([0, 1, 0]) @ rotation_x(PI) @ scale(2.0))
    b.add_instance(plane_id, mat_white,
                   translation([0, 0, -1]) @ rotation_x(PI / 2) @ scale(2.0))
    b.add_instance(plane_id, mat_red,
                   translation([-1, 0, 0]) @ rotation_z(-PI / 2) @ scale(2.0))
    b.add_instance(plane_id, mat_green,
                   translation([1, 0, 0]) @ rotation_z(PI / 2) @ scale(2.0))

    # ceiling quad light
    b.register_quad_light(
        plane_id, translation([0, 0.99, 0]) @ rotation_x(PI) @ scale(0.5),
        [1.0, 1.0, 1.0], 10.0)

    # glass crystal + internal blue sphere light
    crystal_pos = [0.4, -0.5, 0.3]
    b.add_instance(crystal_id, mat_crystal,
                   translation(crystal_pos) @ scale(0.5))
    b.register_sphere_light(
        sphere_id, translation(crystal_pos) @ scale(0.1), [0.02, 0.02, 0.9],
        10.0)

    # tall rough-metal box
    b.add_instance(
        cube_id, mat_rough_metal,
        translation([-0.35, -0.4 + 0.002, -0.3]) @ rotation_y(0.4)
        @ scale([0.6, 1.2, 0.6]))

    return b.build(device)


def create_instancing_gallery_scene(device, n: int = 100, subdiv: int = 4):
    """`n` instances of one icosphere on a hsv-tinted grid over a floor,
    under a quad light, built instanced (bench.py config 7). At the
    defaults: 102 instances, 512,004 world triangles in 5,376 object
    triangle slots (21 groups of 256), since the 5,120-triangle sphere
    is stored once."""
    b = SceneBuilder()
    plane_id = b.add_mesh(create_plane())
    dense_id = b.add_mesh(create_sphere(subdiv))

    mat_floor = b.add_material(Material((0.73, 0.73, 0.73, 1.0)))
    b.add_instance(plane_id, mat_floor,
                   translation([0, -1, 0]) @ scale(12.0))
    b.register_quad_light(
        plane_id, translation([0, 6.0, 0]) @ rotation_x(PI) @ scale(3.0),
        [1.0, 1.0, 1.0], 8.0)

    side = int(np.ceil(np.sqrt(n)))
    for i in range(n):
        gx, gz = i % side, i // side
        col = hsv_to_rgb(i / max(n, 1), 0.7, 0.9)
        mat = b.add_material(
            Material((col[0], col[1], col[2], 1.0)).roughness(0.35))
        x = (gx - (side - 1) / 2) * 1.5
        z = (gz - (side - 1) / 2) * 1.5
        b.add_instance(dense_id, mat, translation([x, -0.5, z]) @ scale(0.5))
    return b.build(device, instancing="on")
