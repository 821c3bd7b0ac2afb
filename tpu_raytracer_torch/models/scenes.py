"""Ready-made scenes (src/scene/scenes.rs; `tpu_raytracer/models/scenes.py`).
Transform composition order is the reference's (T * R * S on column
vectors)."""

from __future__ import annotations

import os

import numpy as np

from ..scene.builder import SceneBuilder
from ..scene.geometry import (create_crystal, create_cube, create_plane,
                              create_sphere)
from ..scene.loader import load_gltf
from ..scene.material import NO_TEXTURE, Material
from ..utils.math3d import hsv_to_rgb, rotation_x, rotation_y, rotation_z, \
    scale, translation

PI = np.pi


def create_cornell_box(device, kernel: str = "mxuf2", incull: bool = False,
                       brute_max: int | None = None,
                       subdivide_max_diag: float | None = None):
    """scenes.rs:9-130: checker floor, colored walls, quad ceiling light,
    glass crystal with an internal blue sphere light, rough-metal tall
    box. 1,320 triangles in 11 chunks of 128. kernel, incull: the
    trace-kernel mode; brute_max: the cap past which queries walk the BVH;
    subdivide_max_diag: split triangles larger than this fraction of the
    scene's diagonal (`SceneBuilder.build`)."""
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

    return b.build(device, kernel=kernel, incull=incull, brute_max=brute_max,
                   subdivide_max_diag=subdivide_max_diag)


def create_cornell_box_diffuse(device, **build):
    """BASELINE config 1: the diffuse-only Cornell box (no glass, metal or
    sphere light): white, red and green walls, the quad ceiling light and
    two white boxes. This builder and those below pass `build` (kernel,
    incull, brute_max) on to `SceneBuilder.build`."""
    b = SceneBuilder()
    plane_id = b.add_mesh(create_plane())
    cube_id = b.add_mesh(create_cube())

    mat_red = b.add_material(Material((0.65, 0.05, 0.05, 1.0)))
    mat_green = b.add_material(Material((0.12, 0.45, 0.15, 1.0)))
    mat_white = b.add_material(Material((0.73, 0.73, 0.73, 1.0)))

    b.add_instance(plane_id, mat_white, translation([0, -1, 0]) @ scale(2.0))
    b.add_instance(plane_id, mat_white,
                   translation([0, 1, 0]) @ rotation_x(PI) @ scale(2.0))
    b.add_instance(plane_id, mat_white,
                   translation([0, 0, -1]) @ rotation_x(PI / 2) @ scale(2.0))
    b.add_instance(plane_id, mat_red,
                   translation([-1, 0, 0]) @ rotation_z(-PI / 2) @ scale(2.0))
    b.add_instance(plane_id, mat_green,
                   translation([1, 0, 0]) @ rotation_z(PI / 2) @ scale(2.0))
    b.register_quad_light(
        plane_id, translation([0, 0.99, 0]) @ rotation_x(PI) @ scale(0.5),
        [1.0, 1.0, 1.0], 10.0)
    b.add_instance(cube_id, mat_white,
                   translation([-0.35, -0.4, -0.3]) @ rotation_y(0.4)
                   @ scale([0.6, 1.2, 0.6]))
    b.add_instance(cube_id, mat_white,
                   translation([0.4, -0.7, 0.3]) @ rotation_y(-0.3)
                   @ scale([0.6, 0.6, 0.6]))
    return b.build(device, **build)


def create_instancing_gallery_scene(device, n: int = 100, subdiv: int = 4,
                                    **build):
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
    return b.build(device, instancing="on", **build)


def create_restir_scene(device, **build):
    """scenes.rs:133-223: 100 colored sphere lights on a 10x10 grid over
    a floor, before a wall, around a metal cube. 32,016 triangles."""
    b = SceneBuilder()
    plane_id = b.add_mesh(create_plane())
    sphere_id = b.add_mesh(create_sphere(2))
    cube_id = b.add_mesh(create_cube())

    mat_floor = b.add_material(
        Material((0.73, 0.73, 0.73, 1.0)).roughness(0.99))
    mat_wall = b.add_material(
        Material((0.73, 0.73, 0.73, 1.0)).roughness(0.99))
    mat_metal = b.add_material(Material((1.0, 1.0, 1.0, 1.0)).metallic(0.2))

    b.add_instance(plane_id, mat_floor, translation([0, -1, 0]) @ scale(10.0))
    b.add_instance(plane_id, mat_wall,
                   translation([0, 5, -5]) @ rotation_x(PI / 2) @ scale(10.0))

    rows = cols = 10
    spacing, light_radius, strength = 1.0, 0.05, 20.0
    for r in range(rows):
        for c in range(cols):
            x = (c - cols / 2.0) * spacing
            z = (r - rows / 2.0) * spacing
            y = -0.9
            color = hsv_to_rgb((r * cols + c) / (rows * cols), 0.8, 1.0)
            mat_id = b.add_material(
                Material((color[0], color[1], color[2], 1.0))
                .light_index(r * cols + c)
                .emissive([ch * strength for ch in color]))
            b.add_instance(sphere_id, mat_id,
                           translation([x, y, z]) @ scale(light_radius))
            b.add_sphere_light([x, y, z], light_radius,
                               [color[0], color[1], color[2], strength])

    b.add_instance(cube_id, mat_metal, translation([0, -0.5, 0]) @ scale(0.5))
    return b.build(device, **build)


def create_bunny_scene(device, subdiv_fallback: int = 4, **build):
    """BASELINE config 3: a dense mesh on a pedestal inside the Cornell
    shell. With no bunny asset, three instances of an icosphere of
    subdivision `subdiv_fallback` stand in (15,372 triangles at 4)."""
    b = SceneBuilder()
    plane_id = b.add_mesh(create_plane())
    dense_id = b.add_mesh(create_sphere(subdiv_fallback))

    mat_white = b.add_material(Material((0.73, 0.73, 0.73, 1.0)))
    mat_red = b.add_material(Material((0.65, 0.05, 0.05, 1.0)))
    mat_green = b.add_material(Material((0.12, 0.45, 0.15, 1.0)))
    mat_body = b.add_material(Material((0.8, 0.7, 0.5, 1.0)).roughness(0.4))

    b.add_instance(plane_id, mat_white, translation([0, -1, 0]) @ scale(2.0))
    b.add_instance(plane_id, mat_white,
                   translation([0, 1, 0]) @ rotation_x(PI) @ scale(2.0))
    b.add_instance(plane_id, mat_white,
                   translation([0, 0, -1]) @ rotation_x(PI / 2) @ scale(2.0))
    b.add_instance(plane_id, mat_red,
                   translation([-1, 0, 0]) @ rotation_z(-PI / 2) @ scale(2.0))
    b.add_instance(plane_id, mat_green,
                   translation([1, 0, 0]) @ rotation_z(PI / 2) @ scale(2.0))
    b.register_quad_light(
        plane_id, translation([0, 0.99, 0]) @ rotation_x(PI) @ scale(0.5),
        [1.0, 1.0, 1.0], 10.0)
    b.add_instance(dense_id, mat_body,
                   translation([0.0, -0.6, 0.0]) @ scale(0.8))
    b.add_instance(dense_id, mat_body,
                   translation([-0.55, -0.8, 0.4]) @ scale(0.4))
    b.add_instance(dense_id, mat_body,
                   translation([0.55, -0.8, -0.4]) @ scale(0.4))
    return b.build(device, **build)


def add_gltf_to_builder(b: SceneBuilder, meshes, materials, images,
                        mat_indices, transform):
    """Register loaded glTF content (builder.rs:191-314): each image once
    per array it lands in (colour images sRGB-decoded into the colour
    array, the rest linear into the data array), the materials with
    their texture ids remapped, the meshes, and one instance per
    primitive with its material."""
    color_map: dict = {}
    data_map: dict = {}

    def remap(img_idx, srgb):
        cache = color_map if srgb else data_map
        if img_idx not in cache:
            cache[img_idx] = (b.add_color_texture(images[img_idx], srgb=True)
                              if srgb else b.add_data_texture(images[img_idx]))
        return cache[img_idx]

    mat_ids = []
    for mat in materials:
        if mat.tex_id != NO_TEXTURE:
            mat.texture(remap(mat.tex_id, srgb=True))
        if mat.normal_tex_id != NO_TEXTURE:
            mat.normal_texture(remap(mat.normal_tex_id, srgb=False))
        if mat.occlusion_tex_id != NO_TEXTURE:
            mat.occlusion_texture(remap(mat.occlusion_tex_id, srgb=False))
        if mat.emissive_tex_id != NO_TEXTURE:
            mat.emissive_texture(remap(mat.emissive_tex_id, srgb=True))
        if mat.metallic_roughness_tex_id != NO_TEXTURE:
            mat.metallic_roughness_texture(
                remap(mat.metallic_roughness_tex_id, srgb=False))
        mat_ids.append(b.add_material(mat))

    mesh_ids = [b.add_mesh(m) for m in meshes]
    for i, mesh_id in enumerate(mesh_ids):
        mat_slot = mat_indices[i] if i < len(mat_indices) else 0
        mat_id = mat_ids[mat_slot] if mat_slot < len(mat_ids) else 0
        b.add_instance(mesh_id, mat_id, transform)
    return mesh_ids, mat_ids


def create_gltf_scene(device, path: str, model_transform=None,
                      light_transform=None, **build):
    """scenes.rs:249-319: a glTF asset on a 10x floor under a quad light
    ([1, 1, 1] x 15). model_transform defaults to the reference's
    translation([0, -0.5, 0]) @ scale(1.0), light_transform to the light
    5 up, facing down. A file that fails to load leaves the
    floor-and-light scene, with a printed note, as the reference does
    (scenes.rs:313)."""
    if model_transform is None:
        model_transform = translation([0, -0.5, 0]) @ scale(1.0)
    if light_transform is None:
        light_transform = (translation([0, 5.0, 0]) @ rotation_x(PI)
                           @ scale(1.0))
    b = SceneBuilder()
    plane_id = b.add_mesh(create_plane())
    mat_floor = b.add_material(
        Material((0.73, 0.73, 0.73, 1.0)).roughness(0.99))
    b.add_instance(plane_id, mat_floor, translation([0, -1, 0]) @ scale(10.0))
    b.register_quad_light(plane_id, light_transform, [1.0, 1.0, 1.0], 15.0)
    try:
        meshes, materials, images, mat_indices = load_gltf(path)
        add_gltf_to_builder(b, meshes, materials, images, mat_indices,
                            model_transform)
    except Exception as e:  # noqa: BLE001 - the reference's fallback
        print(f"glTF load failed ({e}); rendering empty scene")
    return b.build(device, **build)


def _asset_path(canonical: str, procedural_name: str) -> str:
    """The downloaded asset `canonical` if it is there relative to the
    working directory or in assets/models/, else the generated stand-in
    (models/procedural_assets.py), with a printed note, so a named scene
    never quietly becomes the floor-and-light fallback (the reference's
    _asset_path)."""
    from .procedural_assets import MODELS_DIR, ensure_asset

    for cand in (canonical,
                 os.path.join(MODELS_DIR, os.path.basename(canonical))):
        if os.path.exists(cand):
            return cand
    path = ensure_asset(procedural_name)
    print(f"{canonical} not found; using procedural stand-in {path}")
    return path


def create_avocado_scene(device, path: str = None, **build):
    """scenes.rs:321-332: the Avocado glb at 20x on the floor. This and
    the next two wrappers take create_gltf_scene's default light, which is
    the one the reference passes."""
    if path is None:
        path = _asset_path("assets/models/Avocado.glb", "avocado")
    return create_gltf_scene(
        device, path, model_transform=translation([0, 0, 0]) @ scale(20.0),
        **build)


def create_damaged_helmet_scene(device, path: str = None, **build):
    """scenes.rs:334-347: DamagedHelmet rotated upright (Rx(pi/2))."""
    if path is None:
        path = _asset_path("assets/models/DamagedHelmet.glb", "helmet")
    return create_gltf_scene(
        device, path,
        model_transform=(translation([0, 0, 0]) @ rotation_x(PI / 2)
                         @ scale(1.0)), **build)


def create_multi_material_model_scene(device, path: str = None, **build):
    """scenes.rs:349-365: VRM avatar at 0.5x facing the camera (Ry(pi))."""
    if path is None:
        path = _asset_path("assets/models/AliciaSolid.vrm", "figure")
    return create_gltf_scene(
        device, path,
        model_transform=(translation([0, 0, 0]) @ scale(0.5)
                         @ rotation_y(PI)), **build)


def truffle_material_rewrite(mat) -> None:
    """scenes.rs:393-411: luminance-threshold material heuristic.

    Dark base colors (BT.601 luma < 0.25) are "probably the chocolate":
    ultra-gloss dielectric (roughness 0.02, metallic 0); bright ones are
    "probably the ribbon": satin (roughness 0.25)."""
    r, g, bl = mat.base_color[0], mat.base_color[1], mat.base_color[2]
    brightness = r * 0.299 + g * 0.587 + bl * 0.114
    if brightness < 0.25:
        # raw field writes like the reference (not the fluent .metallic(),
        # whose argument is a roughness and which forces metallic=1)
        mat.roughness_ = 0.02
        mat.metallic_ = 0.0
    else:
        mat.roughness_ = 0.25


def create_chocolate_truffle_scene(device, path: str = None, **build):
    """scenes.rs:367-504: the reference's showcase scene. An
    obsidian-table floor, the glTF materials through
    `truffle_material_rewrite`, and a studio of 3 sphere lights (warm key
    x80, red rim x40, blue fill x10). A file that fails to load falls
    back to the avocado scene (scenes.rs:496-500), whose own fallback is
    the floor-and-light scene. With no path, the generated gift-wrapped
    chocolate stands in for the reference's downloaded asset."""
    if path is None:
        path = _asset_path(
            "assets/models/gift_wrapped_chocolate_3d_model.glb", "truffle")
    try:
        meshes, materials, images, mat_indices = load_gltf(path)
    except Exception as e:  # noqa: BLE001 - the reference's fallback
        print(f"Failed to load gift chocolate: {e}")
        return create_avocado_scene(device, **build)

    b = SceneBuilder()
    plane_id = b.add_mesh(create_plane())
    sphere_id = b.add_mesh(create_sphere(4))

    # obsidian table (scenes.rs:433-437)
    mat_dark_floor = b.add_material(
        Material((0.02, 0.02, 0.02, 1.0)).roughness(0.1).metallic(0.8))
    b.add_instance(plane_id, mat_dark_floor,
                   translation([0, -0.01, 0]) @ scale(50.0))

    for mat in materials:
        truffle_material_rewrite(mat)
    add_gltf_to_builder(
        b, meshes, materials, images, mat_indices,
        translation([0, 0.7, 0]) @ rotation_y(0.5) @ scale(4.0))

    # studio lighting (scenes.rs:462-493)
    b.register_sphere_light(
        sphere_id, translation([8.0, 4.0, 2.0]) @ scale(2.0),
        [1.0, 0.95, 0.8], 80.0)
    b.register_sphere_light(
        sphere_id, translation([-3.0, 2.0, -4.0]) @ scale(2.0),
        [1.0, 0.05, 0.01], 40.0)
    b.register_sphere_light(
        sphere_id, translation([-3.0, 1.0, 3.0]) @ scale(1.0),
        [0.01, 0.05, 0.2], 10.0)
    return b.build(device, **build)


def create_dense_knot_scene(device, path: str = None, **build):
    """bench.py config 6: the 100,800-triangle textured trefoil knot
    (base-color, normal and metallic-roughness textures) loaded through
    the glTF loader from the generated asset (models/dense_asset.py),
    on the floor under a quad light: 100,804 world triangles."""
    from .dense_asset import ensure_dense_asset

    if path is None:
        path = ensure_dense_asset()
    return create_gltf_scene(
        device, path,
        model_transform=translation([0, 1.2, 0]) @ scale(1.1),
        light_transform=(translation([0, 5.0, 0]) @ rotation_x(PI)
                         @ scale(1.5)), **build)
