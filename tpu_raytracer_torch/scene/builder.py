"""SceneBuilder: the scene-definition API (src/scene/builder.rs:23-589).

Port of `tpu_raytracer/scene/builder.py`. A flattened build moves every
instance's triangles to world space in one soup, reordered into BVH-DFS
leaf order (spatially tight 128-triangle chunks, the kernels' cull
granularity), and keeps the object-space triangles, shading rows and
instance transforms the refit reads (ops/refit.py). An instanced build
keeps one object-space block per mesh and each instance as a transform
(`_build_instanced`). Either way materials, lights and textures become
tables. Host work is numpy, exactly as in the reference; `build` moves
the result onto a torch device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import bvh as bvh_ops
from ..ops.trace_api import (BRUTE_FORCE_MAX_TRIS, MXUF_MAX_TP, check_mode,
                              pack_triangles)
from ..ops.trace_inst import GROUP, INST_COLS, pack_triangles_instanced
from ..ops.trace_mxu import mode_table
from ..utils import math3d, profiling
from ..utils.resample import resize_u8
from . import light as light_mod
from .geometry import Mesh
from .material import NO_TEXTURE, Material, pack_materials
from .resources import CompiledScene

TEXTURE_SIZE = 1024  # reference: scene/mod.rs TEXTURE_WIDTH/HEIGHT = 1024


def _subdivide_world(bundle, scalars, max_diag):
    """Longest-edge bisection of world triangles whose box diagonal
    exceeds `max_diag`, repeated until none does (the reference's
    builder.py:37-72).

    bundle: [T, 3, 20] per vertex (world pos 3 | world n 3 | world t 3 |
    uv 2 | local pos 3 | local n 3 | local t 3); scalars: [T, 4] per
    triangle (tangent sign, material, instance, primitive). Every
    per-vertex value interpolates linearly, so a midpoint split leaves
    the rendered distribution unchanged; only per-ray rounding moves."""
    while True:
        pos = bundle[:, :, 0:3]
        diag = np.linalg.norm(pos.max(axis=1) - pos.min(axis=1), axis=1)
        big = diag > max_diag
        if not big.any():
            return bundle, scalars
        b, s = bundle[big], scalars[big]
        p = b[:, :, 0:3]
        e_len = np.stack([
            np.linalg.norm(p[:, 1] - p[:, 0], axis=1),
            np.linalg.norm(p[:, 2] - p[:, 1], axis=1),
            np.linalg.norm(p[:, 0] - p[:, 2], axis=1),
        ], axis=1)
        i = np.argmax(e_len, axis=1)          # split edge (i, i+1), keep i+2
        j, k = (i + 1) % 3, (i + 2) % 3
        r = np.arange(len(b))
        vi, vj, vk = b[r, i], b[r, j], b[r, k]
        m = (vi + vj) * 0.5
        bundle = np.concatenate([bundle[~big],
                                 np.stack([vi, m, vk], axis=1),  # CCW kept
                                 np.stack([m, vj, vk], axis=1)], axis=0)
        scalars = np.concatenate([scalars[~big], s, s], axis=0)


def _subdivided(world_v0, world_e1, world_e2, local_v0, local_e1, local_e2,
                tri_table, tri_table_local, tri_inst, tri_prim, tri_local,
                max_diag_frac):
    """The reference's build step 2c (builder.py:404-452): the flattened
    soup's triangles split by `_subdivide_world` at `max_diag_frac` of
    the scene's diagonal. Returns the same arrays for the split soup;
    each triangle keeps its own object-space copy (tri_local = arange)."""
    wv = (world_v0, world_v0 + world_e1, world_v0 + world_e2)
    scene_diag = float(np.linalg.norm(
        np.maximum.reduce(wv).max(axis=0) - np.minimum.reduce(wv).min(axis=0)))
    lv0 = local_v0[tri_local]
    lv = (lv0, lv0 + local_e1[tri_local], lv0 + local_e2[tri_local])
    bundle = np.zeros((len(tri_inst), 3, 20), np.float32)
    for k in range(3):
        bundle[:, k, 0:3] = wv[k]
        bundle[:, k, 3:6] = tri_table[:, k * 3:k * 3 + 3]
        bundle[:, k, 6:9] = tri_table[:, 15 + k * 3:18 + k * 3]
        bundle[:, k, 9:11] = tri_table[:, 9 + k * 2:11 + k * 2]
        bundle[:, k, 11:14] = lv[k]
        bundle[:, k, 14:17] = tri_table_local[:, k * 3:k * 3 + 3]
        bundle[:, k, 17:20] = tri_table_local[:, 15 + k * 3:18 + k * 3]
    scalars = np.stack([tri_table[:, 24], tri_table[:, 25],
                        tri_inst.astype(np.float32),
                        tri_prim.astype(np.float32)], axis=1)
    bundle, scalars = _subdivide_world(bundle, scalars,
                                       max_diag_frac * scene_diag)
    t_total = len(bundle)
    world_v0 = bundle[:, 0, 0:3].copy()
    local_v0 = bundle[:, 0, 11:14].copy()
    tri_table = np.zeros((t_total, 26), np.float32)
    tri_table_local = np.zeros_like(tri_table)
    for k in range(3):
        tri_table[:, k * 3:k * 3 + 3] = bundle[:, k, 3:6]
        tri_table[:, 15 + k * 3:18 + k * 3] = bundle[:, k, 6:9]
        tri_table[:, 9 + k * 2:11 + k * 2] = bundle[:, k, 9:11]
        tri_table_local[:, k * 3:k * 3 + 3] = bundle[:, k, 14:17]
        tri_table_local[:, 15 + k * 3:18 + k * 3] = bundle[:, k, 17:20]
        tri_table_local[:, 9 + k * 2:11 + k * 2] = bundle[:, k, 9:11]
    tri_table[:, 24] = scalars[:, 0]
    tri_table[:, 25] = scalars[:, 1]
    tri_table_local[:, 24:26] = tri_table[:, 24:26]
    return (world_v0, bundle[:, 1, 0:3] - world_v0,
            bundle[:, 2, 0:3] - world_v0, local_v0,
            bundle[:, 1, 11:14] - local_v0, bundle[:, 2, 11:14] - local_v0,
            tri_table, tri_table_local, scalars[:, 2].astype(np.int32),
            scalars[:, 3].astype(np.int32),
            np.arange(t_total, dtype=np.int32))


def _oct_decode_np(e: np.ndarray) -> np.ndarray:
    """Octahedral decode (host, matches gbuffer.wgsl:38-44)."""
    ex, ey = e[:, 0], e[:, 1]
    nz = 1.0 - np.abs(ex) - np.abs(ey)
    t = np.maximum(-nz, 0.0)
    nx = ex + np.where(ex >= 0.0, -t, t)
    ny = ey + np.where(ey >= 0.0, -t, t)
    n = np.stack([nx, ny, nz], axis=-1).astype(np.float32)
    return n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-6)


def _srgb_to_linear(x: np.ndarray) -> np.ndarray:
    """Exact piecewise sRGB EOTF (as hardware Rgba8UnormSrgb decodes)."""
    x = x.astype(np.float32) / 255.0
    return np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)


def _prep_texture(img: np.ndarray, srgb: bool) -> np.ndarray:
    """An image [H, W], [H, W, C] -> [TEXTURE_SIZE, TEXTURE_SIZE, 3] f32,
    linear. uint8 colour is sRGB-decoded, uint8 data is scaled to [0, 1],
    anything else is taken as it is. Another size is clipped to [0, 1],
    truncated to uint8, Lanczos-resized and scaled back, as the
    reference's PIL resize does it (utils/resample.py)."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[:, :, None].repeat(3, axis=2)
    img = img[:, :, :3]
    if img.dtype == np.uint8:
        img = _srgb_to_linear(img) if srgb else img.astype(np.float32) / 255.0
    else:
        img = img.astype(np.float32)
    if img.shape[0] != TEXTURE_SIZE or img.shape[1] != TEXTURE_SIZE:
        u8 = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        img = resize_u8(u8, TEXTURE_SIZE, TEXTURE_SIZE,
                        "lanczos").astype(np.float32) / 255.0
        profiling.SETUP["texture_resizes"] += 1
    return img


def _default_color_textures() -> list:
    """builder.rs:41-75: 0 = white, 1 = 64-px checker, 2 = black."""
    s = TEXTURE_SIZE
    white = np.ones((s, s, 3), np.float32)
    yy, xx = np.meshgrid(np.arange(s), np.arange(s), indexing="ij")
    check = (((xx // 64) + (yy // 64)) % 2 == 0).astype(np.float32)
    checker = np.repeat(check[:, :, None], 3, axis=2)
    black = np.zeros((s, s, 3), np.float32)
    return [white, checker, black]


def _default_data_textures() -> list:
    """builder.rs:77-91: 0 = white, 1 = flat normal, 2 = black (linear)."""
    s = TEXTURE_SIZE
    white = np.ones((s, s, 3), np.float32)
    flat_normal = np.tile(
        np.array([128 / 255.0, 128 / 255.0, 1.0], np.float32), (s, s, 1))
    black = np.zeros((s, s, 3), np.float32)
    return [white, flat_normal, black]


def _cat(xs, width):
    if xs:
        return np.concatenate(xs, axis=0)
    return np.zeros((0, width) if width else (0,), np.float32)


class SceneBuilder:
    def __init__(self):
        self.meshes: list[Mesh] = []
        self.materials: list[Material] = []
        self.instances: list[tuple] = []  # (mesh_id, mat_id, transform 4x4)
        self.lights: list = []
        self.color_textures: list[np.ndarray] = _default_color_textures()
        self.data_textures: list[np.ndarray] = _default_data_textures()

    def add_mesh(self, mesh: Mesh) -> int:
        self.meshes.append(mesh)
        return len(self.meshes) - 1

    def add_material(self, mat: Material) -> int:
        self.materials.append(mat)
        return len(self.materials) - 1

    def add_instance(self, mesh_id: int, mat_id: int,
                     transform: np.ndarray) -> int:
        self.instances.append(
            (mesh_id, mat_id, np.asarray(transform, np.float32)))
        return len(self.instances) - 1

    def add_color_texture(self, img: np.ndarray, srgb: bool = True) -> int:
        with profiling.setup_span("texture_prep"):
            self.color_textures.append(_prep_texture(img, srgb=srgb))
        return len(self.color_textures) - 1

    def add_data_texture(self, img: np.ndarray) -> int:
        with profiling.setup_span("texture_prep"):
            self.data_textures.append(_prep_texture(img, srgb=False))
        return len(self.data_textures) - 1

    def add_quad_light(self, position, u, v, emission) -> int:
        self.lights.append(light_mod.make_quad_light(position, u, v, emission))
        return len(self.lights) - 1

    def add_sphere_light(self, center, radius, emission) -> int:
        self.lights.append(
            light_mod.make_sphere_light(center, radius, emission))
        return len(self.lights) - 1

    def _add_emitter(self, mesh_id, transform, color, intensity) -> None:
        emission_factor = [c * intensity for c in color]
        mat_id = self.add_material(
            Material((1.0, 1.0, 1.0, 1.0))
            .light_index(len(self.lights))
            .emissive(emission_factor)
            .texture(0))
        self.add_instance(mesh_id, mat_id, transform)

    def register_quad_light(self, mesh_id: int, transform: np.ndarray,
                            color, intensity: float) -> None:
        """builder.rs:316-351: emissive material + instance + NEE record."""
        self._add_emitter(mesh_id, transform, color, intensity)
        position = transform[:3, 3]
        u = math3d.transform_vector(transform, [1.0, 0.0, 0.0]) * 0.5
        v = math3d.transform_vector(transform, [0.0, 0.0, -1.0]) * 0.5
        self.add_quad_light(position, u, v,
                            [color[0], color[1], color[2], intensity])

    def register_sphere_light(self, mesh_id: int, transform: np.ndarray,
                              color, intensity: float) -> None:
        """builder.rs:353-385."""
        self._add_emitter(mesh_id, transform, color, intensity)
        position = transform[:3, 3]
        radius = float(np.linalg.norm(
            math3d.transform_vector(transform, [1.0, 0.0, 0.0]))) * 0.5
        self.add_sphere_light(position, radius,
                              [color[0], color[1], color[2], intensity])

    def _pack_tables(self):
        materials = pack_materials(self.materials)
        m = materials["base_color"].shape[0]
        mat_table = np.zeros((m, 17), np.float32)
        mat_table[:, 0:4] = materials["base_color"]
        mat_table[:, 4:7] = materials["emissive_factor"]
        for col, key in enumerate(
                ("roughness", "metallic", "transmission", "ior",
                 "light_index", "tex_id", "normal_tex_id",
                 "occlusion_tex_id", "emissive_tex_id",
                 "metallic_roughness_tex_id"), start=7):
            mat_table[:, col] = materials[key]

        channels = [name for name, key in (
            ("color", "tex_id"), ("normal", "normal_tex_id"),
            ("occlusion", "occlusion_tex_id"),
            ("emissive", "emissive_tex_id"),
            ("metallic_roughness", "metallic_roughness_tex_id"))
            if (materials[key] != NO_TEXTURE).any()]

        lights = light_mod.pack_lights(self.lights)
        nl = lights["position"].shape[0]
        light_table = np.zeros((nl, 15), np.float32)
        light_table[:, 0:3] = lights["position"]
        light_table[:, 3] = lights["type"]
        light_table[:, 4:7] = lights["u"]
        light_table[:, 7] = lights["area"]
        light_table[:, 8:11] = lights["v"]
        light_table[:, 11:15] = lights["emission"]
        return (materials, mat_table, frozenset(channels), lights,
                light_table)

    def _local_triangles(self):
        """Per-mesh object-space triangles, concatenated: (v0, e1, e2
        [TL, 3], first row of each mesh)."""
        local_v0, local_e1, local_e2, mesh_tri_off = [], [], [], []
        t_off = 0
        for mesh in self.meshes:
            mesh_tri_off.append(t_off)
            tri = mesh.indices.reshape(-1, 3)
            p = mesh.positions
            local_v0.append(p[tri[:, 0]])
            local_e1.append(p[tri[:, 1]] - p[tri[:, 0]])
            local_e2.append(p[tri[:, 2]] - p[tri[:, 0]])
            t_off += mesh.num_triangles
        return (_cat(local_v0, 3), _cat(local_e1, 3), _cat(local_e2, 3),
                mesh_tri_off)

    def build(self, device, instancing: str = "auto", kernel: str = "mxuf2",
              incull: bool = False, brute_max: int | None = None,
              subdivide_max_diag: float | None = None) -> CompiledScene:
        """Compile the scene onto `device` (builder.py:255-565 of the
        reference).

        instancing: "auto" | "on" | "off", the reference's rule
        (builder.py:282-305): "on" keeps one object-space block per mesh
        and instances as transforms (`_build_instanced`); "auto" does so
        only when flattening would pass the swept path's triangle cap
        while the unique meshes stay within the instanced block's cap.
        kernel, incull: the trace-kernel mode of a flattened scene's
        queries (`trace_api.trace_route`; the reference's TPU_RT_KERNEL
        and TPU_RT_INCULL), stored on the scene with the coefficient table
        K6 reads when a route of the mode takes it (built once here, as
        the reference's builder builds `coef48` for its mode). Instanced
        scenes keep the mode and ignore it.
        brute_max: the triangle slots past which a flattened scene's
        queries take the BVH walk instead of a sweep under every mode
        (the reference's TPU_RT_BRUTE_MAX; None: BRUTE_FORCE_MAX_TRIS);
        such a scene builds no coefficient table. The instancing="auto"
        rule reads BRUTE_FORCE_MAX_TRIS, as the reference's does.
        subdivide_max_diag: a fraction of the scene's box diagonal; world
        triangles larger than it are split by longest-edge bisection
        before the BVH order is taken (tighter chunk boxes for scenes of
        giant triangles; off by default, as in the reference). The cap
        and the coefficient table see the split scene's slots. An
        instanced build refuses it."""
        if instancing not in ("auto", "on", "off"):
            raise ValueError(f"instancing={instancing!r}")
        brute_max = (BRUTE_FORCE_MAX_TRIS if brute_max is None
                     else int(brute_max))
        if brute_max < 1:
            raise ValueError(f"brute_max={brute_max}: want a positive int")
        mode = {"kernel": check_mode(kernel), "incull": bool(incull),
                "brute_max": brute_max}
        t_world = sum(self.meshes[m].num_triangles
                      for m, _, _ in self.instances)
        used = sorted({m for m, _, _ in self.instances})
        tp_obj = sum(max(-(-self.meshes[m].num_triangles // GROUP), 1)
                     * GROUP for m in used)
        if instancing == "on" or (
                instancing == "auto" and t_world > BRUTE_FORCE_MAX_TRIS
                and tp_obj <= MXUF_MAX_TP):
            if subdivide_max_diag is not None:
                raise ValueError(
                    "subdivide_max_diag is a flattened-mode culling aid")
            return self._build_instanced(device, mode)

        # 1. per-mesh local triangles
        local_v0, local_e1, local_e2, mesh_tri_off = self._local_triangles()

        # 2. flatten instances to a world-space soup; per triangle its
        # instance, primitive and row of local_* (for the refit)
        world_v0, world_e1, world_e2 = [], [], []
        tri_inst, tri_prim, tri_local, inst_nm = [], [], [], []
        for inst_id, (mesh_id, _, tf) in enumerate(self.instances):
            nt = self.meshes[mesh_id].num_triangles
            a, t = tf[:3, :3], tf[:3, 3]
            lo = mesh_tri_off[mesh_id]
            lv0 = local_v0[lo:lo + nt]
            wv0 = lv0 @ a.T + t
            wv1 = (lv0 + local_e1[lo:lo + nt]) @ a.T + t
            wv2 = (lv0 + local_e2[lo:lo + nt]) @ a.T + t
            world_v0.append(wv0)
            world_e1.append(wv1 - wv0)
            world_e2.append(wv2 - wv0)
            tri_inst.append(np.full(nt, inst_id, np.int32))
            tri_prim.append(np.arange(nt, dtype=np.int32))
            tri_local.append(np.arange(lo, lo + nt, dtype=np.int32))
            inst_nm.append(np.linalg.inv(a).T.astype(np.float32))
        world_v0 = _cat(world_v0, 3)
        world_e1 = _cat(world_e1, 3)
        world_e2 = _cat(world_e2, 3)
        tri_inst, tri_prim, tri_local = (_cat(x, 0).astype(np.int32)
                                         for x in (tri_inst, tri_prim,
                                                   tri_local))
        t_total = world_v0.shape[0]

        # 2b. per-triangle shading rows, in world space and (for the refit)
        # object space; normals and tangents stay unnormalized so
        # normalize(interp(..)) matches the reference's
        # transform-after-interpolate order (restir.wgsl:422-431)
        tri_table = np.zeros((max(t_total, 1), 26), np.float32)
        tri_table_local = np.zeros_like(tri_table)
        row = 0
        for (mesh_id, mat_id, _), nm in zip(self.instances, inst_nm):
            mesh = self.meshes[mesh_id]
            nt = mesh.num_triangles
            tri = mesh.indices.reshape(-1, 3).astype(np.int64)
            n_local = _oct_decode_np(mesh.oct_normals)
            t_local = mesh.tangents[:, :3]
            n_world = n_local @ nm.T
            t_world = t_local @ nm.T
            blk = tri_table[row:row + nt]
            blk_l = tri_table_local[row:row + nt]
            for k in range(3):
                blk[:, k * 3:k * 3 + 3] = n_world[tri[:, k]]
                blk_l[:, k * 3:k * 3 + 3] = n_local[tri[:, k]]
                blk[:, 9 + k * 2:11 + k * 2] = mesh.uvs[tri[:, k]]
                blk_l[:, 9 + k * 2:11 + k * 2] = mesh.uvs[tri[:, k]]
                blk[:, 15 + k * 3:18 + k * 3] = t_world[tri[:, k]]
                blk_l[:, 15 + k * 3:18 + k * 3] = t_local[tri[:, k]]
            blk[:, 24] = mesh.tangents[tri[:, 0], 3]   # sign from v0
            blk[:, 25] = mat_id
            blk_l[:, 24:26] = blk[:, 24:26]
            row += nt

        # 2c. optional oversized-triangle subdivision (culling aid)
        if subdivide_max_diag is not None and t_total > 0:
            (world_v0, world_e1, world_e2, local_v0, local_e1, local_e2,
             tri_table, tri_table_local, tri_inst, tri_prim,
             tri_local) = _subdivided(
                world_v0, world_e1, world_e2, local_v0, local_e1, local_e2,
                tri_table, tri_table_local, tri_inst, tri_prim, tri_local,
                subdivide_max_diag)
            t_total = world_v0.shape[0]

        # 3. BVH over the soup; reorder every per-triangle array into its
        # DFS leaf order
        wv1 = world_v0 + world_e1
        wv2 = world_v0 + world_e2
        tree = bvh_ops.build_bvh(
            np.minimum(np.minimum(world_v0, wv1), wv2),
            np.maximum(np.maximum(world_v0, wv1), wv2))
        if t_total > 0:
            order = tree.tri_id[tree.skip < 0].astype(np.int64)
            inv = np.empty_like(order)
            inv[order] = np.arange(t_total, dtype=np.int64)
            world_v0, world_e1, world_e2 = (
                world_v0[order], world_e1[order], world_e2[order])
            tri_inst, tri_prim, tri_local = (
                tri_inst[order], tri_prim[order], tri_local[order])
            tri_table = tri_table[order]
            tri_table_local = tri_table_local[order]
            tree.tri_id[tree.skip < 0] = inv[order].astype(np.int32)
        bvh_ops.fill_triangles(tree, world_v0, world_e1, world_e2)
        tri_planes, chunk_aabb = pack_triangles(world_v0, world_e1, world_e2)

        # shading rows carry world v0 | e1 | e2 (cols 26:35): the kernels
        # return only (t, tri) and ops/hit.py recomputes u/v/front
        geo = (np.concatenate([world_v0, world_e1, world_e2], axis=1)
               if t_total > 0 else np.zeros((tri_table.shape[0], 9),
                                            np.float32))
        tri_table = np.concatenate([tri_table, geo], axis=1)

        # stream row of each triangle's record, where the refit writes it
        bvh_tri_rows = np.zeros((max(t_total, 1),), np.int32)
        tri_rows = np.where(tree.skip < 0)[0]
        if t_total > 0:
            bvh_tri_rows[tree.tri_id[tri_rows]] = tri_rows

        f, i = np.float32, np.int32
        return self._compile(
            device, instanced=False, mode=mode, bvh_max_depth=tree.max_depth,
            tri_planes=tri_planes,
            chunk_aabb=chunk_aabb,
            tri_table=tri_table.astype(f),
            bvh_rec=tree.rec.astype(f),
            bvh_skip=tree.skip.astype(i),
            bvh_tri=tree.tri_id.astype(i),
            bvh_left=tree.box_left.astype(i),
            bvh_right=tree.box_right.astype(i),
            bvh_depth=tree.depth.astype(i),
            bvh_tri_rows=bvh_tri_rows,
            tri_table_local=tri_table_local,
            tri_inst=tri_inst,
            tri_prim=tri_prim,
            tri_local=tri_local,
            local_v0=local_v0.astype(f),
            local_e1=local_e1.astype(f),
            local_e2=local_e2.astype(f),
            **self._instance_fields(inst_nm),
            # the instanced fields' empty forms (builder.py:774-786)
            inst_table=np.zeros((0, INST_COLS), f),
            inst_aabb=np.zeros((0, 8), f),
            obj_group_aabb=np.zeros((8, 0), f),
            inst_group_span=np.zeros((2, 0), i),
            unit_inst=np.zeros((0,), i),
            unit_group=np.zeros((0,), i))

    def _instance_fields(self, normal_mats) -> dict:
        """Per instance: its mesh, its object->world affine [I, 3, 4] and
        the normal matrices `normal_mats` ([3, 3] f32 each), stacked."""
        f = np.float32
        return dict(
            inst_mesh_id=np.asarray([m for m, _, _ in self.instances],
                                    np.int32),
            inst_transform=(np.stack([tf[:3, :4] for _, _, tf in
                                      self.instances]).astype(f)
                            if self.instances else np.zeros((0, 3, 4), f)),
            inst_normal_mat=(np.stack(normal_mats).astype(f) if normal_mats
                             else np.zeros((0, 3, 3), f)))

    def _build_instanced(self, device, mode: dict) -> CompiledScene:
        """Two-level compile (builder.py:567-771 of the reference): one
        object-space block per used mesh, padded to whole groups so no
        group spans two meshes; per instance a world->object affine,
        normal matrix, det sign and material (inst_table), a world AABB
        and the span of its mesh's groups. Hits return (object tri,
        instance); ops/hit.py maps the object-space attributes through
        the instance's row."""
        f, i = np.float32, np.int32
        local_v0, local_e1, local_e2, mesh_tri_off = self._local_triangles()

        # 1. object-space packing per used mesh: N instances of one mesh
        # share its block
        used = sorted({m for m, _, _ in self.instances})
        slot = {m: k for k, m in enumerate(used)}
        mesh_tris, obj_aabb_mesh = [], []
        for m in used:
            lo = mesh_tri_off[m]
            nt = self.meshes[m].num_triangles
            v0 = local_v0[lo:lo + nt]
            e1 = local_e1[lo:lo + nt]
            e2 = local_e2[lo:lo + nt]
            mesh_tris.append((v0, e1, e2))
            vs = np.concatenate([v0, v0 + e1, v0 + e2], axis=0)
            obj_aabb_mesh.append((vs.min(axis=0), vs.max(axis=0)))
        obj_planes, obj_gaabb, spans = pack_triangles_instanced(mesh_tris)

        # 2. object-space shading rows [TpO, 35] at the padded offsets
        # (object tri id = column of obj_planes); col 25 stays unused
        tri_table = np.zeros((obj_planes.shape[2], 35), f)
        tri_prim = np.zeros((obj_planes.shape[2],), i)
        tri_local = np.zeros((obj_planes.shape[2],), i)
        for m in used:
            off = int(spans[0, slot[m]]) * GROUP
            lo = mesh_tri_off[m]
            mesh = self.meshes[m]
            nt = mesh.num_triangles
            tri = mesh.indices.reshape(-1, 3).astype(np.int64)
            n_obj = _oct_decode_np(mesh.oct_normals)
            blk = tri_table[off:off + nt]
            for k in range(3):
                blk[:, k * 3:k * 3 + 3] = n_obj[tri[:, k]]
                blk[:, 9 + k * 2:11 + k * 2] = mesh.uvs[tri[:, k]]
                blk[:, 15 + k * 3:18 + k * 3] = mesh.tangents[tri[:, k], :3]
            blk[:, 24] = mesh.tangents[tri[:, 0], 3]
            blk[:, 26:29] = local_v0[lo:lo + nt]
            blk[:, 29:32] = local_e1[lo:lo + nt]
            blk[:, 32:35] = local_e2[lo:lo + nt]
            tri_prim[off:off + nt] = np.arange(nt, dtype=i)
            tri_local[off:off + nt] = np.arange(lo, lo + nt, dtype=i)

        # 3. per-instance rows, in f64 and stored as f32
        n_inst = len(self.instances)
        inst_table = np.zeros((max(n_inst, 1), INST_COLS), f)
        inst_aabb = np.zeros((max(n_inst, 1), 8), f)
        inst_span = np.zeros((2, max(n_inst, 1)), i)
        unit_inst, unit_group, normal_mats = [], [], []
        for inst_id, (mesh_id, mat_id, tf) in enumerate(self.instances):
            a = tf[:3, :3].astype(np.float64)
            t = tf[:3, 3].astype(np.float64)
            a_inv = np.linalg.inv(a)
            normal_mats.append(a_inv.T)
            inst_table[inst_id, 0:9] = a_inv.reshape(-1)
            inst_table[inst_id, 9:12] = -(a_inv @ t)
            # world n = inv(A)^T @ object n
            inst_table[inst_id, 12:21] = a_inv.T.reshape(-1)
            inst_table[inst_id, 21] = np.sign(np.linalg.det(a)) or 1.0
            inst_table[inst_id, 22] = mat_id
            mn, mx = obj_aabb_mesh[slot[mesh_id]]
            c_w = a @ ((mn + mx) * 0.5) + t
            e_w = np.abs(a) @ ((mx - mn) * 0.5)
            inst_aabb[inst_id, 0:3] = c_w - e_w
            inst_aabb[inst_id, 3:6] = c_w + e_w
            base_g, ng = (int(x) for x in spans[:, slot[mesh_id]])
            inst_span[:, inst_id] = base_g, ng
            unit_inst.extend([inst_id] * ng)
            unit_group.extend(range(base_g, base_g + ng))

        return self._compile(
            device, instanced=True, mode=mode, bvh_max_depth=0,
            tri_planes=obj_planes,
            chunk_aabb=np.zeros((1, 8), f),      # flattened only
            tri_table=tri_table,
            bvh_rec=np.zeros((1, 12), f),        # no world BVH: culling
            bvh_skip=np.full((1,), -1, i),       # is per instance and
            bvh_tri=np.zeros((1,), i),           # per object group
            bvh_left=np.zeros((1,), i),
            bvh_right=np.zeros((1,), i),
            bvh_depth=np.zeros((1,), i),
            bvh_tri_rows=np.zeros((1,), i),
            tri_table_local=np.zeros((1, 26), f),
            tri_inst=np.zeros((1,), i),
            tri_prim=tri_prim,
            tri_local=tri_local,
            local_v0=local_v0.astype(f),
            local_e1=local_e1.astype(f),
            local_e2=local_e2.astype(f),
            **self._instance_fields(normal_mats),
            inst_table=inst_table,
            inst_aabb=inst_aabb,
            obj_group_aabb=obj_gaabb,
            inst_group_span=inst_span,
            unit_inst=np.asarray(unit_inst, i),
            unit_group=np.asarray(unit_group, i))

    def _compile(self, device, instanced: bool, mode: dict,
                 bvh_max_depth: int, **arrays) -> CompiledScene:
        """Move the geometry `arrays` and the material, light and texture
        tables onto `device`, with the trace-kernel `mode`."""
        materials, mat_table, tex_channels, lights, light_table = \
            self._pack_tables()

        def dev(x, dtype=None):
            return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                                   device=device)

        def texels(images):
            # bf16 texels, rounded as the reference rounds them
            # (builder.py:551-554), so sampled values match
            return dev(np.stack(images).astype(np.float32), torch.bfloat16)

        tensors = {k: dev(v) for k, v in arrays.items()}
        return CompiledScene(
            **tensors,
            mat_table=dev(mat_table),
            light_table=dev(light_table),
            materials={k: dev(v) for k, v in materials.items()},
            lights={k: dev(v) for k, v in lights.items()},
            color_tex=texels(self.color_textures),
            data_tex=texels(self.data_textures),
            num_lights=len(self.lights),
            num_instances=len(self.instances),
            bvh_max_depth=int(bvh_max_depth),
            tex_channels=tex_channels,
            instanced=instanced,
            **mode,
            coef48_t=mode_table(tensors["tri_planes"], instanced=instanced,
                                **mode),
        )
