"""The reference's scene tables, worked out from a scene description
(`rtbench/scenes`): the same operations that a scene definition makes on
the program's `SceneBuilder` (meshes, materials, instances, lights,
textures), replayed here in numpy and moved onto a torch device.

The layouts are those the frame reads (the program's table layouts,
column for column: tri_table [T, 35], mat_table [M, 17], light_table
[L, 15], textures [L, 1024, 1024, 3] bf16). Triangles stay in instance
order (the program reorders them into its BVH's order), so a triangle id
here names another triangle than there; nothing compares ids. The
trace tables are this package's own (`trace.chunk_tables`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import math3d
from .trace import chunk_tables

NO_TEXTURE = 0xFFFF
TEXTURE_SIZE = 1024
LIGHT_QUAD, LIGHT_SPHERE = 0, 1

MATERIAL_DEFAULTS = {
    "base_color": (1.0, 1.0, 1.0, 1.0), "emissive_factor": (0.0, 0.0, 0.0),
    "roughness": 0.5, "metallic": 0.0, "transmission": 0.0, "ior": 1.0,
    "light_index": -1, "tex_id": NO_TEXTURE, "normal_tex_id": NO_TEXTURE,
    "occlusion_tex_id": NO_TEXTURE, "emissive_tex_id": NO_TEXTURE,
    "metallic_roughness_tex_id": NO_TEXTURE}
_TEX_KEYS = ("tex_id", "normal_tex_id", "occlusion_tex_id",
             "emissive_tex_id", "metallic_roughness_tex_id")
_CHANNELS = ("color", "normal", "occlusion", "emissive",
             "metallic_roughness")


@dataclasses.dataclass
class RefScene:
    tri_table: torch.Tensor
    mat_table: torch.Tensor
    light_table: torch.Tensor
    # roughness, metallic, transmission [M] f32 by material
    materials: dict
    color_tex: torch.Tensor
    data_tex: torch.Tensor
    num_lights: int
    tex_channels: frozenset
    trace_tris: torch.Tensor
    trace_ids: torch.Tensor
    trace_boxes: torch.Tensor
    # world triangles and per-instance transforms, for the refit's check
    world: np.ndarray            # [T, 3, 3] f32: v0, v1, v2
    inst_transform: np.ndarray   # [I, 3, 4] f32
    inst_normal_mat: np.ndarray  # [I, 3, 3] f32
    instanced: bool = False
    # trace calls made on the scene (each a trace stage of a frame)
    counts: dict = dataclasses.field(
        default_factory=lambda: {"stages": 0})


def _oct_decode(e):
    ex, ey = e[:, 0], e[:, 1]
    nz = 1.0 - np.abs(ex) - np.abs(ey)
    t = np.maximum(-nz, 0.0)
    nx = ex + np.where(ex >= 0.0, -t, t)
    ny = ey + np.where(ey >= 0.0, -t, t)
    n = np.stack([nx, ny, nz], axis=-1).astype(np.float32)
    return n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-6)


def _srgb_to_linear(x):
    x = x.astype(np.float32) / 255.0
    return np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)


def _texture(img, srgb: bool):
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[:, :, None].repeat(3, axis=2)
    img = img[:, :, :3]
    if img.shape[:2] != (TEXTURE_SIZE, TEXTURE_SIZE):
        raise ValueError(f"texture {img.shape}: the reference takes "
                         f"{TEXTURE_SIZE}^2 images only")
    if img.dtype == np.uint8:
        return _srgb_to_linear(img) if srgb else \
            img.astype(np.float32) / 255.0
    return img.astype(np.float32)


def _default_textures():
    s = TEXTURE_SIZE
    yy, xx = np.meshgrid(np.arange(s), np.arange(s), indexing="ij")
    check = (((xx // 64) + (yy // 64)) % 2 == 0).astype(np.float32)
    white = np.ones((s, s, 3), np.float32)
    black = np.zeros((s, s, 3), np.float32)
    flat = np.tile(np.array([128 / 255.0, 128 / 255.0, 1.0], np.float32),
                   (s, s, 1))
    return ([white, np.repeat(check[:, :, None], 3, axis=2), black],
            [white, flat, black])


class _Builder:
    """The description's operations, as the program's builder defines
    them (ids in order of registration)."""

    def __init__(self):
        self.meshes, self.materials, self.instances, self.lights = \
            [], [], [], []
        self.color, self.data = _default_textures()

    def apply(self, op):
        kind, args = op[0], op[1:]
        if kind == "mesh":
            self.meshes.append(args[0])
        elif kind == "material":
            self.materials.append({**MATERIAL_DEFAULTS, **args[0]})
        elif kind == "instance":
            mesh, mat, tf = args
            self.instances.append((mesh, mat, np.asarray(tf, np.float32)))
        elif kind == "color_texture":
            self.color.append(_texture(args[0], srgb=args[1]))
        elif kind == "data_texture":
            self.data.append(_texture(args[0], srgb=False))
        elif kind in ("quad_light", "sphere_light"):
            self._light(kind, *args)
        elif kind == "gltf":
            for sub in args[0].expand():
                self.apply(sub)
        else:
            raise ValueError(f"unknown scene operation {kind!r}")

    def _light(self, kind, mesh, tf, color, intensity):
        tf = np.asarray(tf, np.float32)
        self.materials.append({
            **MATERIAL_DEFAULTS, "light_index": len(self.lights),
            "emissive_factor": tuple(c * intensity for c in color),
            "tex_id": 0})
        self.instances.append((mesh, len(self.materials) - 1, tf))
        pos = tf[:3, 3]
        emission = (*color, intensity)
        if kind == "quad_light":
            u = math3d.transform_vector(tf, [1.0, 0.0, 0.0]) * 0.5
            v = math3d.transform_vector(tf, [0.0, 0.0, -1.0]) * 0.5
            area = float(np.linalg.norm(np.cross(
                np.asarray(u, np.float32), np.asarray(v, np.float32))) * 4.0)
            self.lights.append((pos, LIGHT_QUAD, u, area, v, emission))
        else:
            radius = float(np.linalg.norm(
                math3d.transform_vector(tf, [1.0, 0.0, 0.0]))) * 0.5
            self.lights.append((pos, LIGHT_SPHERE, (0.0, 0.0, 0.0),
                                float(4.0 * np.pi * radius * radius),
                                (radius, 0.0, 0.0), emission))


def instance_transforms(desc) -> np.ndarray:
    """Every instance's [I, 3, 4] affine, as the description places
    them (light emitters included, in order of registration)."""
    out = []
    for op in desc.ops:
        if op[0] == "instance":
            out.append(np.asarray(op[3], np.float32)[:3, :4])
        elif op[0] in ("quad_light", "sphere_light"):
            out.append(np.asarray(op[2], np.float32)[:3, :4])
        elif op[0] == "gltf":
            out += [np.asarray(sub[3], np.float32)[:3, :4]
                    for sub in op[1].expand() if sub[0] == "instance"]
    return np.stack(out)


def build(desc, device, transforms=None) -> RefScene:
    """The reference scene of description `desc` on `device`;
    `transforms`: every instance's [I, 3, 4] affine in place of the
    description's (a refit's moved instances)."""
    b = _Builder()
    for op in desc.ops:
        b.apply(op)
    mats = b.materials or [dict(MATERIAL_DEFAULTS)]
    mat_table = np.zeros((len(mats), 17), np.float32)
    for i, m in enumerate(mats):
        mat_table[i, 0:4] = m["base_color"]
        mat_table[i, 4:7] = m["emissive_factor"]
        mat_table[i, 7:17] = [m[k] for k in (
            "roughness", "metallic", "transmission", "ior", "light_index",
            *_TEX_KEYS)]
    channels = frozenset(
        name for name, key in zip(_CHANNELS, _TEX_KEYS)
        if any(m[key] != NO_TEXTURE for m in mats))
    light_table = np.zeros((max(len(b.lights), 1), 15), np.float32)
    light_table[:, 7] = 1.0
    for i, (pos, typ, u, area, v, em) in enumerate(b.lights):
        light_table[i] = [*pos, typ, *u, area, *v, *em]

    tfs = [tf[:3, :4] for _, _, tf in b.instances]
    if transforms is not None:
        tfs = [np.asarray(t, np.float32)[:3, :4] for t in transforms]
    rows, world, first, normal_mats = [], [], [], []
    n_tri = 0
    for (mesh_id, mat_id, _), tf in zip(b.instances, tfs):
        mesh = b.meshes[mesh_id]
        a, t = tf[:3, :3], tf[:3, 3]
        nm = np.linalg.inv(a).T.astype(np.float32)
        normal_mats.append(nm)
        tri = mesh["indices"].reshape(-1, 3).astype(np.int64)
        p = mesh["positions"]
        wv = [p[tri[:, k]] @ a.T + t for k in range(3)]
        world.append(np.stack(wv, axis=1))
        n_local = _oct_decode(mesh["oct_normals"])
        n_world = n_local @ nm.T
        t_world = mesh["tangents"][:, :3] @ nm.T
        blk = np.zeros((len(tri), 35), np.float32)
        for k in range(3):
            blk[:, k * 3:k * 3 + 3] = n_world[tri[:, k]]
            blk[:, 9 + k * 2:11 + k * 2] = mesh["uvs"][tri[:, k]]
            blk[:, 15 + k * 3:18 + k * 3] = t_world[tri[:, k]]
        blk[:, 24] = mesh["tangents"][tri[:, 0], 3]
        blk[:, 25] = mat_id
        blk[:, 26:29] = wv[0]
        blk[:, 29:32] = wv[1] - wv[0]
        blk[:, 32:35] = wv[2] - wv[0]
        rows.append(blk)
        first.append(n_tri)
        n_tri += len(tri)
    tri_table = np.concatenate(rows).astype(np.float32)
    world = np.concatenate(world).astype(np.float32)
    tris, ids, boxes = chunk_tables(tri_table[:, 26:29], tri_table[:, 29:32],
                                    tri_table[:, 32:35], first, device)

    def dev(x, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                               device=device)

    return RefScene(
        tri_table=dev(tri_table), mat_table=dev(mat_table),
        light_table=dev(light_table),
        materials={k: dev(mat_table[:, 7 + i])
                   for i, k in enumerate(("roughness", "metallic",
                                          "transmission"))},
        color_tex=dev(np.stack(b.color), torch.bfloat16),
        data_tex=dev(np.stack(b.data), torch.bfloat16),
        num_lights=len(b.lights), tex_channels=channels,
        trace_tris=tris, trace_ids=ids, trace_boxes=boxes,
        world=world, inst_transform=np.stack(tfs).astype(np.float32),
        inst_normal_mat=np.stack(normal_mats))
