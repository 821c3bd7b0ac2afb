"""Compiled scene resources: the tensors a render consumes.

Port of `tpu_raytracer/scene/resources.py` for flattened scenes: a
dataclass of torch tensors on one device. Table layouts are the
reference's, column for column, so tests compare like with like.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class CompiledScene:
    # triangle planes [4, 3, Tp] f32 (v0 | e1 | e2 | valid row) in BVH-DFS
    # order, and per-128-triangle chunk AABBs [Tp/128, 8] (min xyz, max xyz)
    tri_planes: torch.Tensor
    chunk_aabb: torch.Tensor
    # tri_table [T, 35]: world n0 n1 n2 (9) | uv0 uv1 uv2 (6) |
    # world t0 t1 t2 (9) | tangent sign | mat_id | world v0 e1 e2 (9)
    tri_table: torch.Tensor
    # mat_table [M, 17]: base_color(4) emissive(3) roughness metallic
    #                    transmission ior light_index tex ids(5)
    mat_table: torch.Tensor
    # light_table [L, 15]: position(3) type u(3) area v(3) emission(4)
    light_table: torch.Tensor
    # unified-stream BVH records (ops/bvh.py): [S, 12] f32, [S] i32, [S] i32
    bvh_rec: torch.Tensor
    bvh_skip: torch.Tensor
    bvh_tri: torch.Tensor
    materials: dict          # SoA dict of tensors (material.pack_materials)
    lights: dict             # SoA dict of tensors (light.pack_lights)
    # texture arrays [L, 1024, 1024, 3] bf16 (color pre-decoded to linear)
    color_tex: torch.Tensor
    data_tex: torch.Tensor
    num_lights: int
    # texture channels present anywhere in the scene; sampling for an
    # absent channel is skipped ("color", "normal", "occlusion",
    # "emissive", "metallic_roughness")
    tex_channels: frozenset
