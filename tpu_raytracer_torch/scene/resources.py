"""Compiled scene resources: the tensors a render consumes.

Port of `tpu_raytracer/scene/resources.py`: a dataclass of torch tensors
on one device. Table layouts are the reference's, column for column, so
tests compare like with like.

A scene is flattened (every instance's triangles in one world-space
soup) or instanced (one object-space block per mesh, shared by its
instances; `instanced` is True). A flattened scene carries the instanced
fields in their empty forms.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..ops.trace_api import BRUTE_FORCE_MAX_TRIS
from ..ops.trace_inst import GROUP


@dataclasses.dataclass
class CompiledScene:
    # triangle planes [4, 3, Tp] f32 (v0 | e1 | e2 | valid row): world
    # space in BVH-DFS order, or, instanced, object space with each mesh
    # padded to whole groups of 256 (ops/trace_inst.py); per-128-triangle
    # chunk AABBs [Tp/128, 8] (min xyz, max xyz; flattened only)
    tri_planes: torch.Tensor
    chunk_aabb: torch.Tensor
    # tri_table [T, 35]: n0 n1 n2 (9) | uv0 uv1 uv2 (6) | t0 t1 t2 (9) |
    # tangent sign | mat_id | v0 e1 e2 (9). World space; instanced: object
    # space at the padded plane offsets, col 25 unused (the material is
    # the instance's, inst_table col 22)
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
    # --- refit (ops/refit.py); flattened unless noted ---
    # box records' children and depth [S] i32 (-1 where none), and the
    # stream row of each triangle's record [T] i32
    bvh_left: torch.Tensor
    bvh_right: torch.Tensor
    bvh_depth: torch.Tensor
    bvh_tri_rows: torch.Tensor
    # tri_table's columns 0:26 in object space [T, 26]
    tri_table_local: torch.Tensor
    # per triangle [T] i32: instance, primitive within its mesh, row of
    # local_*; instanced scenes keep tri_prim and tri_local per object
    # slot [Tp] and tri_inst as [1] zeros
    tri_inst: torch.Tensor
    tri_prim: torch.Tensor
    tri_local: torch.Tensor
    # object-space triangles of every mesh, concatenated [TL, 3] f32
    local_v0: torch.Tensor
    local_e1: torch.Tensor
    local_e2: torch.Tensor
    # per instance: mesh [I] i32, object->world affine [I, 3, 4] and
    # normal matrix inv(A)^T [I, 3, 3] (flattened and instanced)
    inst_mesh_id: torch.Tensor
    inst_transform: torch.Tensor
    inst_normal_mat: torch.Tensor
    # --- two-level instanced intersector (empty when flattened) ---
    # inst_table [I, 23]: world->object A^-1 (9, row-major) | b (3) |
    # normal matrix (9) | det sign | mat_id
    inst_table: torch.Tensor
    inst_aabb: torch.Tensor        # [I, 8] f32 instance world AABBs
    obj_group_aabb: torch.Tensor   # [8, NGO] f32 object group AABBs
    inst_group_span: torch.Tensor  # [2, I] i32 (first group, count)
    # the (instance, group) units in sweep order, which is the tie order
    unit_inst: torch.Tensor        # [NU] i32
    unit_group: torch.Tensor       # [NU] i32
    materials: dict          # SoA dict of tensors (material.pack_materials)
    lights: dict             # SoA dict of tensors (light.pack_lights)
    # texture arrays [L, 1024, 1024, 3] bf16 (color pre-decoded to linear)
    color_tex: torch.Tensor
    data_tex: torch.Tensor
    num_lights: int
    num_instances: int
    # box levels `_refit_boxes` sweeps (0 when instanced)
    bvh_max_depth: int
    # texture channels present anywhere in the scene; sampling for an
    # absent channel is skipped ("color", "normal", "occlusion",
    # "emissive", "metallic_roughness")
    tex_channels: frozenset
    # traces of an instanced scene return (t, object tri, inst)
    instanced: bool
    # the trace-kernel mode of a flattened scene's queries
    # (`ops/trace_api.py:trace_route`), and K6's coefficient table
    # [Tp/128, 8, 4, 32, 16] bf16 (`ops/trace_mxu.py:kernel_table`) when a
    # route of the mode reads it; past `brute_max` triangle slots every
    # query takes the BVH walk (the reference's TPU_RT_BRUTE_MAX)
    kernel: str = "mxuf2"
    incull: bool = False
    coef48_t: Optional[torch.Tensor] = None
    brute_max: int = BRUTE_FORCE_MAX_TRIS

    @property
    def num_triangles(self) -> int:
        """World triangles: each instance counts its mesh's triangles."""
        valid = self.tri_planes[3, 0].cpu()
        if not self.instanced:
            return int(valid.sum())
        per_group = valid.reshape(-1, GROUP).sum(dim=1)
        return int(per_group[self.unit_group.cpu().long()].sum())
