"""Hit-point reconstruction from triangle ids (restir.wgsl:383-441,
gbuffer.wgsl:124-174; `tpu_raytracer/ops/hit.py`).

The intersectors return only (t, tri), and inst for an instanced scene.
One row of the scene's shading table (v0/e1/e2, per-vertex normals, uvs
and tangents, material id) gives the exact barycentrics, facing and
interpolated attributes; an instanced scene's rows are object space and
the instance's row maps them to world space. Rows are fetched by the
table gather (`ops/table_gather.py`: kernel K7 on the card) as [C, R],
so every column the shading reads is a contiguous [R] tensor, as the
reference's `fetch_cols` gives them.
"""

from __future__ import annotations

import torch

from . import vec3
from .vec3 import V3
from .trace import table_gather


def fetch_cols(table, idx):
    """table [M, C], idx [R] int32 (already clamped into the table) ->
    list of C contiguous [R] columns of table[idx]."""
    return list(table_gather(table, idx).unbind(0))


def reconstruct_hit(scene, tri_id, ray_o: V3, ray_d: V3, t, inst_id=None):
    """Returns dict: pos/normal/ffnormal/tangent V3, uv ([R], [R]),
    tangent_w [R], mat_id [R] int32, front [R] bool, t [R] (exact).
    The reference's scenes are flattened: inst_id is always None."""
    c = fetch_cols(scene.tri_table, torch.clamp(tri_id, min=0))

    v0 = V3(c[26], c[27], c[28])
    e1 = V3(c[29], c[30], c[31])
    e2 = V3(c[32], c[33], c[34])
    pvec = vec3.cross(ray_d, e2)
    det = vec3.dot(e1, pvec)
    det_ok = torch.abs(det) > 1e-9
    inv_det = torch.where(det_ok, 1.0 / torch.where(det_ok, det, 1.0), 0.0)
    tvec = ray_o - v0
    u = vec3.dot(tvec, pvec) * inv_det
    qvec = vec3.cross(tvec, e1)
    v = vec3.dot(ray_d, qvec) * inv_det
    front = det > 0.0
    t = torch.where(det_ok, vec3.dot(e2, qvec) * inv_det, t)

    w = 1.0 - u - v
    n = V3(c[0], c[1], c[2]) * w + V3(c[3], c[4], c[5]) * u \
        + V3(c[6], c[7], c[8]) * v
    normal = vec3.normalize(n)
    uv_u = c[9] * w + c[11] * u + c[13] * v
    uv_v = c[10] * w + c[12] * u + c[14] * v
    tg = V3(c[15], c[16], c[17]) * w + V3(c[18], c[19], c[20]) * u \
        + V3(c[21], c[22], c[23]) * v
    tangent = vec3.normalize(tg)

    return {
        "pos": ray_o + ray_d * t,
        "normal": normal,
        "ffnormal": vec3.where(front, normal, -normal),
        "uv": (uv_u, uv_v),
        "tangent": tangent,
        "tangent_w": c[24],
        "mat_id": c[25].to(torch.int32),
        "front": front,
        "t": t,
    }


def gather_material(scene, mat_id):
    """Material rows -> dict of lanes (mat_table layout)."""
    m = scene.mat_table.shape[0]
    c = fetch_cols(scene.mat_table, torch.clamp(mat_id, 0, m - 1))
    i32 = torch.int32
    return {
        "base_color": V3(c[0], c[1], c[2]),
        "emissive_factor": V3(c[4], c[5], c[6]),
        "roughness": c[7],
        "metallic": c[8],
        "transmission": c[9],
        "ior": c[10],
        "light_index": c[11].to(i32),
        "tex_id": c[12].to(i32),
        "normal_tex_id": c[13].to(i32),
        "occlusion_tex_id": c[14].to(i32),
        "emissive_tex_id": c[15].to(i32),
        "metallic_roughness_tex_id": c[16].to(i32),
    }


def gather_light(scene, light_idx):
    """Light rows -> dict (position, type, u, area, v, emission)."""
    n = scene.light_table.shape[0]
    c = fetch_cols(scene.light_table, torch.clamp(light_idx, 0, n - 1))
    return {
        "position": V3(c[0], c[1], c[2]),
        "type": c[3].to(torch.int32),
        "u": V3(c[4], c[5], c[6]),
        "area": c[7],
        "v": V3(c[8], c[9], c[10]),
        "emission": V3(c[11], c[12], c[13]),
        "emission_w": c[14],
    }


def apply_normal_map(ffnormal: V3, tangent: V3, tangent_w, normal_map_rgb,
                     has_map):
    """Perturb ffnormal by a tangent-space normal map
    (restir.wgsl:655-671)."""
    normal_local = vec3.normalize(normal_map_rgb * 2.0 - 1.0)
    t_ff = vec3.normalize(tangent - ffnormal * vec3.dot(ffnormal, tangent))
    b_ff = vec3.normalize(vec3.cross(ffnormal, t_ff)) * tangent_w
    perturbed = vec3.normalize(t_ff * normal_local.x + b_ff * normal_local.y
                               + ffnormal * normal_local.z)
    return vec3.where(has_map, perturbed, ffnormal)
