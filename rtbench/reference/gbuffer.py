"""G-buffer pass: primary visibility (gbuffer.wgsl:91-255;
`tpu_raytracer/ops/gbuffer.py`).

One camera ray per pixel, one closest-hit query, then the flat G-buffer:
world position, material id, octahedral (normal-mapped) normal, uv,
albedo and the motion vector `prev_uv - curr_uv`. `pack_gb` packs it into
the reference's [R, 14] row layout.
"""

from __future__ import annotations

import torch

from .tables import NO_TEXTURE
from . import lower, vec3
from .vec3 import V3
from . import textures
from .hit import apply_normal_map, gather_material, reconstruct_hit
from .trace import scene_trace

T_MIN = 1e-3
T_MAX = 1000.0  # gbuffer.wgsl:109


def _mat4_rows(m, x, y, z):
    """Rows of m @ [x, y, z, 1] for [R] components, summed in index
    order."""
    return [((x * m[i, 0] + y * m[i, 1]) + z * m[i, 2]) + m[i, 3]
            for i in range(4)]


def generate_primary_rays(camera, width: int, height: int):
    """gbuffer.wgsl:96-105. Returns (origin V3, direction V3) per
    pixel."""
    with lower.rays():
        return _primary_rays(camera, width, height)


def _primary_rays(camera, width: int, height: int):
    device = camera["ray_matrix"].device
    xs = (torch.arange(width, dtype=torch.float32, device=device) + 0.5) \
        / width
    ys = (torch.arange(height, dtype=torch.float32, device=device) + 0.5) \
        / height
    v, u = torch.meshgrid(ys, xs, indexing="ij")   # [H, W]
    ndc_x = (u * 2.0 - 1.0).reshape(-1)
    ndc_y = (1.0 - v * 2.0).reshape(-1)

    origin = camera["view_inv"][:3, 3]
    # ndc z = 1: z * m[i, 2] is exactly m[i, 2]
    tx, ty, tz, tw = _mat4_rows(camera["ray_matrix"], ndc_x, ndc_y,
                                torch.ones_like(ndc_x))
    direction = vec3.normalize(
        V3(tx / tw - origin[0], ty / tw - origin[1], tz / tw - origin[2]))
    origins = V3(*(origin[k].expand_as(ndc_x) for k in range(3)))
    return origins, direction


def render_gbuffer(scene, camera, width: int, height: int) -> dict:
    """Returns the flat G-buffer dict consumed by trace_path / ReSTIR."""
    ray_o, ray_d = generate_primary_rays(camera, width, height)
    res = scene_trace(scene, ray_o, ray_d, T_MIN, T_MAX)
    valid = res["tri"] >= 0

    h = reconstruct_hit(scene, res["tri"], ray_o, ray_d, res["t"],
                        inst_id=res.get("inst"))
    mat = gather_material(scene, h["mat_id"])
    uv_u, uv_v = h["uv"]

    base_color = mat["base_color"]
    if "color" in scene.tex_channels:
        base_color = base_color * textures.sample_bilinear(
            scene.color_tex, mat["tex_id"], uv_u, uv_v)
    if "occlusion" in scene.tex_channels:
        base_color = base_color * textures.sample_bilinear(
            scene.data_tex, mat["occlusion_tex_id"], uv_u, uv_v).x

    final_normal = h["ffnormal"]
    if "normal" in scene.tex_channels:
        nmap = textures.sample_bilinear(
            scene.data_tex, mat["normal_tex_id"], uv_u, uv_v)
        final_normal = apply_normal_map(
            final_normal, h["tangent"], h["tangent_w"], nmap,
            mat["normal_tex_id"] != NO_TEXTURE)

    # motion vectors (gbuffer.wgsl:227-242)
    p = h["pos"]
    cx, cy, _, cw = _mat4_rows(camera["view_proj"], p.x, p.y, p.z)
    px_, py_, _, pw = _mat4_rows(camera["prev_view_proj"], p.x, p.y, p.z)
    motion = torch.stack([
        ((px_ / pw) * 0.5 + 0.5) - ((cx / cw) * 0.5 + 0.5),
        ((py_ / pw) * -0.5 + 0.5) - ((cy / cw) * -0.5 + 0.5)], dim=-1)

    oct_x, oct_y = vec3.oct_encode(final_normal)
    vm = valid[:, None]
    return {
        "valid": valid,
        "pos": torch.where(vm, vec3.arr(p), 0.0),
        "mat_id": torch.where(valid, h["mat_id"], 0).to(torch.int32),
        "oct_normal": torch.where(vm, torch.stack([oct_x, oct_y], -1), 0.0),
        "uv": torch.where(vm, torch.stack([uv_u, uv_v], -1), 0.0),
        "albedo": torch.where(vm, vec3.arr(base_color), 0.0),
        "motion": torch.where(vm, motion, 0.0),
    }


# Packed G-buffer rows [R, 14]: neighbor passes read one row per tap.
GB_POS = slice(0, 3)
GB_OCT = slice(3, 5)
GB_UV = slice(5, 7)
GB_ALBEDO = slice(7, 10)
GB_MOTION = slice(10, 12)
GB_MAT = 12
GB_VALID = 13
GB_COLS = 14


def pack_gb(gb: dict):
    return torch.cat([
        gb["pos"], gb["oct_normal"], gb["uv"], gb["albedo"], gb["motion"],
        gb["mat_id"].to(torch.float32)[:, None],
        gb["valid"].to(torch.float32)[:, None],
    ], dim=-1)


def unpack_gb(rows):
    return {
        "pos": rows[..., GB_POS],
        "oct_normal": rows[..., GB_OCT],
        "uv": rows[..., GB_UV],
        "albedo": rows[..., GB_ALBEDO],
        "motion": rows[..., GB_MOTION],
        "mat_id": rows[..., GB_MAT].to(torch.int32),
        "valid": rows[..., GB_VALID] > 0.5,
    }
