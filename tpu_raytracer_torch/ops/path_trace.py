"""Wavefront path tracer (restir.wgsl:460-737;
`tpu_raytracer/ops/path_trace.py`).

From the G-buffer hit (depth 0): NEE+MIS direct light at every diffuse
vertex, BSDF-sampled next direction, Russian roulette from depth 3,
MAX_DEPTH 8. Per-lane RNG consumption matches the reference draw for
draw, so seed-replay ReSTIR reproduces identical paths. Divergence is an
active-lane mask.

Each depth's NEE shadow rays and the next depth's bounce rays ride ONE
closest-hit query (`_dual_trace`). At the last depth (depth + 1 ==
MAX_DEPTH) the bounce half would never be read, so the shadow rays alone
go to an any-hit query instead. The loop runs all MAX_DEPTH depths and
reads nothing back from the device, so a frame can be captured as one
CUDA graph (`render/graph.py`); the reference leaves its loop once every
lane is dead, which changes no result (dead lanes draw no RNG and add
nothing).

Reference quirks kept (they define the target radiance):
  * the bounce loop's `is_specular` reuses the PRIMARY surface's glass
    flag (restir.wgsl:705 uses `is_glass` from :554);
  * the emissive-hit MIS cosine uses `dot(ffnormal, -wo)` (:690), which
    is <= 0 on front hits, so BSDF-sampled light hits after a diffuse
    vertex get MIS weight 0 (NEE carries direct light there);
  * non-light materials in the bounce loop emit only their emissive
    TEXTURE (:675-678); the emissive factor counts at depth 0 only.
"""

from __future__ import annotations

import torch

from ..scene.material import NO_TEXTURE
from ..utils import profiling, rng, vec3
from ..utils.vec3 import V3
from . import bsdf as bsdf_ops
from . import lights as light_ops
from . import textures
from .hit import (apply_normal_map, gather_light, gather_material,
                  reconstruct_hit)
from .trace_api import scene_occluded, scene_trace

MAX_DEPTH = 8          # restir.wgsl:5
RR_START_DEPTH = 3     # restir.wgsl:593
T_MIN = 1e-3
T_MAX = 100.0          # restir.wgsl:605


def _nee_draw(scene, state, active, pos: V3, ffnormal: V3, wo: V3, mat,
              base_color: V3, num_lights: int):
    """NEE light sample with MIS, without its shadow trace
    (restir.wgsl:554-575, 702-724): up to 3 draws per active lane (light
    pick, 2 area samples). Returns (state, shadow ray, pre) where the ray
    is dict(origin, dir, t_max, active) and pre holds the untested
    contribution and the shadow-ray count."""
    r = state.shape[0]
    if num_lights == 0:
        z = torch.zeros((r,), dtype=torch.float32, device=state.device)
        z3 = V3(z, z, z)
        off = torch.zeros((r,), dtype=torch.bool, device=state.device)
        ray = dict(origin=pos, dir=z3, t_max=z, active=off)
        return state, ray, dict(contrib=z3, shadow_active=off,
                                n_rays=z.sum())

    state, r_pick = rng.rand_if(state, active)
    light_idx = torch.floor(r_pick * num_lights).to(torch.int32)
    smp_mask = active & (light_idx < num_lights)
    state, r1 = rng.rand_if(state, smp_mask)
    state, r2 = rng.rand_if(state, smp_mask)

    ls = light_ops.sample_light(gather_light(scene, light_idx), r1, r2)

    pdf_nee = ls["pdf"] * (1.0 / num_lights)
    to_light = vec3.normalize(ls["pos"] - pos)
    p_bsdf = bsdf_ops.eval_pdf(ffnormal, to_light, wo, mat, base_color)
    mis_weight = pdf_nee / torch.clamp(pdf_nee + p_bsdf, min=1e-20)
    weight = mis_weight / torch.clamp(pdf_nee, min=1e-20)

    # eval_direct_lighting (restir.wgsl:443-459)
    offset_pos = pos + ffnormal * 1e-3
    delta = ls["pos"] - offset_pos
    dist = vec3.length(delta)
    l_dir = delta / torch.clamp(dist, min=1e-12)
    n_dot_l = torch.clamp(vec3.dot(ffnormal, l_dir), min=0.0)
    l_dot_n = torch.clamp(vec3.dot(-l_dir, ls["normal"]), min=0.0)
    shadow_active = smp_mask & (n_dot_l > 0.0) & (l_dot_n > 0.0)

    f = bsdf_ops.eval_bsdf(ffnormal, l_dir, wo, mat, base_color)
    g = (n_dot_l * l_dot_n) / torch.clamp(dist * dist, min=1e-12)
    contrib = ls["emission"] * ls["emission_w"] * f * (g * weight)
    ray = dict(origin=offset_pos, dir=l_dir,
               t_max=torch.clamp(dist * 0.999, min=0.0), active=shadow_active)
    return state, ray, dict(contrib=contrib, shadow_active=shadow_active,
                            n_rays=shadow_active.to(torch.float32).sum())


def _nee_apply(pre, blocked):
    return vec3.where(pre["shadow_active"] & ~blocked, pre["contrib"], 0.0)


def _dual_trace(scene, s_ray, b_origin: V3, b_dir: V3, b_active,
                num_lights: int, reorder: str = "none"):
    """ONE closest-hit query for [this depth's shadow rays | the next
    depth's bounce rays] (a windowed closest hit answers occlusion
    exactly). Returns (blocked [R], bounce result)."""
    r = b_active.shape[0]
    if num_lights == 0:
        res = scene_trace(scene, b_origin, b_dir, T_MIN, T_MAX,
                          active=b_active, reorder=reorder)
        return torch.zeros_like(b_active), res
    t_max = torch.cat([s_ray["t_max"], torch.full_like(s_ray["t_max"],
                                                       T_MAX)])
    res = scene_trace(scene, vec3.cat(s_ray["origin"], b_origin),
                      vec3.cat(s_ray["dir"], b_dir), T_MIN, t_max,
                      active=torch.cat([s_ray["active"], b_active]),
                      reorder=reorder)
    blocked = res["tri"][:r] >= 0
    return blocked, {k: v[r:] for k, v in res.items()}


def _shadow_only(scene, s_ray, r: int, device, num_lights: int,
                 reorder: str = "none"):
    """Last depth: the shadow rays alone, as an any-hit query; the bounce
    result is a miss nobody reads."""
    if num_lights == 0:
        blocked = torch.zeros((r,), dtype=torch.bool, device=device)
    else:
        blocked = scene_occluded(scene, s_ray["origin"], s_ray["dir"],
                                 T_MIN, s_ray["t_max"],
                                 active=s_ray["active"], reorder=reorder)
    miss = torch.full((r,), -1, dtype=torch.int32, device=device)
    res = {"t": torch.zeros((r,), dtype=torch.float32, device=device),
           "tri": miss}
    if scene.instanced:
        res["inst"] = miss
    return blocked, res


def _surface_color(scene, mat, uv_u, uv_v) -> V3:
    base_color = mat["base_color"]
    if "color" in scene.tex_channels:
        base_color = base_color * textures.sample_bilinear(
            scene.color_tex, mat["tex_id"], uv_u, uv_v)
    if "occlusion" in scene.tex_channels:
        base_color = base_color * textures.sample_bilinear(
            scene.data_tex, mat["occlusion_tex_id"], uv_u, uv_v).x
    return base_color


def trace_path(scene, gb, view_pos, seed, active=None,
               reorder: str = "none"):
    """Trace one candidate path per lane from the G-buffer surface, as
    the frame's stage "path_trace" (`utils/profiling.py:stage`), which
    nests in its caller's.

    gb: flat G-buffer dict (valid, pos [R,3], oct_normal, uv, albedo,
    mat_id); view_pos: [3] camera position; seed: [R] int64 path seeds
    (uint32 values); active: optional [R] bool ANDed with gb validity
    (masked lanes return zeros); reorder: the ray-stream permutation of
    every trace of the path (`trace_api.scene_trace`), which changes no
    result.

    Returns dict: radiance [R,3], valid_v1 [R], v1_pos [R,3], v1_normal
    [R,3] (the reconnection vertex, restir.wgsl:624-629), rays, the exact
    number of traversal queries (a 0-dim f32 tensor), and state, each
    lane's final RNG state.
    """
    with profiling.stage("path_trace"):
        return _trace_path(scene, gb, view_pos, seed, active, reorder)


def _trace_path(scene, gb, view_pos, seed, active, reorder: str):
    r = gb["pos"].shape[0]
    device = gb["pos"].device
    num_lights = scene.num_lights
    state = rng.u32(seed)

    active = gb["valid"] if active is None else gb["valid"] & active
    pos = vec3.of(gb["pos"])
    ffnormal = vec3.oct_decode(gb["oct_normal"][:, 0], gb["oct_normal"][:, 1])
    uv = (gb["uv"][:, 0], gb["uv"][:, 1])
    front_face = torch.ones((r,), dtype=torch.bool, device=device)

    mat = dict(gather_material(scene, gb["mat_id"]))
    base_color = vec3.of(gb["albedo"])
    mat["base_color"] = base_color

    # metallic-roughness map at depth 0 (restir.wgsl:503-511)
    if "metallic_roughness" in scene.tex_channels:
        mr = textures.sample_bilinear(
            scene.data_tex, mat["metallic_roughness_tex_id"], uv[0], uv[1])
        has_mr = mat["metallic_roughness_tex_id"] != NO_TEXTURE
        mat["metallic"] = torch.where(has_mr, mr.z * mat["metallic"],
                                      mat["metallic"])
        mat["roughness"] = torch.where(has_mr, mr.y * mat["roughness"],
                                       mat["roughness"])

    zeros = torch.zeros((r,), dtype=torch.float32, device=device)
    ones = torch.ones((r,), dtype=torch.float32, device=device)
    accumulated = V3(zeros, zeros, zeros)
    throughput = V3(ones, ones, ones)
    view = V3(*(view_pos[k].expand(r) for k in range(3)))
    wo = vec3.normalize(view - pos)

    # primary emission; light-source pixels terminate (restir.wgsl:522-552)
    emission = mat["emissive_factor"]
    if "emissive" in scene.tex_channels:
        em_tex = textures.sample_bilinear(
            scene.color_tex, mat["emissive_tex_id"], uv[0], uv[1])
        has_em_tex = mat["emissive_tex_id"] != NO_TEXTURE
        emission = emission * vec3.where(has_em_tex, em_tex, 1.0)
    accumulated = accumulated + vec3.where(active, emission, 0.0)
    active = active & ~(active & (mat["light_index"] >= 0))

    # primary NEE draws (restir.wgsl:554-575; traced with the first bounce)
    is_glass_primary = mat["transmission"] > 0.01
    nee_mask = active & ~(is_glass_primary | (mat["roughness"] < 0.05))
    state, s_ray, s_pre = _nee_draw(scene, state, nee_mask, pos, ffnormal,
                                    wo, mat, base_color, num_lights)
    ray_count = s_pre["n_rays"]
    previous_was_diffuse = nee_mask
    thr_pre = throughput

    # primary BSDF sample (restir.wgsl:577-584)
    state, sc = bsdf_ops.sample_bsdf(state, wo, ffnormal, front_face, mat,
                                     base_color, active)
    active = active & ~vec3.all_leq_zero(sc["weight"])
    last_bsdf_pdf = sc["pdf"]
    throughput = throughput * sc["weight"]
    next_dir = sc["wi"]

    origin = pos + ffnormal * torch.sign(vec3.dot(ffnormal, next_dir)) * 1e-3
    blocked, res = _dual_trace(scene, s_ray, origin, next_dir, active,
                               num_lights, reorder)
    accumulated = accumulated + vec3.where(
        nee_mask, _nee_apply(s_pre, blocked), 0.0) * thr_pre

    valid_v1 = torch.zeros((r,), dtype=torch.bool, device=device)
    v1_pos = V3(zeros, zeros, zeros)
    v1_normal = V3(zeros, zeros, zeros)

    # bounce loop, depth 1..MAX_DEPTH-1 (restir.wgsl:590-733), every depth
    # whether or not a lane is alive: lanes that died consume no RNG and
    # add nothing, and a windowed closest hit answers occlusion as the
    # any-hit does, so the reference's early exit changes no result
    for depth in range(1, MAX_DEPTH):
        # Russian roulette (restir.wgsl:593-598), drawn before this
        # depth's hit (already traced) is consumed
        rr_mask = active & (depth >= RR_START_DEPTH)
        state, r_rr = rng.rand_if(state, rr_mask)
        survival = torch.clamp(vec3.vmax(throughput), 0.05, 0.95)
        active = active & ~(rr_mask & (r_rr > survival))
        throughput = vec3.where(rr_mask & active, throughput / survival,
                                throughput)

        ray_count = ray_count + active.to(torch.float32).sum()
        active = active & (res["tri"] >= 0)
        h = reconstruct_hit(scene, res["tri"], origin, next_dir, res["t"],
                            inst_id=res.get("inst"))

        # reconnection vertex (restir.wgsl:624-629)
        if depth == 1:
            valid_v1 = active
            v1_pos = vec3.where(active, h["pos"], v1_pos)
            v1_normal = vec3.where(active, h["normal"], v1_normal)

        wo = -next_dir
        mat = gather_material(scene, h["mat_id"])
        uv_u, uv_v = h["uv"]
        base_color = _surface_color(scene, mat, uv_u, uv_v)

        ffnormal = h["ffnormal"]
        if "normal" in scene.tex_channels:
            nmap = textures.sample_bilinear(
                scene.data_tex, mat["normal_tex_id"], uv_u, uv_v)
            ffnormal = apply_normal_map(
                ffnormal, h["tangent"], h["tangent_w"], nmap,
                mat["normal_tex_id"] != NO_TEXTURE)

        # emissive texture of non-light materials (restir.wgsl:675-678)
        if "emissive" in scene.tex_channels:
            em_tex = textures.sample_bilinear(
                scene.color_tex, mat["emissive_tex_id"], uv_u, uv_v)
            em_mask = active & (mat["light_index"] == -1) & (
                mat["emissive_tex_id"] != NO_TEXTURE)
            accumulated = accumulated + vec3.where(
                em_mask, em_tex, 0.0) * throughput

        # emissive light hit with MIS (restir.wgsl:683-699)
        light_hit = active & (mat["light_index"] >= 0)
        lrow = gather_light(scene, torch.clamp(mat["light_index"], min=0))
        le = lrow["emission"] * lrow["emission_w"]
        light_cos = torch.clamp(vec3.dot(ffnormal, -wo), min=0.0)  # quirk
        p_nee = (1.0 / torch.clamp(lrow["area"], min=1e-12)) * (
            (h["t"] * h["t"]) / torch.clamp(light_cos, min=1e-12)
        ) * (1.0 / max(num_lights, 1))
        mis_light = torch.where(
            light_cos > 1e-3,
            last_bsdf_pdf / torch.clamp(last_bsdf_pdf + p_nee, min=1e-20),
            0.0)
        mis_light = torch.where(previous_was_diffuse, mis_light, 1.0)
        accumulated = accumulated + vec3.where(
            light_hit & h["front"], le * mis_light, 0.0) * throughput
        active = active & ~light_hit

        # NEE draws (restir.wgsl:702-724), primary glass flag quirk
        nee_mask = active & ~(is_glass_primary | (mat["roughness"] < 0.05))
        state, s_ray, s_pre = _nee_draw(scene, state, nee_mask, h["pos"],
                                        ffnormal, wo, mat, base_color,
                                        num_lights)
        ray_count = ray_count + s_pre["n_rays"]
        previous_was_diffuse = torch.where(active, nee_mask,
                                           previous_was_diffuse)
        thr_pre = throughput

        # next BSDF sample (restir.wgsl:727-732)
        state, sc = bsdf_ops.sample_bsdf(state, wo, ffnormal, h["front"],
                                         mat, base_color, active)
        active = active & ~vec3.all_leq_zero(sc["weight"])
        throughput = vec3.where(active, throughput * sc["weight"],
                                throughput)

        origin = h["pos"] + ffnormal * torch.sign(
            vec3.dot(ffnormal, sc["wi"])) * 1e-3
        next_dir = sc["wi"]
        last_bsdf_pdf = sc["pdf"]
        if depth + 1 >= MAX_DEPTH:
            blocked, res = _shadow_only(scene, s_ray, r, device, num_lights,
                                        reorder)
        else:
            blocked, res = _dual_trace(scene, s_ray, origin, next_dir,
                                       active, num_lights, reorder)
        accumulated = accumulated + vec3.where(
            nee_mask, _nee_apply(s_pre, blocked), 0.0) * thr_pre

    return {
        "radiance": vec3.arr(accumulated),
        "valid_v1": valid_v1,
        "v1_pos": vec3.arr(v1_pos),
        "v1_normal": vec3.arr(v1_normal),
        "rays": ray_count,
        "state": state,
    }
