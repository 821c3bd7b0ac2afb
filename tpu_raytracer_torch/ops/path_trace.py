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

Route by device, as every kernel of the port:
  - CPU tensors: `trace_path_plain`, the eager PyTorch version below;
  - CUDA tensors: kernel K9 (`csrc/path_trace.cu`, `trace_path_kernel`),
    or the call raises. The same queries go through `scene_trace` (the
    trace kernels); K9 does all the shading around them, in 9 launches a
    call: `prime` (depth 0), `bounce` after each of the 7 queries of
    depths 1-7, and `finish` after the last depth's any-hit query. The
    launches are counted in `trace_api.LAUNCHES` ("path_prime",
    "path_bounce", "path_finish").
K9 reproduces the eager version's arithmetic on the card op for op (f32,
the same order and constants, a tensor over a Python float as PyTorch's
CUDA kernel computes it, a product with the f32 reciprocal), the RNG
draws in its order and count, the zero terms it adds to dead lanes, and
`rays` as its f32 sum of exact per-depth counts.

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

import ctypes

import torch

from ..scene.material import NO_TEXTURE
from ..utils import profiling, rng, vec3
from ..utils.vec3 import V3
from . import bsdf as bsdf_ops
from . import lights as light_ops
from . import textures
from .hit import (apply_normal_map, gather_light, gather_material,
                  reconstruct_hit)
from .trace_api import count_launch, load_kernels, scene_occluded, scene_trace

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
    nests in its caller's: `trace_path_plain` on CPU tensors, K9
    (`trace_path_kernel`) on CUDA tensors.

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
        if gb["pos"].device.type == "cpu":
            return trace_path_plain(scene, gb, view_pos, seed, active,
                                    reorder)
        return trace_path_kernel(scene, gb, view_pos, seed, active, reorder)


def trace_path_plain(scene, gb, view_pos, seed, active=None,
                     reorder: str = "none"):
    """`trace_path` in eager PyTorch ops, on any device: the CPU route,
    and on the card the yardstick K9 is held to."""
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


# ---------------------------------------------------------------------------
# K9 (CUDA tensors)
# ---------------------------------------------------------------------------

# scene.tex_channels as K9's bit mask (csrc/path_trace.cu: TEX_*)
TEX_BITS = {"color": 1, "occlusion": 2, "normal": 4, "emissive": 8,
            "metallic_roughness": 16}

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float


class PathArgs(ctypes.Structure):
    """csrc/path_trace.cu:PathArgs, field for field."""
    _fields_ = [
        *((n, _P) for n in ("tri_table", "inst_table", "mat_table",
                            "light_table", "color_tex", "data_tex")),
        *((n, _I) for n in ("tri_cols", "inst_cols", "mat_cols",
                            "light_cols", "n_inst", "n_mat", "n_light",
                            "num_lights", "c_layers", "c_h", "c_w",
                            "d_layers", "d_h", "d_w", "tex", "instanced",
                            "R", "N")),
        ("inv_lights", _F),
        *((n, _P) for n in ("gb_pos", "gb_oct", "gb_uv", "gb_albedo",
                            "gb_mat", "gb_valid", "mask", "seed", "view")),
        *((n, _L) for n in ("pos_s0", "pos_s1", "oct_s0", "oct_s1", "uv_s0",
                            "uv_s1", "alb_s0", "alb_s1", "mat_s", "valid_s",
                            "mask_s", "seed_s", "view_s")),
        *((n, _P) for n in ("rng", "flags", "thr", "acc", "nee", "pdf",
                            "ray_o", "ray_d", "t_min", "t_max", "hit_t",
                            "hit_tri", "hit_inst", "so", "sd", "s_tmax",
                            "occ", "radiance", "valid_v1", "v1_pos",
                            "v1_normal", "state", "rays", "counts")),
    ]


def _table(t, name):
    """(pointer, rows, cols) of a scene table as K9 reads it."""
    if t.dim() != 2 or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{name}: want a contiguous f32 [rows, cols] table, "
                         f"got {t.dtype} {tuple(t.shape)}")
    return t.data_ptr(), t.shape[0], t.shape[1]


def _texture(t, name):
    """(pointer, layers, height, width) of a texture array."""
    if t.dim() != 4 or t.shape[3] != 3 or t.dtype != torch.bfloat16 \
            or not t.is_contiguous():
        raise ValueError(f"{name}: want a contiguous bf16 [L, H, W, 3] "
                         f"array, got {t.dtype} {tuple(t.shape)}")
    return t.data_ptr(), t.shape[0], t.shape[1], t.shape[2]


def trace_path_kernel(scene, gb, view_pos, seed, active=None,
                      reorder: str = "none"):
    """`trace_path` on CUDA tensors: K9's 9 launches around the same
    queries as the eager version's (`scene_trace`, `reorder` as there),
    each counted in `trace_api.LAUNCHES`. The scene's tables and textures,
    gb, view_pos, seed and active must lie on one CUDA device; raises on
    anything else."""
    device = gb["pos"].device
    if device.type != "cuda":
        raise ValueError(f"trace_path_kernel needs CUDA tensors, got {device}")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        return run_k9(load_kernels(), stream, count_launch, scene, gb,
                      view_pos, seed, active, reorder)


def run_k9(lib, stream, launched, scene, gb, view_pos, seed, active,
           reorder: str):
    """K9's launches from `lib` on `stream` (a handle, or None for the
    host emulation of the tests), `launched(name)` after each. Lane state
    lives in SoA buffers allocated once a call; nothing is read back to
    the host, so the call captures into a CUDA graph."""
    device = gb["pos"].device
    r = gb["pos"].shape[0]
    if r >= 2 ** 30:
        raise ValueError(f"{r} lanes exceed K9's int32 columns")
    f32, i32 = torch.float32, torch.int32
    lights = scene.num_lights > 0
    n = 2 * r if lights else r

    def empty(*shape, dtype=f32):
        return torch.empty(shape, dtype=dtype, device=device)

    def launch(fn, name, *extra):
        err = fn(ctypes.addressof(args), *extra, stream)
        if err != 0:
            raise RuntimeError(f"{name} launch failed: CUDA error {err}")
        launched(name)

    for t in (scene.tri_table, scene.mat_table, scene.light_table,
              scene.inst_table, scene.color_tex, scene.data_tex):
        if t.device != device:
            raise ValueError(f"the scene lies on {t.device}, the lanes on "
                             f"{device}")
    tri, _, tri_cols = _table(scene.tri_table, "tri_table")
    mat, n_mat, mat_cols = _table(scene.mat_table, "mat_table")
    light, n_light, light_cols = _table(scene.light_table, "light_table")
    inst, n_inst, inst_cols = _table(scene.inst_table, "inst_table")
    if n_mat == 0 or n_light == 0 or (scene.instanced and n_inst == 0):
        raise ValueError("K9 needs tables of at least one row")
    ctex, c_layers, c_h, c_w = _texture(scene.color_tex, "color_tex")
    dtex, d_layers, d_h, d_w = _texture(scene.data_tex, "data_tex")
    args = PathArgs(
        tri_table=tri, inst_table=inst, mat_table=mat, light_table=light,
        color_tex=ctex, data_tex=dtex, tri_cols=tri_cols,
        inst_cols=inst_cols, mat_cols=mat_cols, light_cols=light_cols,
        n_inst=n_inst, n_mat=n_mat, n_light=n_light,
        num_lights=scene.num_lights, c_layers=c_layers, c_h=c_h, c_w=c_w,
        d_layers=d_layers, d_h=d_h, d_w=d_w,
        tex=sum(TEX_BITS[c] for c in scene.tex_channels),
        instanced=int(scene.instanced), R=r, N=n,
        inv_lights=1.0 / max(scene.num_lights, 1))

    # the call's inputs, read in place through their element strides
    seed = seed.to(torch.int64)
    for field, x, dtype, shape, strides in (
            ("gb_pos", gb["pos"], f32, (r, 3), ("pos_s0", "pos_s1")),
            ("gb_oct", gb["oct_normal"], f32, (r, 2), ("oct_s0", "oct_s1")),
            ("gb_uv", gb["uv"], f32, (r, 2), ("uv_s0", "uv_s1")),
            ("gb_albedo", gb["albedo"], f32, (r, 3), ("alb_s0", "alb_s1")),
            ("gb_mat", gb["mat_id"], i32, (r,), ("mat_s",)),
            ("gb_valid", gb["valid"], torch.bool, (r,), ("valid_s",)),
            ("seed", seed, torch.int64, (r,), ("seed_s",)),
            ("view", view_pos, f32, (3,), ("view_s",)),
            ("mask", active, torch.bool, (r,), ("mask_s",))):
        if x is None:           # no mask: every lane
            continue
        if x.device != device or x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"{field}: want {dtype} {shape} on {device}, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")
        setattr(args, field, x.data_ptr())
        for name, stride in zip(strides, x.stride()):
            setattr(args, name, stride)

    # lane state, the queries' rays and the outputs
    bufs = {"rng": empty(r, dtype=i32), "flags": empty(r, dtype=i32),
            "thr": empty(3, r), "acc": empty(3, r), "nee": empty(3, r),
            "pdf": empty(r), "ray_o": empty(3, n), "ray_d": empty(3, n),
            "t_min": empty(n), "t_max": empty(n), "so": empty(3, r),
            "sd": empty(3, r), "s_tmax": empty(r),
            "counts": empty(2 * MAX_DEPTH, dtype=i32)}
    out = {"radiance": empty(r, 3), "valid_v1": empty(r, dtype=torch.bool),
           "v1_pos": empty(r, 3), "v1_normal": empty(r, 3),
           "rays": empty(), "state": empty(r, dtype=torch.int64)}
    for k, v in {**bufs, **out}.items():
        setattr(args, k, v.data_ptr())

    launch(lib.tpurt_path_prime, "path_prime")
    for depth in range(1, MAX_DEPTH):
        res = scene_trace(scene, bufs["ray_o"], bufs["ray_d"], bufs["t_min"],
                          bufs["t_max"], reorder=reorder)
        args.hit_t = res["t"].data_ptr()
        args.hit_tri = res["tri"].data_ptr()
        args.hit_inst = res["inst"].data_ptr() if scene.instanced else None
        launch(lib.tpurt_path_bounce, "path_bounce", depth)
    if lights:
        occ = scene_trace(scene, bufs["so"], bufs["sd"], bufs["t_min"][:r],
                          bufs["s_tmax"], any_hit=True, reorder=reorder)
        args.occ = occ["tri"].data_ptr()
    launch(lib.tpurt_path_finish, "path_finish")
    return out
