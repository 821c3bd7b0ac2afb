"""ReSTIR: seed-replay reservoir resampling, temporal and spatial
(restir.wgsl:788-918, restir_spatial.wgsl:857-1016;
`tpu_raytracer/ops/restir.py`).

A reservoir stores the winning path SEED `y` plus its cached p_hat and
first-bounce vertex `s_path`; the final shade re-traces the winner from
its seed. Candidate seeds are `pcg_hash(pixel + frame * 927163)`; reuse
decisions draw from the separate raw-LCG stream. Spatial taps run in the
reference's sequential order (tap i+1's draws depend on tap i's
visibility result), or with `make_ctx(tap_batch=True)` as the reference's
batched taps: all five prepared first, their visibility in one any-hit
call over a pixel-interleaved stream of 5R rays (`_tap_stream`). On CUDA
tensors the sequential taps' preparation, merges and finalize run as
kernel K11 (`csrc/spatial.cu`, `restir_spatial_kernel`) between the same
queries; CPU tensors and the batched taps run the eager version,
`restir_spatial_plain`.

Seeds are int64 tensors holding uint32 values; in the packed [N, 12]
reservoir rows the seed rides as the f32 bit pattern of its uint32, as in
the reference, so packed rows compare bit for bit.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..parallel.views import BandView, PairBandView
from ..utils import rng, vec3
from ..utils.vec3 import V3
from . import path_trace
from .gbuffer import GB_ALBEDO, GB_COLS, GB_MAT, GB_OCT, GB_POS, GB_VALID
from .post import _rows
from .trace_api import REORDERS, count_launch, load_kernels, scene_occluded

MAX_M_TEMPORAL = 16   # restir.wgsl:851
MAX_M_SPATIAL = 20    # restir_spatial.wgsl:893,989
MAX_W = 20.0          # restir_spatial.wgsl:1005
RES_COLS = 12
# bands of more lanes keep the sequential taps under tap_batch (the
# reference's gate, restir.py:428-431: 3840x2160 stays sequential)
TAP_BATCH_MAX_LANES = 4 * 1024 * 1024
TAPS = 5


def _gb_head(c):
    """G-buffer head of a packed [GB_COLS + RES_COLS] column list."""
    p, o, a = GB_POS.start, GB_OCT.start, GB_ALBEDO.start
    return dict(
        pos=V3(c[p], c[p + 1], c[p + 2]),
        norm=vec3.oct_decode(c[o], c[o + 1]),
        albedo=V3(c[a], c[a + 1], c[a + 2]),
        mat=c[GB_MAT].to(torch.int32),
        valid=c[GB_VALID] > 0.5,
    )


def make_ctx(width: int, height: int, device, y0: int = 0,
             band_h: int | None = None, tap_batch: bool = False,
             reorder: str = "none") -> dict:
    """The band context: the full image's size, the band of rows
    [y0, y0 + band_h) this device renders (the whole image by default),
    whether the spatial taps are batched (`tap_batch_on`; off by
    default, as in the reference), and the ray-stream permutation of
    every secondary trace (`trace_api.scene_trace(reorder=)`: "none", the
    default as in the reference, "live" or "bins"; the G-buffer's primary
    rays stay in order). A permutation changes no result."""
    if reorder not in REORDERS:
        raise ValueError(f"reorder={reorder!r}: want one of {REORDERS}")
    return {"width": width, "height": height, "device": device, "y0": y0,
            "band_h": height if band_h is None else band_h,
            "tap_batch": bool(tap_batch), "reorder": reorder}


def tap_batch_on(ctx) -> bool:
    """The reference's gate (restir.py:428-431): batched taps when the
    ctx asks for them and the band has at most TAP_BATCH_MAX_LANES
    lanes."""
    return (ctx.get("tap_batch", False)
            and ctx["band_h"] * ctx["width"] <= TAP_BATCH_MAX_LANES)


def _global_coords(ctx):
    """Per-lane global pixel coords and flat index of the band, so every
    RNG stream stays keyed by the global pixel."""
    n = ctx["band_h"] * ctx["width"]
    local = torch.arange(n, dtype=torch.int64, device=ctx["device"])
    gx = local % ctx["width"]
    gy = ctx["y0"] + local // ctx["width"]
    return gx, gy, gy * ctx["width"] + gx


def empty_reservoirs(n: int, device) -> dict:
    z = torch.zeros((n,), dtype=torch.float32, device=device)
    return {
        "y": torch.zeros((n,), dtype=torch.int64, device=device),
        "w_sum": z,
        "M": torch.zeros((n,), dtype=torch.int32, device=device),
        "W": z,
        "p_hat": z,
        "s_path": V3(z, z, z),
        # replay-dedup cache: `rad` is the radiance of seed `y` traced
        # from THIS pixel; `rad_ok` marks it valid for this frame's replay
        "rad": V3(z, z, z),
        "rad_ok": torch.zeros((n,), dtype=torch.bool, device=device),
    }


def _seed_to_f32(y):
    """uint32 values (int64) -> f32 carrying the same 32 bits."""
    return (y - ((y >> 31) << 32)).to(torch.int32).view(torch.float32)


def _f32_to_seed(c):
    return c.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def pack_reservoirs(res: dict):
    """SoA -> one [N, 12] row table (the reference's column order)."""
    return torch.stack([
        _seed_to_f32(res["y"]),
        res["w_sum"],
        res["M"].to(torch.float32),
        res["W"],
        res["p_hat"],
        res["s_path"].x, res["s_path"].y, res["s_path"].z,
        res["rad"].x, res["rad"].y, res["rad"].z,
        res["rad_ok"].to(torch.float32),
    ], dim=-1)


def unpack_reservoirs(rows):
    return unpack_reservoir_cols(list(rows.unbind(-1)))


def unpack_reservoir_cols(c):
    """12 [R] columns (pack_reservoirs order) -> reservoir dict."""
    return {
        "y": _f32_to_seed(c[0]),
        "w_sum": c[1],
        "M": c[2].to(torch.int32),
        "W": c[3],
        "p_hat": c[4],
        "s_path": V3(c[5], c[6], c[7]),
        "rad": V3(c[8], c[9], c[10]),
        "rad_ok": c[11] > 0.5,
    }


def _update_reservoir(res, mask, y_new, w, rnd, cnt, p_hat_new, s_path_new,
                      rad_new, rad_ok_new):
    """update_reservoir (restir.wgsl:746-756) on the masked lanes; the
    dedup cache (rad, rad_ok) rides with the sample and is adopted only
    when it wins."""
    w_sum = res["w_sum"] + torch.where(mask, w, 0.0)
    take = mask & (rnd * w_sum < w)
    return {
        "y": torch.where(take, y_new, res["y"]),
        "w_sum": w_sum,
        "M": res["M"] + torch.where(mask, cnt, 0).to(torch.int32),
        "W": res["W"],
        "p_hat": torch.where(take, p_hat_new, res["p_hat"]),
        "s_path": vec3.where(take, s_path_new, res["s_path"]),
        "rad": vec3.where(take, rad_new, res["rad"]),
        "rad_ok": torch.where(take, rad_ok_new, res["rad_ok"]),
    }


def _is_valid_neighbor_temporal(curr_pos, curr_normal, curr_mat,
                                prev_pos, prev_normal, prev_mat, camera_pos):
    """restir.wgsl:758-778."""
    ok = curr_mat == prev_mat
    ok = ok & (vec3.dot(curr_normal, prev_normal) >= 0.99)
    dd = curr_pos - prev_pos
    dc = curr_pos - camera_pos
    threshold = torch.clamp(vec3.dot(dc, dc) * 1e-3, min=1e-5)
    return ok & (vec3.dot(dd, dd) <= threshold)


def _mat_rmt(scene, mid):
    """Material ids -> (roughness, metallic, transmission) [R]s."""
    m = scene.materials
    mid = mid.to(torch.int64)
    return m["roughness"][mid], m["metallic"][mid], m["transmission"][mid]


def _is_valid_neighbor_spatial(curr_specular, curr_pos, curr_normal,
                               curr_mat, n_pos, n_normal, n_mat,
                               camera_pos):
    """restir_spatial.wgsl:783-814 (specular-aware thresholds)."""
    ndot = vec3.dot(curr_normal, n_normal)
    dd = curr_pos - n_pos
    dist_diff_sq = vec3.dot(dd, dd)
    dc = curr_pos - camera_pos
    threshold = torch.clamp(vec3.dot(dc, dc) * 1e-3, min=1e-5)
    spec_ok = (ndot >= 0.998) & (torch.sqrt(dist_diff_sq) <= 0.01)
    diff_ok = (ndot >= 0.995) & (dist_diff_sq <= threshold)
    return (curr_mat == n_mat) & torch.where(curr_specular, spec_ok, diff_ok)


def _cam_v3(camera_pos, r):
    return V3(*(camera_pos[k].expand(r) for k in range(3)))


def restir_temporal(scene, gb, prev_view, camera, frame_count, ctx,
                    static_ok: bool = False):
    """Candidate generation + temporal reuse. Returns (reservoirs,
    ray_count).

    prev_view: view over last frame's packed G-buffer + spatial
    reservoirs [.., GB_COLS + RES_COLS]. frame_count: a Python int or a
    0-dim int64 tensor on ctx's device; the seeds are the same bits
    either way. static_ok: the caller asserts
    nothing (camera, scene) changed since last frame, which lets the
    previous replay's radiance serve as a dedup cache for temporal
    winners; a wrong True renders stale radiance."""
    width, height = ctx["width"], ctx["height"]
    gx, gy, gidx = _global_coords(ctx)
    seed_base = (gidx + (frame_count & 0xFFFFFFFF) * 927163) & 0xFFFFFFFF
    seed_candidate = rng.pcg_hash(seed_base)
    local_seed = seed_base

    n = gx.shape[0]
    valid = gb["valid"]
    res = empty_reservoirs(n, ctx["device"])

    # phase 1: candidate path (restir.wgsl:826-841); its cache is valid
    # unconditionally - the final replay traces exactly (gb, seed)
    pr = path_trace.trace_path(scene, gb, camera["view_pos"][:3],
                               seed_candidate,
                               reorder=ctx.get("reorder", "none"))
    pr_rad = vec3.of(pr["radiance"])
    p_hat = vec3.luminance(pr_rad)
    res = _update_reservoir(res, valid, seed_candidate, p_hat, 0.5, 1,
                            p_hat, vec3.of(pr["v1_pos"]), pr_rad, True)
    res["W"] = torch.where(valid & (p_hat > 0.0), 1.0, 0.0)

    # phase 2: temporal reuse (restir.wgsl:846-899)
    u_scr = (gx.to(torch.float32) + 0.5) / width
    v_scr = (gy.to(torch.float32) + 0.5) / height
    prev_u = u_scr + gb["motion"][:, 0]
    prev_v = v_scr + gb["motion"][:, 1]
    in_screen = ((prev_u >= 0.0) & (prev_u <= 1.0)
                 & (prev_v >= 0.0) & (prev_v <= 1.0))
    prev_x = (prev_u * width).to(torch.int32)
    prev_y = (prev_v * height).to(torch.int32)

    comb_c, cov = prev_view.read_cols(prev_y, prev_x)
    ph = _gb_head(comb_c)
    c_norm = vec3.oct_decode(gb["oct_normal"][:, 0], gb["oct_normal"][:, 1])

    rough, metal, trans = _mat_rmt(scene, torch.clamp(gb["mat_id"], min=0))
    is_specular = (rough < 0.2) | (metal > 0.8) | (trans > 0.01)

    cam3 = _cam_v3(camera["view_pos"], n)
    geo_ok = _is_valid_neighbor_temporal(
        vec3.of(gb["pos"]), c_norm, gb["mat_id"], ph["pos"], ph["norm"],
        ph["mat"], cam3)
    reuse = valid & in_screen & cov & ph["valid"] & geo_ok & ~is_specular

    # albedo-luminance correction (restir.wgsl:879-898)
    l_curr = vec3.luminance(vec3.of(gb["albedo"])) + 1e-3
    l_prev = vec3.luminance(ph["albedo"]) + 1e-3
    albedo_ratio = l_curr / l_prev
    reuse = reuse & (albedo_ratio < 3.0) & (albedo_ratio > 0.33)

    prev_res = unpack_reservoir_cols(comb_c[GB_COLS:])
    p_hat_new = prev_res["p_hat"] * albedo_ratio
    reuse = reuse & (p_hat_new > 0.0)
    clamped_m = torch.clamp(prev_res["M"], max=MAX_M_TEMPORAL)
    w_prev = p_hat_new * prev_res["W"] * clamped_m.to(torch.float32)

    # the previous replay of the reprojected seed equals this frame's
    # replay only in a static world with an identity reprojection
    rad_carry_ok = (static_ok & prev_res["rad_ok"]
                    & (prev_x.to(torch.int64) == gx)
                    & (prev_y.to(torch.int64) == gy)
                    & (torch.abs(albedo_ratio - 1.0) < 1e-6))

    local_seed, rnd = rng.rand_lcg_if(local_seed, reuse)
    res = _update_reservoir(res, reuse, prev_res["y"], w_prev, rnd,
                            clamped_m, p_hat_new, prev_res["s_path"],
                            prev_res["rad"], rad_carry_ok)

    # phase 3: finalize W (restir.wgsl:904-916)
    m_f = torch.clamp(res["M"].to(torch.float32), min=1.0)
    w_ok = valid & (res["p_hat"] > 0.0)
    res["W"] = torch.where(
        w_ok, (1.0 / torch.clamp(res["p_hat"], min=1e-20))
        * (res["w_sum"] / m_f), 0.0)
    res["p_hat"] = torch.where(w_ok, res["p_hat"], 0.0)
    # background lanes cleared (restir.wgsl:805-811)
    res["y"] = torch.where(valid, res["y"], 0)
    for k in ("w_sum", "W", "p_hat"):
        res[k] = torch.where(valid, res[k], 0.0)
    res["M"] = torch.where(valid, res["M"], 0)
    res["s_path"] = vec3.where(valid, res["s_path"], 0.0)
    res["rad"] = vec3.where(valid, res["rad"], 0.0)
    res["rad_ok"] = valid & res["rad_ok"]
    return res, pr["rays"]


def _calculate_jacobian(curr_pos, curr_normal, curr_albedo, neighbor_v1,
                        n_pos, n_normal, n_albedo):
    """Reconnection-shift Jacobian (restir_spatial.wgsl:822-854)."""
    cos_curr = torch.clamp(
        vec3.dot(curr_normal, vec3.normalize(neighbor_v1 - curr_pos)),
        min=0.0)
    cos_neigh = torch.clamp(
        vec3.dot(n_normal, vec3.normalize(neighbor_v1 - n_pos)), min=0.0)
    jac = cos_curr / torch.clamp(cos_neigh, min=1e-12)
    lum_curr = vec3.luminance(curr_albedo) + 1e-3
    lum_neigh = vec3.luminance(n_albedo) + 1e-3
    jac = torch.clamp(jac * (lum_curr / lum_neigh), 0.1, 10.0)
    return torch.where(cos_neigh <= 1e-3, 0.0, jac)


def _spatial_surface(scene, gb, camera, frame_count, ctx):
    """What every spatial tap reads of this pixel: (surface dict, the
    pixel's raw-LCG seed)."""
    gx, gy, gidx = _global_coords(ctx)
    local_seed = (gidx + (frame_count & 0xFFFFFFFF) * 0x12345678) \
        & 0xFFFFFFFF
    mat_id = gb["mat_id"]
    rough, metal, trans = _mat_rmt(scene, torch.clamp(mat_id, min=0))
    is_specular = (rough < 0.1) | (metal > 0.9) | (trans > 0.1)
    return {
        "gx": gx, "gy": gy, "valid": gb["valid"], "pos": vec3.of(gb["pos"]),
        "normal": vec3.oct_decode(gb["oct_normal"][:, 0],
                                  gb["oct_normal"][:, 1]),
        "mat_id": mat_id, "albedo": vec3.of(gb["albedo"]),
        "cam3": _cam_v3(camera["view_pos"][:3], gx.shape[0]),
        "is_specular": is_specular,
        # neighbor-validity specular flag (other thresholds, :783-814)
        "valid_spec": (rough < 0.2) | (metal > 0.8) | (trans > 0.01),
        "num_neighbors": torch.where(is_specular, 3, 5),   # :901-910
        "radius": torch.where(is_specular, 4.0, 10.0),
    }, local_seed


def _tap_prep(i, local_seed, s, comb_view):
    """Tap i's draws, neighbour read and every test before visibility
    (the reference's `tap_prep`, restir.py:433-480): (seed, the tap's
    merge operands and its shadow ray to the neighbour's v1, active
    where `shadow_active`)."""
    it_active = s["valid"] & (i < s["num_neighbors"])
    local_seed, r1 = rng.rand_lcg_if(local_seed, it_active)
    local_seed, r2 = rng.rand_lcg_if(local_seed, it_active)
    angle = 2.0 * math.pi * r1
    rad = torch.sqrt(r2) * s["radius"]
    nx = s["gx"] + (torch.cos(angle) * rad).to(torch.int32)
    ny = s["gy"] + (torch.sin(angle) * rad).to(torch.int32)

    pos, normal = s["pos"], s["normal"]
    comb_c, cov = comb_view.read_cols(ny, nx)
    nh = _gb_head(comb_c)
    ok = it_active & cov & nh["valid"]
    ok = ok & _is_valid_neighbor_spatial(
        s["valid_spec"], pos, normal, s["mat_id"], nh["pos"], nh["norm"],
        nh["mat"], s["cam3"])

    nbres = unpack_reservoir_cols(comb_c[GB_COLS:])
    ok = ok & (nbres["p_hat"] > 0.0)
    jac = _calculate_jacobian(pos, normal, s["albedo"], nbres["s_path"],
                              nh["pos"], nh["norm"], nh["albedo"])
    ok = ok & ~(s["is_specular"] & ((jac < 0.5) | (jac > 2.0)))

    # visibility re-check to the neighbor's v1 (:965-984)
    dir_to_v1 = nbres["s_path"] - pos
    dist_to_v1 = vec3.length(dir_to_v1)
    shadow_active = ok & (vec3.dot(normal, dir_to_v1) > 0.0) \
        & (dist_to_v1 > 1e-3)
    return local_seed, {
        "nb_y": nbres["y"],
        "m_new": torch.clamp(nbres["M"], max=MAX_M_SPATIAL),
        "p_hat_corr": nbres["p_hat"] * jac,
        "nb_w": nbres["W"],
        "nb_spath": nbres["s_path"],
        "shadow_active": shadow_active,
        "dir": dir_to_v1 / torch.clamp(dist_to_v1, min=1e-12),
        "t_max": torch.clamp(dist_to_v1 * 0.999, min=0.0),
    }


def _tap_stream(scene, gb, comb_view, camera, frame_count, ctx):
    """The batched taps' preparation (the reference's `tap_prep` scan,
    restir.py:433-500): the five taps' merge operands, each with its
    reservoir-update draw `rnd` taken where the tap reaches its
    visibility test (`shadow_active`), and their shadow rays as one
    pixel-interleaved stream of 5R rays (pixel p's taps at 5p..5p+4):
    {"o", "d": V3, "t_max", "active": [5R]}, traced with t_min 1e-3.

    The sequential order draws `rnd` only after the test passes, so the
    two RNG streams differ wherever a tap is blocked; every draw is an
    independent uniform either way, so the image converges the same."""
    s, local_seed = _spatial_surface(scene, gb, camera, frame_count, ctx)
    taps = []
    for i in range(TAPS):
        local_seed, tap = _tap_prep(i, local_seed, s, comb_view)
        local_seed, tap["rnd"] = rng.rand_lcg_if(local_seed,
                                                 tap["shadow_active"])
        taps.append(tap)
    r = s["gx"].shape[0]

    def inter(xs):                          # 5 x [R] -> [5R]
        return torch.stack(xs).swapaxes(0, 1).reshape(-1)

    def bcast(x):                           # [R] -> [5R]
        return x[:, None].expand(r, TAPS).reshape(-1)

    pos = s["pos"]
    stream = {
        "o": V3(bcast(pos.x), bcast(pos.y), bcast(pos.z)),
        "d": V3(*(inter([t["dir"][k] for t in taps]) for k in range(3))),
        "t_max": inter([t["t_max"] for t in taps]),
        "active": inter([t["shadow_active"] for t in taps]),
    }
    return taps, stream


def _merge_tap(res, tap, ok, rnd):
    """A tap that passed its visibility test into the reservoir. A
    neighbor's cached radiance was traced from the NEIGHBOR's surface,
    so adopting its seed always drops the dedup cache."""
    weight = tap["p_hat_corr"] * tap["nb_w"] * tap["m_new"].to(torch.float32)
    return _update_reservoir(res, ok, tap["nb_y"], weight, rnd, tap["m_new"],
                             tap["p_hat_corr"], tap["nb_spath"], 0.0, False)


def restir_spatial(scene, gb, comb_view, in_reservoirs, camera,
                   frame_count, ctx):
    """Spatial reuse over up to 5 disk taps, each with an any-hit
    visibility check, then the final seed replay + shade. Under
    `tap_batch_on(ctx)` the taps' checks are one any-hit call over
    `_tap_stream`'s 5R rays; otherwise each tap traces in turn.

    comb_view: view over this frame's packed G-buffer + temporal
    reservoirs (a BandView, or a PairBandView of the two). Returns
    (out_reservoirs, hdr [n, 3], ray_count, diag).

    Route by device, as every kernel of the port: CPU tensors and the
    batched taps take `restir_spatial_plain`, the eager PyTorch version;
    CUDA tensors take kernel K11 (`restir_spatial_kernel`) around the
    same queries, or the call raises."""
    if tap_batch_on(ctx) or gb["valid"].device.type == "cpu":
        return restir_spatial_plain(scene, gb, comb_view, in_reservoirs,
                                    camera, frame_count, ctx)
    return restir_spatial_kernel(scene, gb, comb_view, in_reservoirs, camera,
                                 frame_count, ctx)


def restir_spatial_plain(scene, gb, comb_view, in_reservoirs, camera,
                         frame_count, ctx):
    """`restir_spatial` in eager PyTorch ops, on any device: the CPU
    route, the batched taps' route, and on the card the yardstick K11 is
    held to."""
    valid = gb["valid"]
    camera_pos = camera["view_pos"][:3]
    reorder = ctx.get("reorder", "none")

    # own reservoir, M-clamped with w_sum rescale (:892-896)
    res = dict(in_reservoirs)
    over = res["M"] > MAX_M_SPATIAL
    res["w_sum"] = torch.where(
        over, res["w_sum"] * MAX_M_SPATIAL / torch.clamp(res["M"], min=1),
        res["w_sum"])
    res["M"] = torch.clamp(res["M"], max=MAX_M_SPATIAL)

    if tap_batch_on(ctx):
        taps, st = _tap_stream(scene, gb, comb_view, camera, frame_count,
                               ctx)
        blocked = scene_occluded(scene, st["o"], st["d"], 1e-3, st["t_max"],
                                 active=st["active"],
                                 reorder=reorder).reshape(-1, TAPS)
        ray_count = st["active"].to(torch.float32).sum()
        for i, tap in enumerate(taps):
            res = _merge_tap(res, tap, tap["shadow_active"] & ~blocked[:, i],
                             tap["rnd"])
        return _spatial_finalize(scene, gb, res, camera_pos, valid,
                                 ray_count, reorder)

    s, local_seed = _spatial_surface(scene, gb, camera, frame_count, ctx)
    ray_count = torch.zeros((), dtype=torch.float32, device=ctx["device"])
    for i in range(TAPS):
        local_seed, tap = _tap_prep(i, local_seed, s, comb_view)
        shadow_active = tap["shadow_active"]
        ray_count = ray_count + shadow_active.to(torch.float32).sum()
        blocked = scene_occluded(scene, s["pos"], tap["dir"], 1e-3,
                                 tap["t_max"], active=shadow_active,
                                 reorder=reorder)
        ok = shadow_active & ~blocked
        local_seed, rnd = rng.rand_lcg_if(local_seed, ok)
        res = _merge_tap(res, tap, ok, rnd)
    return _spatial_finalize(scene, gb, res, camera_pos, valid, ray_count,
                             reorder)


def _spatial_finalize(scene, gb, res, camera_pos, valid, ray_count,
                      reorder: str = "none"):
    """Replay the winning seed + shade (restir_spatial.wgsl:996-1015).
    Lanes whose winner carries a valid cache skip the replay: it is
    deterministic in (gb, seed)."""
    cached = res["rad_ok"]
    final = path_trace.trace_path(scene, gb, camera_pos, res["y"],
                                  active=~cached, reorder=reorder)
    radiance = vec3.where(cached, res["rad"], vec3.of(final["radiance"]))
    p_hat_final = vec3.luminance(radiance)
    res["s_path"] = vec3.where(cached, res["s_path"],
                               vec3.of(final["v1_pos"]))
    m_f = torch.clamp(res["M"].to(torch.float32), min=1.0)
    has_energy = valid & (p_hat_final > 0.0)
    w_unclamped = (1.0 / torch.clamp(p_hat_final, min=1e-20)) \
        * (res["w_sum"] / m_f)
    res["W"] = torch.where(has_energy, torch.clamp(w_unclamped, 0.0, MAX_W),
                           0.0)
    res["p_hat"] = torch.where(has_energy, p_hat_final, 0.0)
    hdr = vec3.arr(vec3.where(has_energy, radiance * res["W"], 0.0))

    # next-frame cache: `rad` is now the true replay radiance of `y`
    res["rad"] = vec3.where(valid, radiance, 0.0)
    res["rad_ok"] = valid
    for k in ("w_sum", "W", "p_hat"):
        res[k] = torch.where(valid, res[k], 0.0)
    res["M"] = torch.where(valid, res["M"], 0)
    res["y"] = torch.where(valid, res["y"], 0)
    res["s_path"] = vec3.where(valid, res["s_path"], 0.0)
    diag = {"cached": (cached & valid).to(torch.float32).sum(),
            "lanes": valid.to(torch.float32).sum()}
    return res, hdr, ray_count + final["rays"], diag


# ---------------------------------------------------------------------------
# K11 (CUDA tensors)
# ---------------------------------------------------------------------------

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
K11_COUNTS = TAPS + 2      # csrc/spatial.cu: N_COUNTS


class SpatialArgs(ctypes.Structure):
    """csrc/spatial.cu:SpatialArgs, field for field."""
    _fields_ = [
        *((n, _P) for n in ("gb_pos", "gb_oct", "gb_albedo", "gb_mat",
                            "gb_valid", "in_y", "in_w_sum", "in_m", "in_sx",
                            "in_sy", "in_sz", "in_rx", "in_ry", "in_rz",
                            "in_rad_ok", "mat_table", "view", "frame",
                            "nb_gb", "nb_res")),
        *((n, _L) for n in ("pos_s0", "pos_s1", "oct_s0", "oct_s1", "alb_s0",
                            "alb_s1", "mat_s", "valid_s", "y_s", "w_sum_s",
                            "m_s", "sx_s", "sy_s", "sz_s", "rx_s", "ry_s",
                            "rz_s", "rad_ok_s", "view_s", "nb_gb_s",
                            "nb_res_s", "frame_value")),
        *((n, _I) for n in ("n_mat", "mat_cols", "width", "height", "y0",
                            "band_h", "R", "v_y0", "v_width", "v_height",
                            "v_band_h", "v_halo", "gb_pos_c", "gb_oct_c",
                            "gb_albedo_c", "gb_mat_c", "gb_valid_c")),
        *((n, _P) for n in ("rng", "w_sum", "m", "y", "flags", "tw", "tm",
                            "ty", "counts", "ray_o", "ray_d", "t_max",
                            "active", "blocked", "seed", "replay",
                            "radiance", "v1_pos", "path_rays", "out_w_sum",
                            "out_m", "out_w", "out_p_hat", "out_spath",
                            "out_rad", "out_rad_ok", "hdr", "rays", "cached",
                            "lanes")),
    ]


def restir_spatial_kernel(scene, gb, comb_view, in_reservoirs, camera,
                          frame_count, ctx):
    """`restir_spatial` on CUDA tensors (sequential taps): K11's 7
    launches around the same queries as the eager version's, each counted
    in `trace_api.LAUNCHES`. The scene's material table, gb, the view's
    rows, in_reservoirs, the camera and frame_count (an int, or a 0-dim
    int64 tensor) must lie on one CUDA device; raises on anything else."""
    device = gb["valid"].device
    if device.type != "cuda":
        raise ValueError(f"restir_spatial_kernel needs CUDA tensors, got "
                         f"{device}")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        return run_k11(load_kernels(), stream, count_launch, scene, gb,
                       comb_view, in_reservoirs, camera, frame_count, ctx)


def _comb_rows(view, device):
    """(G-buffer rows, their stride, reservoir rows, their stride, rows)
    of a comb view as K11 reads them: pointers to each table's first
    column, strides in elements."""
    if isinstance(view, BandView):
        rows = (view.band_h + 2 * view.halo) * view.width
        ptr, stride = _rows(view.data, "comb_view", rows, GB_COLS + RES_COLS,
                            device)
        return ptr, stride, ptr + 4 * GB_COLS, stride, rows
    if isinstance(view, PairBandView):
        rows = (view.band_h + 2 * view.halo) * view.width
        a, a_s = _rows(view.a, "comb_view.a", rows, GB_COLS, device)
        b, b_s = _rows(view.b, "comb_view.b", rows, RES_COLS, device)
        return a, a_s, b, b_s, rows
    raise ValueError(f"comb_view: want a BandView or a PairBandView, got "
                     f"{type(view).__name__}")


def run_k11(lib, stream, launched, scene, gb, comb_view, in_reservoirs,
            camera, frame_count, ctx):
    """K11's launches from `lib` on `stream` (a handle, or None for the
    host emulation of the tests), `launched(name)` after each, around the
    five tap any-hit calls (`scene_occluded`) and the winners' replay
    (`path_trace.trace_path`). Lane state lives in SoA buffers allocated
    once a call; nothing is read back to the host, so the call captures
    into a CUDA graph."""
    device = gb["valid"].device
    width, band_h = ctx["width"], ctx["band_h"]
    r = band_h * width
    if r == 0 or r >= 2 ** 31:
        raise ValueError(f"K11 needs a band of 1 to 2^31 - 1 lanes, got {r}")
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    reorder = ctx.get("reorder", "none")
    camera_pos = camera["view_pos"][:3]

    nb_gb, nb_gb_s, nb_res, nb_res_s, rows = _comb_rows(comb_view, device)
    if rows >= 2 ** 31:
        raise ValueError("the comb view exceeds K11's int32 row indices")
    mat, n_mat, mat_cols = path_trace._table(scene.mat_table, "mat_table")
    if scene.mat_table.device != device or n_mat == 0 or mat_cols < 10:
        raise ValueError(f"mat_table: want rows of roughness, metallic and "
                         f"transmission (columns 7-9) on {device}")
    args = SpatialArgs(
        mat_table=mat, n_mat=n_mat, mat_cols=mat_cols,
        nb_gb=nb_gb, nb_gb_s=nb_gb_s, nb_res=nb_res, nb_res_s=nb_res_s,
        width=width, height=ctx["height"], y0=ctx["y0"], band_h=band_h, R=r,
        v_y0=comb_view.y0, v_width=comb_view.width,
        v_height=comb_view.height, v_band_h=comb_view.band_h,
        v_halo=comb_view.halo, gb_pos_c=GB_POS.start, gb_oct_c=GB_OCT.start,
        gb_albedo_c=GB_ALBEDO.start, gb_mat_c=GB_MAT, gb_valid_c=GB_VALID)

    # the call's inputs, read in place through their element strides
    res = in_reservoirs
    for field, x, dtype, shape, strides in (
            ("gb_pos", gb["pos"], f32, (r, 3), ("pos_s0", "pos_s1")),
            ("gb_oct", gb["oct_normal"], f32, (r, 2), ("oct_s0", "oct_s1")),
            ("gb_albedo", gb["albedo"], f32, (r, 3), ("alb_s0", "alb_s1")),
            ("gb_mat", gb["mat_id"], i32, (r,), ("mat_s",)),
            ("gb_valid", gb["valid"], b8, (r,), ("valid_s",)),
            ("in_y", res["y"], torch.int64, (r,), ("y_s",)),
            ("in_w_sum", res["w_sum"], f32, (r,), ("w_sum_s",)),
            ("in_m", res["M"], i32, (r,), ("m_s",)),
            ("in_sx", res["s_path"].x, f32, (r,), ("sx_s",)),
            ("in_sy", res["s_path"].y, f32, (r,), ("sy_s",)),
            ("in_sz", res["s_path"].z, f32, (r,), ("sz_s",)),
            ("in_rx", res["rad"].x, f32, (r,), ("rx_s",)),
            ("in_ry", res["rad"].y, f32, (r,), ("ry_s",)),
            ("in_rz", res["rad"].z, f32, (r,), ("rz_s",)),
            ("in_rad_ok", res["rad_ok"], b8, (r,), ("rad_ok_s",)),
            ("view", camera_pos, f32, (3,), ("view_s",))):
        if x.device != device or x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"{field}: want {dtype} {shape} on {device}, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")
        setattr(args, field, x.data_ptr())
        for name, stride in zip(strides, x.stride()):
            setattr(args, name, stride)
    if isinstance(frame_count, torch.Tensor):
        if frame_count.device != device or frame_count.dtype != torch.int64 \
                or frame_count.dim() != 0:
            raise ValueError(f"frame_count: want a 0-dim int64 tensor on "
                             f"{device}, got {frame_count.dtype} "
                             f"{tuple(frame_count.shape)} on "
                             f"{frame_count.device}")
        args.frame = frame_count.data_ptr()
    else:
        args.frame_value = int(frame_count)

    def empty(*shape, dtype=f32):
        return torch.empty(shape, dtype=dtype, device=device)

    # lane state, the taps' rays, the replay's inputs and the outputs
    bufs = {"rng": empty(r, dtype=i32), "w_sum": empty(r),
            "m": empty(r, dtype=i32), "y": empty(r, dtype=i32),
            "flags": empty(r, dtype=i32), "tw": empty(r),
            "tm": empty(r, dtype=i32), "ty": empty(r, dtype=i32),
            "counts": empty(K11_COUNTS, dtype=i32), "ray_o": empty(3, r),
            "ray_d": empty(3, r), "t_max": empty(r),
            "active": empty(r, dtype=b8), "seed": empty(r, dtype=torch.int64),
            "replay": empty(r, dtype=b8), "out_w_sum": empty(r),
            "out_m": empty(r, dtype=i32), "out_w": empty(r),
            "out_p_hat": empty(r), "out_spath": empty(3, r),
            "out_rad": empty(3, r), "out_rad_ok": empty(r, dtype=b8),
            "hdr": empty(r, 3), "rays": empty(), "cached": empty(),
            "lanes": empty()}
    for k, v in bufs.items():
        setattr(args, k, v.data_ptr())

    def launch(fn, name, *extra):
        err = fn(ctypes.addressof(args), *extra, stream)
        if err != 0:
            raise RuntimeError(f"{name} launch failed: CUDA error {err}")
        launched(name)

    launch(lib.tpurt_spatial_tap, "spatial_tap", 0)
    for t in range(TAPS):
        blocked = scene_occluded(scene, bufs["ray_o"], bufs["ray_d"], 1e-3,
                                 bufs["t_max"], active=bufs["active"],
                                 reorder=reorder)
        args.blocked = blocked.data_ptr()
        if t + 1 < TAPS:
            launch(lib.tpurt_spatial_tap, "spatial_tap", t + 1)
        else:
            launch(lib.tpurt_spatial_close, "spatial_close")
    final = path_trace.trace_path(scene, gb, camera_pos, bufs["seed"],
                                  active=bufs["replay"], reorder=reorder)
    for field, k, shape in (("radiance", "radiance", (r, 3)),
                            ("v1_pos", "v1_pos", (r, 3)),
                            ("path_rays", "rays", ())):
        x = final[k]
        if x.dtype != f32 or tuple(x.shape) != shape \
                or not x.is_contiguous():
            raise ValueError(f"the replay's {k}: want contiguous f32 {shape}, "
                             f"got {x.dtype} {tuple(x.shape)}")
        setattr(args, field, x.data_ptr())
    launch(lib.tpurt_spatial_finish, "spatial_finish")

    out = {"y": bufs["seed"], "w_sum": bufs["out_w_sum"], "M": bufs["out_m"],
           "W": bufs["out_w"], "p_hat": bufs["out_p_hat"],
           "s_path": V3(*bufs["out_spath"].unbind(0)),
           "rad": V3(*bufs["out_rad"].unbind(0)),
           "rad_ok": bufs["out_rad_ok"]}
    return out, bufs["hdr"], bufs["rays"], {"cached": bufs["cached"],
                                            "lanes": bufs["lanes"]}
