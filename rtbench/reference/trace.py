"""The reference's ray-scene queries: a brute-force Moller-Trumbore test in
plain float32 PyTorch, written for this benchmark and independent of the
program's traversal kernels and of their plain versions.

Triangles sit in chunks of CHUNK slots, each instance's triangles in
chunks of their own, and a chunk's padded box culls the rays that cannot
reach it. Rays go in blocks: each block's (ray, chunk) pairs that pass
the slab test are tested against the chunk's slots at once, and each
ray keeps its nearest hit inside its window (t_min, t_max), an exact-t
tie going to the lowest triangle id. The answer does not depend on the
order in which chunks or pairs are visited.

Same contract as the program's queries: closest hit gives {"t": [R] f32
(INF on a miss or a dead lane, t_max <= 0), "tri": [R] int32 (-1 on a
miss)}; `scene_occluded` is True where any triangle lies inside the
window.
"""

from __future__ import annotations

import torch

from .lower import exact, rays
from .vec3 import V3

INF = 3.0e38
CHUNK = 64            # triangle slots a chunk; instances never share one
MT_EPS = 1e-9
RAY_BLOCK = 1 << 16   # rays whose pairs are formed at once
PAIR_BLOCK = 1 << 16  # (ray, chunk) pairs tested at once


def chunk_tables(v0, e1, e2, first_of_instance, device):
    """Chunked triangle tables from world triangles [T, 3] (numpy f32) in
    triangle-id order; `first_of_instance` lists the first triangle of
    each instance. Returns (tris [NC, CHUNK, 9] f32 (v0 | e1 | e2),
    ids [NC, CHUNK] int64 (-1 in padding), boxes [NC, 6] f32)."""
    import numpy as np
    t = v0.shape[0]
    bounds = sorted(set(int(i) for i in first_of_instance) | {t})
    slots = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        for c in range(lo, hi, CHUNK):
            ids = np.full(CHUNK, -1, np.int64)
            n = min(CHUNK, hi - c)
            ids[:n] = np.arange(c, c + n)
            slots.append(ids)
    ids = np.stack(slots) if slots else np.full((1, CHUNK), -1, np.int64)
    safe = np.maximum(ids, 0)
    tris = np.concatenate([v0[safe], e1[safe], e2[safe]], axis=-1)
    tris[ids < 0] = 0.0          # degenerate: det = 0, never a hit
    corners = np.stack([v0[safe], v0[safe] + e1[safe], v0[safe] + e2[safe]])
    real = (ids >= 0)[None, :, :, None]
    lo = np.where(real, corners, np.inf).min(axis=(0, 2))
    hi = np.where(real, corners, -np.inf).max(axis=(0, 2))
    # a padded box: flat walls give boxes of no thickness
    pad = 1e-4 * (np.abs(lo) + np.abs(hi)) + 1e-5
    boxes = np.concatenate([lo - pad, hi + pad], axis=1).astype(np.float32)
    return (torch.as_tensor(tris, dtype=torch.float32, device=device),
            torch.as_tensor(ids, device=device),
            torch.as_tensor(boxes, device=device))


def _pairs(boxes, o, inv, t_min, t_max):
    """(ray, chunk) index pairs whose window meets the chunk's box."""
    lo, hi = boxes[:, 0:3], boxes[:, 3:6]
    a = (lo[None] - o[:, None]) * inv[:, None]
    b = (hi[None] - o[:, None]) * inv[:, None]
    near = torch.minimum(a, b).amax(dim=-1)
    far = torch.maximum(a, b).amin(dim=-1)
    near = torch.maximum(near, t_min[:, None])
    far = torch.minimum(far, t_max[:, None])
    return torch.nonzero(near <= far, as_tuple=True)


def _mt(o, d, tri, t_min, t_max):
    """Moller-Trumbore of rays [P, 3] against their chunks' slots
    [P, CHUNK, 9]: t [P, CHUNK], INF where there is no hit inside
    (t_min, t_max)."""
    v0, e1, e2 = tri[..., 0:3], tri[..., 3:6], tri[..., 6:9]
    d = d[:, None, :]
    p = torch.linalg.cross(d.expand_as(e2), e2)
    det = (e1 * p).sum(-1)
    ok = det.abs() > MT_EPS
    inv_det = 1.0 / torch.where(ok, det, 1.0)
    s = o[:, None, :] - v0
    u = (s * p).sum(-1) * inv_det
    q = torch.linalg.cross(s, e1)
    v = (d * q).sum(-1) * inv_det
    t = (e2 * q).sum(-1) * inv_det
    hit = (ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t > t_min[:, None]) & (t < t_max[:, None]))
    return torch.where(hit, t, INF)


def trace_rays(scene, o, d, t_min, t_max):
    """o, d: [R, 3] f32; t_min >= 0, t_max: [R] f32. Returns (t [R] f32,
    tri [R] int64) of the nearest hit inside each window, the lowest id
    among exact-t ties; (INF, -1) where there is none.

    A hit's t is positive, so its f32 bits order as its value: the key
    (t bits << 32 | id) orders hits by t and then by id, and one running
    minimum over every pair keeps the winner whatever the visit order."""
    r = o.shape[0]
    dev = o.device
    none = torch.iinfo(torch.int64).max
    best = torch.full((r,), none, dtype=torch.int64, device=dev)
    inv = 1.0 / torch.where(d.abs() < 1e-12,
                            torch.where(d < 0.0, -1e-12, 1e-12), d)
    for r0 in range(0, r, RAY_BLOCK):
        sl = slice(r0, min(r0 + RAY_BLOCK, r))
        live = t_max[sl] > 0.0
        with exact():
            ray, chunk = _pairs(scene.trace_boxes, o[sl], inv[sl],
                                t_min[sl], torch.where(live, t_max[sl], -1.0))
        ray = ray + r0
        for p0 in range(0, ray.shape[0], PAIR_BLOCK):
            pr, pc = ray[p0:p0 + PAIR_BLOCK], chunk[p0:p0 + PAIR_BLOCK]
            t = _mt(o[pr], d[pr], scene.trace_tris[pc], t_min[pr],
                    t_max[pr])
            key = (t.view(torch.int32).to(torch.int64) << 32) \
                | scene.trace_ids[pc]
            key = torch.where(t < INF, key, none).amin(dim=1)
            best.scatter_reduce_(0, pr, key, "amin")
    hit = best != none
    t = (best >> 32).to(torch.int32).view(torch.float32)
    return (torch.where(hit, t, INF),
            torch.where(hit, best & 0xFFFFFFFF, -1))


def _lanes(x, r, device):
    if isinstance(x, torch.Tensor) and x.dim() == 1:
        return x.to(torch.float32)
    return torch.full((r,), float(x), dtype=torch.float32, device=device)


def scene_trace(scene, ray_o: V3, ray_d: V3, t_min, t_max, any_hit=False,
                active=None):
    """Closest-hit (or, with any_hit, occlusion) query, as the program's
    `ops/trace_api.py:scene_trace` states its contract."""
    with rays():
        return _scene_trace(scene, ray_o, ray_d, t_min, t_max, active)


def _scene_trace(scene, ray_o, ray_d, t_min, t_max, active):
    device = ray_o.x.device
    r = ray_o.x.shape[0]
    t_min = _lanes(t_min, r, device)
    t_max = _lanes(t_max, r, device)
    if active is not None:
        t_max = torch.where(active, t_max, 0.0)
    o = torch.stack(list(ray_o), dim=1)
    d = torch.stack(list(ray_d), dim=1)
    if bool((t_min < 0.0).any()):
        raise ValueError("the reference's trace needs t_min >= 0")
    scene.counts["stages"] += 1
    t, tri = trace_rays(scene, o, d, t_min, t_max)
    tri = tri.to(torch.int32)
    return {"t": torch.where(tri < 0, INF, t), "tri": tri}


def scene_occluded(scene, ray_o: V3, ray_d: V3, t_min, t_max, active=None):
    return scene_trace(scene, ray_o, ray_d, t_min, t_max, any_hit=True,
                       active=active)["tri"] >= 0


def table_gather(table, idx):
    """[C, R] rows of `table` [M, C] at `idx` [R] (in range)."""
    return table.index_select(0, idx.long()).t().contiguous()
