"""Stackless lock-step BVH traversal over the unified record stream
(`tpu_raytracer/ops/traversal.py`; the stream's layout is in
`tpu_raytracer/ops/bvh.py`): the route of every flattened scene past its
`brute_max` triangle slots (`trace_api.trace_route`).

Each lane holds one stream pointer and reads one record a step: a box
record's slab test (the reference's, unpadded, against the window
(max(t_near, t_min), min(t_far, t_best)), `<=`) moves the pointer to the
next record on a hit and to the box's `skip` on a miss; a triangle
record is tested (Moller-Trumbore, `t < t_best` strict, so an exact-t
tie goes to the earlier record in the stream) and the pointer moves on.
Any-hit stops a lane at its first hit and returns that hit's (t, tri).
A dead lane (t_max <= 0, the reference's `active=False`) takes no step
and misses.

  - `trace_plain`: the walk in torch ops, each step on the lanes still
    live; the reference's own semantics and arithmetic, so tri, t, u, v
    and front equal its `traversal.trace` on the CPU;
  - kernel K8 (`csrc/trace_bvh.cu`, `tpurt_bvh_closest_hit` and
    `tpurt_bvh_any_hit`), launched by `trace_bvh_kernel`, the same walk
    with one thread per ray, loading windows of consecutive records.
The reference's walk is an XLA `while_loop`, not a Pallas kernel. It
gets a kernel written by hand all the same: an eager PyTorch loop would
read the host at every step of every trace call (whether any lane is
still live), hundreds of times a call.
"""

from __future__ import annotations

import torch

from ..utils.vec3 import V3
from .intersect import INF, aabb_slab, moller_trumbore, safe_inv_dir
from .trace_api import _check, _lanes, count_launch, load_kernels


def trace_plain(bvh_rec, bvh_skip, bvh_tri, o: V3, d: V3, t_min, t_max,
                any_hit: bool = False, count: bool = False):
    """The walk over records bvh_rec [S, 12] f32, bvh_skip and bvh_tri
    [S] i32 for rays o, d (V3s of [R]) in windows (t_min, t_max), scalars
    or [R]. Returns the reference's {"t": [R] f32 (INF on a miss), "tri":
    [R] i32 (-1 on a miss), "u", "v": [R] f32, "front": [R] bool}; with
    `count`, also "box_steps" and "tri_steps" [R] i32 (the box and the
    triangle records each lane read), "jumps" [R] i32 (the boxes each
    lane missed: the steps that move the pointer to a skip, not to the
    next record) and "touched" [S] bool (the records any lane read)."""
    r = o.x.shape[0]
    s = bvh_rec.shape[0]
    device = o.x.device
    t_min = _lanes(t_min, r, device)
    t_best = _lanes(t_max, r, device).clone()
    inv = safe_inv_dir(d)
    tri = torch.full((r,), -1, dtype=torch.int32, device=device)
    u = torch.zeros((r,), dtype=torch.float32, device=device)
    v = torch.zeros_like(u)
    front = torch.zeros((r,), dtype=torch.bool, device=device)
    box_steps = torch.zeros((r,), dtype=torch.int32, device=device)
    tri_steps = torch.zeros_like(box_steps)
    jumps = torch.zeros_like(box_steps)
    touched = torch.zeros((s,), dtype=torch.bool, device=device)
    lanes = torch.nonzero(t_best > 0.0).squeeze(1)
    ptr = torch.zeros_like(lanes)
    while lanes.numel():
        rec = bvh_rec[ptr]
        skip = bvh_skip[ptr].long()
        is_tri = skip < 0
        lo, lt = V3(*(x[lanes] for x in o)), t_min[lanes]
        ld, best = V3(*(x[lanes] for x in d)), t_best[lanes]
        box_hit = aabb_slab(lo, V3(*(x[lanes] for x in inv)), rec[:, 0:3].T,
                            rec[:, 3:6].T, lt, best)
        hit, t, hu, hv, hf = moller_trumbore(lo, ld, rec[:, 0:3].T,
                                             rec[:, 3:6].T, rec[:, 6:9].T,
                                             lt, best)
        won = is_tri & hit
        w = lanes[won]
        t_best[w] = t[won]
        tri[w] = bvh_tri[ptr[won]]
        u[w], v[w], front[w] = hu[won], hv[won], hf[won]
        if count:
            tri_steps[lanes] += is_tri.int()
            box_steps[lanes] += (~is_tri).int()
            jumps[lanes] += (~is_tri & ~box_hit).int()
            touched[ptr] = True
        nxt = torch.where(is_tri | box_hit, ptr + 1, skip)
        live = nxt < s
        if any_hit:
            live &= ~won
        lanes, ptr = lanes[live], nxt[live]
    out = {"t": torch.where(tri < 0, INF, t_best), "tri": tri, "u": u,
           "v": v, "front": front}
    if count:
        out.update(box_steps=box_steps, tri_steps=tri_steps, jumps=jumps,
                   touched=touched)
    return out


def trace_brute(v0, e1, e2, o: V3, d: V3, t_min, t_max):
    """Closest hit over all triangles (v0, e1, e2 [T, 3]) for each ray,
    by testing every one (the reference's `trace_brute`, for tests):
    the same dict as `trace_plain`; an exact-t tie goes to the lowest
    id."""
    r = o.x.shape[0]
    t_min = _lanes(t_min, r, o.x.device)[:, None]
    t_max = _lanes(t_max, r, o.x.device)[:, None]
    hit, t, u, v, front = moller_trumbore(
        [x[:, None] for x in o], [x[:, None] for x in d], v0.T, e1.T, e2.T,
        t_min, t_max)
    best = torch.argmin(t, dim=1, keepdim=True)
    missed = ~hit.gather(1, best)[:, 0]
    pick = [x.gather(1, best)[:, 0] for x in (t, u, v, front)]
    return {"t": torch.where(missed, INF, pick[0]),
            "tri": torch.where(missed, -1, best[:, 0]).to(torch.int32),
            "u": pick[1], "v": pick[2], "front": pick[3]}


def occluded(bvh_rec, bvh_skip, bvh_tri, o: V3, d: V3, t_min, t_max):
    """True where any hit lies in (t_min, t_max): the any-hit walk, the
    plain version on CPU tensors and K8 on CUDA tensors."""
    if o.x.device.type == "cpu":
        res = trace_plain(bvh_rec, bvh_skip, bvh_tri, o, d, t_min, t_max,
                          any_hit=True)
    else:
        r = o.x.shape[0]
        res = trace_bvh_kernel(
            bvh_rec, bvh_skip, bvh_tri, torch.stack(list(o)),
            torch.stack(list(d)), _lanes(t_min, r, o.x.device).contiguous(),
            _lanes(t_max, r, o.x.device).contiguous(), any_hit=True)
    return res["tri"] >= 0


def trace_bvh_kernel(bvh_rec, bvh_skip, bvh_tri, o, d, t_min, t_max,
                     any_hit: bool = False):
    """Launch K8 (`tpurt_bvh_closest_hit`, or `tpurt_bvh_any_hit`) on
    CUDA tensors: o, d [3, R] f32; t_min, t_max [R] f32 (t_max <= 0: a
    dead lane); bvh_rec [S, 12] f32 (16-byte aligned), bvh_skip and
    bvh_tri [S] i32; all contiguous on one CUDA device. Raises on
    anything else. Returns {"t": [R] f32, "tri": [R] i32}: (INF, -1) on
    a miss; any-hit gives its first hit's (t, tri)."""
    device = o.device
    if device.type != "cuda":
        raise ValueError(f"the BVH walk kernel needs CUDA tensors, got "
                         f"{device}")
    r = o.shape[1]
    s = bvh_rec.shape[0]
    f32, i32 = torch.float32, torch.int32
    _check(o, "o", (3, r), f32, device)
    _check(d, "d", (3, r), f32, device)
    _check(t_min, "t_min", (r,), f32, device)
    _check(t_max, "t_max", (r,), f32, device)
    _check(bvh_rec, "bvh_rec", (s, 12), f32, device)
    _check(bvh_skip, "bvh_skip", (s,), i32, device)
    _check(bvh_tri, "bvh_tri", (s,), i32, device)
    if bvh_rec.data_ptr() % 16:
        raise ValueError("bvh_rec must be 16-byte aligned (float4 reads)")
    if r >= 2 ** 31 or 12 * s >= 2 ** 31:
        raise ValueError("rays or BVH records exceed int32 indexing")
    name = f"bvh_{'any' if any_hit else 'closest'}_hit"
    fn = getattr(load_kernels(), f"tpurt_{name}")
    t_out = torch.empty((r,), dtype=f32, device=device)
    tri_out = torch.empty((r,), dtype=i32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(o.data_ptr(), d.data_ptr(), t_min.data_ptr(),
                 t_max.data_ptr(), bvh_rec.data_ptr(), bvh_skip.data_ptr(),
                 bvh_tri.data_ptr(), r, s, t_out.data_ptr(),
                 tri_out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    count_launch(name)
    return {"t": t_out, "tri": tri_out}
