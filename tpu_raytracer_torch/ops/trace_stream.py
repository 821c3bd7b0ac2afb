"""Front-to-back streamed ray queries for flattened scenes past
MXUF_MAX_TP triangle slots: per-block worklists sorted by entry
distance, swept in order with an early exit (the reference's
`_mt_kernel_mxus` route, `tpu_raytracer/ops/pallas_trace.py:800,1326,
1554-1628`).

  - `trace_stream_plain`, the plain twin: the same worklists, the same
    sweep order and exit and the same (t, id) rule, in torch ops on
    128-lane blocks;
  - kernel K3 (`csrc/trace_stream.cu`, `tpurt_stream_closest_hit` and
    `tpurt_stream_any_hit`), which `trace_stream_kernel` launches.
Both return what `trace_api.trace_plain` and K1 return, exactly: each
lane keeps the lexicographic minimum of (t, triangle id), so an exact-t
tie goes to the lowest id whatever the sweep order. Any-hit returns
tri = 1 / -1 and t = t_max (K2's contract).
"""

from __future__ import annotations

import torch

from ..utils.vec3 import V3
from .trace_api import (CT, INF, LAUNCHES, _check, load_kernels, mt_argmin,
                        safe_inv, slab_entry)

BLOCK = CT                # rays per block: one worklist each
MAX_UNITS = 2048          # the kernel's shared-memory worklist capacity


def stream_units(num_chunks: int):
    """(grp, units): a unit is `grp` consecutive chunks, grp the smallest
    power of two that keeps the unit count within MAX_UNITS (the rule of
    csrc/trace_stream.cu:launch)."""
    grp = 1
    while -(-num_chunks // grp) > MAX_UNITS:
        grp *= 2
    return grp, -(-num_chunks // grp)


def _blocks(x, nb, fill=0.0):
    """[R] -> [nb, BLOCK], the tail padded with `fill`."""
    pad = nb * BLOCK - x.shape[0]
    return torch.cat([x, x.new_full((pad,), fill)]).reshape(nb, BLOCK)


def trace_stream_plain(tri_planes, chunk_aabb, o: V3, d: V3, t_min, t_max,
                       any_hit: bool = False):
    """K3's plain twin. Per 128-ray block: each unit's entry is the block
    minimum of `slab_entry` over the live lanes' (t_min, t_max) windows,
    the units some lane reaches are sorted by (entry, unit id), and the
    block sweeps them in that order, chunk by chunk. Closest-hit stops a
    block once every live lane's best t is below the next unit's entry;
    any-hit once every live lane is occluded.

    o/d: V3s of [R] components; t_min, t_max [R] (t_max <= 0: dead
    lane). Returns {"t": [R] f32, "tri": [R] i32}."""
    r = o.x.shape[0]
    device = o.x.device
    nc = tri_planes.shape[2] // CT
    grp, n_units = stream_units(nc)
    nb = max(-(-r // BLOCK), 1)
    inv = safe_inv(d)
    live = t_max > 0.0

    # 1. worklists: e_blk[b, u] is block b's entry into unit u
    e_blk = torch.full((nb, n_units), INF, dtype=torch.float32,
                       device=device)
    for c, box in enumerate(chunk_aabb.cpu().tolist()):
        e = torch.where(live, slab_entry(box, o, inv, t_min, t_max), INF)
        u = c // grp
        e_blk[:, u] = torch.minimum(e_blk[:, u],
                                    _blocks(e, nb, INF).amin(dim=1))
    # 2. sort: stable, so equal entries keep ascending unit ids
    entry, order = torch.sort(e_blk, dim=1, stable=True)
    count = (entry < INF).sum(dim=1)

    # 3. sweep: step s tests chunk s % grp of the (s // grp)-th unit
    ob, db = V3(*(_blocks(x, nb) for x in o)), V3(*(_blocks(x, nb) for x in d))
    tmin_b, tmax_b = _blocks(t_min, nb), _blocks(t_max, nb)
    live_b = tmax_b > 0.0
    planes = tri_planes.reshape(4, 3, nc, CT)
    t_best = torch.full((nb, BLOCK), INF, dtype=torch.float32, device=device)
    idx_best = torch.full((nb, BLOCK), -1, dtype=torch.int32, device=device)
    hit = torch.zeros((nb, BLOCK), dtype=torch.bool, device=device)
    sweeping = count > 0
    for s in range(int(count.max()) * grp):
        i, j = divmod(s, grp)
        blk = torch.nonzero(sweeping & (i < count)).squeeze(1)
        if blk.numel() == 0:
            break
        c = order[blk, i] * grp + j
        in_range = c < nc          # the last unit may be short
        bk, c = blk[in_range], c[in_range]
        if bk.numel():
            t_new, k = mt_argmin(
                planes[:, :, c, None], V3(*(x[bk] for x in ob)),
                V3(*(x[bk] for x in db)), tmin_b[bk], tmax_b[bk],
                tmax_b[bk])
            lane_live = live_b[bk]
            if any_hit:
                hit[bk] |= lane_live & (t_new < INF)
            else:
                ids = (k + c[:, None] * CT).to(torch.int32)
                tb, ib = t_best[bk], idx_best[bk]
                better = lane_live & ((t_new < tb)
                                      | ((t_new == tb) & (ids < ib)))
                t_best[bk] = torch.where(better, t_new, tb)
                idx_best[bk] = torch.where(better, ids, ib)
        if any_hit:
            sweeping[blk] = (live_b[blk] & ~hit[blk]).any(dim=1)
        elif j == grp - 1:
            more = i + 1 < count[blk]
            nxt = entry[blk, min(i + 1, n_units - 1)]
            open_ = live_b[blk] & ~(t_best[blk] < nxt[:, None])
            sweeping[blk] = more & open_.any(dim=1)

    if any_hit:
        return {"t": t_max.clone(),
                "tri": torch.where(hit.reshape(-1)[:r], 1, -1)
                .to(torch.int32)}
    t_best, idx_best = t_best.reshape(-1)[:r], idx_best.reshape(-1)[:r]
    return {"t": torch.where(idx_best < 0, INF, t_best), "tri": idx_best}


def trace_stream_kernel(tri_planes, chunk_aabb, o, d, t_min, t_max,
                        any_hit: bool = False):
    """Launch K3 on CUDA tensors: closest-hit, or with `any_hit` the
    any-hit entry (tri = 1 / -1, t = t_max).

    o, d: [3, R] f32; t_min, t_max: [R] f32 (t_max <= 0: dead lane);
    tri_planes [4, 3, Tp] f32 with a 16-byte aligned base (the kernel
    stages it with 16-byte asynchronous copies) and chunk_aabb
    [Tp/128, 8] f32, all contiguous on one CUDA device. Raises on
    anything else."""
    device = o.device
    if device.type != "cuda":
        raise ValueError(
            f"trace_stream_kernel needs CUDA tensors, got {device}")
    r = o.shape[1]
    tp = tri_planes.shape[2]
    if tp % CT:
        raise ValueError(f"tri_planes width {tp} is not a multiple of {CT}")
    f32 = torch.float32
    _check(o, "o", (3, r), f32, device)
    _check(d, "d", (3, r), f32, device)
    _check(t_min, "t_min", (r,), f32, device)
    _check(t_max, "t_max", (r,), f32, device)
    _check(tri_planes, "tri_planes", (4, 3, tp), f32, device)
    _check(chunk_aabb, "chunk_aabb", (tp // CT, 8), f32, device)
    if tri_planes.data_ptr() % 16:
        raise ValueError("tri_planes is not 16-byte aligned")
    if r >= 2 ** 31 or 12 * tp >= 2 ** 31:
        raise ValueError("rays or triangle slots exceed int32 indexing")
    lib = load_kernels()
    t_out = torch.empty((r,), dtype=f32, device=device)
    tri_out = torch.empty((r,), dtype=torch.int32, device=device)
    fn = lib.tpurt_stream_any_hit if any_hit else lib.tpurt_stream_closest_hit
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(o.data_ptr(), d.data_ptr(), t_min.data_ptr(),
                 t_max.data_ptr(), tri_planes.data_ptr(),
                 chunk_aabb.data_ptr(), r, tp, t_out.data_ptr(),
                 tri_out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"streamed {'any' if any_hit else 'closest'}-hit "
                           f"kernel launch failed: CUDA error {err}")
    LAUNCHES["stream_any_hit" if any_hit else "stream_closest_hit"] += 1
    return {"t": t_out, "tri": tri_out}
