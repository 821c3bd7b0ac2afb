"""Front-to-back streamed ray queries for flattened scenes past
MXUF_MAX_TP triangle slots: per 128-ray block, units of consecutive
chunks sorted by the block's entry distance, swept in order with an early
exit (the reference's `_mt_kernel_mxus` route,
`tpu_raytracer/ops/pallas_trace.py:800,1326,1554-1628`).

  - `trace_stream_plain`, the plain twin: the same unit boxes, the same
    per-lane unit bits, the same sort, the same exit and the same (t, id)
    rule, in torch ops on 128-lane blocks;
  - kernel K3 (`csrc/trace_stream.cu`, `tpurt_stream_closest_hit` and
    `tpurt_stream_any_hit`), which `trace_stream_kernel` launches.
Both return what `trace_api.trace_plain` and K1 return, exactly: each
lane keeps the lexicographic minimum of (t, triangle id), so an exact-t
tie goes to the lowest id whatever the sweep order. Any-hit returns
tri = 1 / -1 and t = t_max (K2's contract).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.vec3 import V3
from .intersect import INF, safe_inv_dir
from .trace_api import CT, launch_sweep, mt_argmin

BLOCK = CT                # rays per block
MAX_UNITS = 64            # the kernel's unit capacity (TPURT_MAX_UNITS)


def stream_units(num_chunks: int, max_units: int | None = None):
    """(grp, units): a unit is `grp` consecutive chunks, grp the smallest
    power of two that keeps the unit count within `max_units`, by default
    K3's MAX_UNITS (the rule of csrc/sweep.cuh:sweep_units; K1/K2 take
    trace_api.SWEPT_MAX_UNITS)."""
    max_units = max_units or MAX_UNITS
    grp = 1
    while -(-num_chunks // grp) > max_units:
        grp *= 2
    return grp, -(-num_chunks // grp)


def padded_chunk_boxes(chunk_aabb):
    """[nc, 6] f32: each chunk's box padded as mt.cuh:slab_window pads it
    (lo - pad, hi + pad, pad = 1e-5 (|lo| + |hi|) + 1e-6, in f32); an
    empty chunk (min x > max x) gets (INF, -INF)."""
    box = chunk_aabb.detach().cpu().numpy().astype(np.float32)
    lo, hi = box[:, 0:3], box[:, 3:6]
    with np.errstate(over="ignore"):
        pad = (np.float32(1e-5) * (np.abs(lo) + np.abs(hi))
               + np.float32(1e-6))
        out = np.concatenate([lo - pad, hi + pad], axis=1)
    empty = ~(box[:, 0] <= box[:, 3])
    out[empty] = np.float32([INF] * 3 + [-INF] * 3)
    return out


def unit_boxes(chunk_aabb, grp):
    """[units, 6] f32: each unit's box, the hull of its chunks' padded
    boxes (the kernel's first step), so its unpadded slab entry is a lower
    bound on any hit in the unit. A unit of empty chunks stays empty."""
    boxes = padded_chunk_boxes(chunk_aabb)
    units = -(-boxes.shape[0] // grp)
    fill = np.float32([INF] * 3 + [-INF] * 3)
    boxes = np.concatenate(
        [boxes, np.tile(fill, (units * grp - boxes.shape[0], 1))])
    boxes = boxes.reshape(units, grp, 6)
    return np.concatenate([boxes[..., :3].min(1), boxes[..., 3:].max(1)],
                          axis=1)


def _unit_entry(box, o: V3, inv: V3, t_lo, t_hi):
    """Each ray's entry t into an already padded box [6], else INF (the
    kernel's box_entry)."""
    if not box[0] <= box[3]:
        return torch.full_like(t_lo, INF)
    for k, (o_k, inv_k) in enumerate(zip(o, inv)):
        a = (float(box[k]) - o_k) * inv_k
        b = (float(box[3 + k]) - o_k) * inv_k
        t_lo = torch.maximum(t_lo, torch.minimum(a, b))
        t_hi = torch.minimum(t_hi, torch.maximum(a, b))
    return torch.where(t_lo <= t_hi, t_lo, INF)


def _chunk_pass(boxes, o: V3, inv: V3, t_lo, t_hi):
    """Blocks [B] at padded chunk boxes [B, 6] against their lanes' windows
    [B, L]: mt.cuh:slab_pass, per block."""
    for k, (o_k, inv_k) in enumerate(zip(o, inv)):
        a = (boxes[:, k, None] - o_k) * inv_k
        b = (boxes[:, 3 + k, None] - o_k) * inv_k
        t_lo = torch.maximum(t_lo, torch.minimum(a, b))
        t_hi = torch.minimum(t_hi, torch.maximum(a, b))
    return (boxes[:, 0, None] <= boxes[:, 3, None]) & (t_lo <= t_hi)


def _blocks(x, nb, fill=0.0):
    """[R] -> [nb, BLOCK], the tail padded with `fill`."""
    pad = nb * BLOCK - x.shape[0]
    return torch.cat([x, x.new_full((pad,), fill)]).reshape(nb, BLOCK)


def trace_stream_plain(tri_planes, chunk_aabb, o: V3, d: V3, t_min, t_max,
                       any_hit: bool = False):
    """K3's plain twin. Per 128-ray block: each live lane's entry into each
    unit box (`unit_boxes`) gives its pass bit of the unit, and the
    block's entry is the minimum over the lanes. The units some lane
    reaches are sorted by (entry, unit id) and swept in that order, chunk
    by chunk; a lane tests a chunk when it passed the unit's box and its
    current window (closest-hit: t_min to min(t_max, best t)) passes the
    chunk's box. Closest-hit stops a block before a unit once every live
    lane's best t is below the unit's entry; any-hit once every live lane
    is occluded. (The kernel picks a segment's chunks, up to 32, with the
    windows as they stood at the segment's start, where this twin narrows
    them chunk by chunk; a wider window only adds tests, so neither
    changes a result.)

    o/d: V3s of [R] components; t_min, t_max [R] (t_max <= 0: dead
    lane). Returns {"t": [R] f32, "tri": [R] i32}."""
    r = o.x.shape[0]
    device = o.x.device
    nc = tri_planes.shape[2] // CT
    grp, n_units = stream_units(nc)
    nb = max(-(-r // BLOCK), 1)
    inv = safe_inv_dir(d)
    live = t_max > 0.0

    # 1. each lane's entry into each unit box: its bit, the block's entry
    ubox = unit_boxes(chunk_aabb, grp)
    e_lane = torch.stack([
        _blocks(torch.where(live, _unit_entry(ubox[u], o, inv, t_min,
                                              t_max), INF), nb, INF)
        for u in range(n_units)], dim=1)        # [nb, units, BLOCK]
    bits = e_lane < INF
    # 2. sort: stable, so equal entries keep ascending unit ids
    entry, order = torch.sort(e_lane.amin(dim=2), dim=1, stable=True)
    count = (entry < INF).sum(dim=1)

    # 3. sweep: step s tests chunk s % grp of the (s // grp)-th unit
    ob, db = V3(*(_blocks(x, nb) for x in o)), V3(*(_blocks(x, nb) for x in d))
    invb = V3(*(_blocks(x, nb) for x in inv))
    tmin_b, tmax_b = _blocks(t_min, nb), _blocks(t_max, nb)
    live_b = tmax_b > 0.0
    planes = tri_planes.reshape(4, 3, nc, CT)
    cbox = torch.from_numpy(padded_chunk_boxes(chunk_aabb)).to(device)
    t_best = torch.full((nb, BLOCK), INF, dtype=torch.float32, device=device)
    idx_best = torch.full((nb, BLOCK), -1, dtype=torch.int32, device=device)
    hit = torch.zeros((nb, BLOCK), dtype=torch.bool, device=device)
    sweeping = count > 0
    for s in range(int(count.max()) * grp):
        i, j = divmod(s, grp)
        if j == 0 and i > 0 and not any_hit:
            # leave before unit i once no live lane's best reaches it
            blk = torch.nonzero(sweeping & (i < count)).squeeze(1)
            open_ = live_b[blk] & ~(t_best[blk] < entry[blk, i, None])
            sweeping[blk] = open_.any(dim=1)
        blk = torch.nonzero(sweeping & (i < count)).squeeze(1)
        if blk.numel() == 0:
            break
        u = order[blk, i]
        c = u * grp + j
        in_range = c < nc          # the last unit may be short
        bk, u, c = blk[in_range], u[in_range], c[in_range]
        if bk.numel() == 0:
            continue
        want = live_b[bk] & bits[bk, u] & ~hit[bk] & _chunk_pass(
            cbox[c], V3(*(x[bk] for x in ob)), V3(*(x[bk] for x in invb)),
            tmin_b[bk], tmax_b[bk] if any_hit
            else torch.minimum(tmax_b[bk], t_best[bk]))
        tested = want.any(dim=1)
        bk, c, want = bk[tested], c[tested], want[tested]
        if bk.numel():
            t_new, k = mt_argmin(
                planes[:, :, c, None], V3(*(x[bk] for x in ob)),
                V3(*(x[bk] for x in db)), tmin_b[bk], tmax_b[bk],
                tmax_b[bk])
            if any_hit:
                hit[bk] |= want & (t_new < INF)
            else:
                ids = (k + c[:, None] * CT).to(torch.int32)
                tb, ib = t_best[bk], idx_best[bk]
                better = want & ((t_new < tb)
                                 | ((t_new == tb) & (ids < ib)))
                t_best[bk] = torch.where(better, t_new, tb)
                idx_best[bk] = torch.where(better, ids, ib)
        if any_hit:
            sweeping[blk] = (live_b[blk] & ~hit[blk]).any(dim=1)

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
    tri_planes [4, 3, Tp] and chunk_aabb [Tp/128, 8] f32, all contiguous
    on one CUDA device. Raises on anything else."""
    return launch_sweep("stream_", tri_planes, chunk_aabb, o, d, t_min,
                        t_max, any_hit)
