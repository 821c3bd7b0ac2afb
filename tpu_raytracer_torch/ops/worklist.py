"""Per-block chunk worklists: the plain version of K5's route
(`trace_vpu.trace_vpu_plain`, the `vpu` mode on CPU tensors) and the
reference's prepass, held to it by the tests. On the card K5 and K6 build
their units in the kernel and run no prepass.

Port of the reference's XLA prepass `_block_entry`
(`tpu_raytracer/ops/pallas_trace.py:1326-1397`) and of the stable sort
that turns its entry matrix into the kernels' worklists (:1623-1628).
The rays are cut into blocks of `br` lanes; a unit (`grp` consecutive
chunks) enters block b's worklist when some live lane's window (t_min,
t_max) crosses one of its boxes, with the block's least entry t as its
sort key. The arithmetic is the reference's, operation for operation,
so on the same boxes the entries, counts and lists are its bit for bit.

The `vpu` route passes boxes padded by `pad_boxes` (the padding of
`csrc/mt.cuh:slab_window`), so the worklists are conservative as K1's
cull is: a chunk holding a hit is never dropped, and a sweep of the
worklist returns K1's answer. Plain torch ops: the reference computes
this outside any Pallas kernel.
"""

from __future__ import annotations

import torch

from .intersect import DIR_EPS, INF


def pad_boxes(aabb: torch.Tensor) -> torch.Tensor:
    """AABBs [N, 8] grown by 1e-5 of their coordinates' magnitude plus
    1e-6 on every side, in f32, as `mt.cuh:slab_window` pads them."""
    lo, hi = aabb[:, 0:3], aabb[:, 3:6]
    pad = 1e-5 * (lo.abs() + hi.abs()) + 1e-6
    return torch.cat([lo - pad, hi + pad, aabb[:, 6:8]], dim=1)


def group_boxes(aabb: torch.Tensor, grp: int) -> torch.Tensor:
    """Union AABBs [ceil(N / grp), 8] of `grp` consecutive boxes, the
    last group padded with empty boxes (pallas_trace.py:1359-1370,
    1489-1501)."""
    n = aabb.shape[0]
    ng = -(-n // grp)
    pad = ng * grp - n
    if pad:
        empty = aabb.new_zeros((pad, 8))
        empty[:, 0:3], empty[:, 3:6] = INF, -INF
        aabb = torch.cat([aabb, empty])
    ca = aabb.reshape(ng, grp, 8)
    return torch.cat([ca[:, :, 0:3].amin(dim=1), ca[:, :, 3:6].amax(dim=1),
                      aabb.new_zeros((ng, 2))], dim=1)


def _blocked(x: torch.Tensor, nb: int, br: int) -> torch.Tensor:
    """[R] -> [1, nb, br], the tail zero (a dead lane: t_max = 0)."""
    pad = nb * br - x.shape[0]
    return torch.cat([x, x.new_zeros((pad,))]).reshape(1, nb, br)


def block_entry(o, d, t_min, t_max, aabb, num_chunks: int, br: int,
                grp: int = 1, force_union: bool = False) -> torch.Tensor:
    """The entry matrix e_blk [nb, NU], NU = ceil(num_chunks / grp): the
    least entry t of block b's live lanes into unit u, INF where none
    reaches it. o, d: V3s of [R] components; t_min, t_max [R] (t_max <=
    0: dead lane); aabb [num_chunks, 8]. With `force_union`, the units'
    union boxes are tested (the reference's group cull); otherwise each
    chunk's box, and a unit takes its chunks' least entry. No route uses
    `force_union` (the in-kernel cull tests `group_boxes` itself); it is
    kept as the reference's twin for its tests."""
    r = t_min.shape[0]
    nb = max(-(-r // br), 1)
    boxes = aabb
    union = grp > 1 and force_union
    if union:
        boxes = group_boxes(aabb, grp)
    tmin_nb = _blocked(t_min, nb, br)
    tmax_nb = _blocked(t_max, nb, br)
    n_u = boxes.shape[0]
    t_lo = tmin_nb.expand(n_u, nb, br)
    t_hi = tmax_nb.expand(n_u, nb, br)
    for k in range(3):
        d_k = d[k]
        inv_k = _blocked(1.0 / torch.where(
            d_k.abs() < DIR_EPS,
            torch.where(d_k < 0, -DIR_EPS, DIR_EPS), d_k), nb, br)
        o_k = _blocked(o[k], nb, br)
        lo_k = (boxes[:, k, None, None] - o_k) * inv_k
        hi_k = (boxes[:, k + 3, None, None] - o_k) * inv_k
        t_lo = torch.maximum(t_lo, torch.minimum(lo_k, hi_k))
        t_hi = torch.minimum(t_hi, torch.maximum(lo_k, hi_k))
    ray_hit = (t_lo <= t_hi) & (tmax_nb > 0.0)
    e_blk = torch.where(ray_hit, t_lo, INF).amin(dim=2).T      # [nb, n_u]
    if grp > 1 and not union:
        ng = -(-num_chunks // grp)
        pad = ng * grp - num_chunks
        if pad:
            e_blk = torch.cat([e_blk, e_blk.new_full((nb, pad), INF)], dim=1)
        e_blk = e_blk.reshape(nb, ng, grp).amin(dim=2)
    return e_blk.contiguous()


def worklists(e_blk: torch.Tensor):
    """(counts [nb] i32, unit_list [NU, nb] i32, entry_list [NU, nb] f32):
    each block's reached units sorted by (entry, unit id), those no lane
    reaches last and not counted (pallas_trace.py:1623-1628)."""
    entry, order = torch.sort(e_blk, dim=1, stable=True)
    counts = (e_blk < INF).sum(dim=1).to(torch.int32)
    return (counts, order.to(torch.int32).T.contiguous(),
            entry.T.contiguous())
