"""Closest-hit by the exact-f32 sweep of the trace-kernel mode `vpu` (the
reference's `_mt_kernel`, `tpu_raytracer/ops/pallas_trace.py:1257-1323`,
fed by the prepass `_block_entry`, :1326).

  - `trace_vpu_plain`, the plain version: per block of BLOCK lanes, the
    chunks of its worklist (ops/worklist.py, the twin of the reference's
    prepass), each tested with `trace_api.mt_argmin`;
  - kernel K5 (`csrc/trace_vpu.cu`, `tpurt_vpu_closest_hit`), which
    `trace_vpu` launches on CUDA tensors: an instance of the sweep of
    `csrc/sweep.cuh`, which builds its units in the kernel, so the CUDA
    route runs no prepass.
The test is K1's and each lane keeps (t, triangle id) lexicographically;
the worklists come from padded boxes, so they hold every chunk K1's cull
keeps, and both return `trace_api.trace_plain`'s answer on every lane.
`vpu` serves occlusion queries with the same sweep: `tri >= 0`.
"""

from __future__ import annotations

import torch

from ..utils.vec3 import V3
from . import trace_stream, worklist
from .intersect import INF
from .trace_api import (CT, MXUF_MAX_TP, SWEPT_MAX_UNITS, _stacked,
                        launch_sweep, mt_argmin)

BLOCK = 128       # rays per block of the plain version's worklists


def trace_vpu_plain(tri_planes, counts, chunk_list, o: V3, d: V3, t_min,
                    t_max):
    """K5's plain version: step i tests chunk chunk_list[i, b] against
    the lanes of every block b with counts[b] > i. Returns {"t": [R] f32
    (INF on a miss), "tri": [R] i32}."""
    r = t_min.shape[0]
    device = t_min.device
    nc = tri_planes.shape[2] // CT
    planes = tri_planes.reshape(4, 3, nc, CT)
    t_best = torch.full((r,), INF, dtype=torch.float32, device=device)
    idx_best = torch.full((r,), -1, dtype=torch.int32, device=device)
    lane = torch.arange(BLOCK, device=device)
    for i in range(int(counts.max()) if counts.numel() else 0):
        blocks = torch.nonzero(counts > i).squeeze(1)
        chunks = chunk_list[i, blocks].long()
        lanes = blocks[:, None] * BLOCK + lane                 # [B, BLOCK]
        keep = lanes < r
        lanes = torch.where(keep, lanes, 0)
        t_new, k = mt_argmin(planes[:, :, chunks, None],
                             V3(*(x[lanes] for x in o)),
                             V3(*(x[lanes] for x in d)), t_min[lanes],
                             t_max[lanes], t_max[lanes])
        ids = (k + chunks[:, None] * CT).to(torch.int32)
        tb, ib = t_best[lanes], idx_best[lanes]
        better = keep & (t_max[lanes] > 0.0) & (
            (t_new < tb) | ((t_new == tb) & (t_new < INF) & (ids < ib)))
        t_best[lanes[better]] = t_new[better]
        idx_best[lanes[better]] = ids[better]
    return {"t": torch.where(idx_best < 0, INF, t_best), "tri": idx_best}


def vpu_max_units(tp: int) -> int:
    """K5's unit capacity at `tp` triangle slots: K1's up to MXUF_MAX_TP
    and K3's past it, the rule by which `trace_api.trace_route` sends the
    default query to K1 or K3."""
    return SWEPT_MAX_UNITS if tp <= MXUF_MAX_TP else trace_stream.MAX_UNITS


def vpu_kernel(tri_planes, chunk_aabb, o, d, t_min, t_max):
    """Launch K5 on CUDA tensors at `vpu_max_units(Tp)` units: o, d [3, R]
    f32; t_min, t_max [R] f32 (t_max <= 0: dead lane); tri_planes [4, 3,
    Tp] and chunk_aabb [Tp/128, 8] f32, all contiguous on one CUDA
    device. Raises on anything else."""
    return launch_sweep("vpu_", tri_planes, chunk_aabb, o, d, t_min, t_max,
                        any_hit=False,
                        max_units=vpu_max_units(tri_planes.shape[2]))


def vpu_worklists(chunk_aabb, o: V3, d: V3, t_min, t_max):
    """(counts, chunk_list): worklists of single chunks over blocks of
    BLOCK lanes, from the padded chunk boxes (the plain version's)."""
    counts, chunk_list, _ = worklist.worklists(worklist.block_entry(
        o, d, t_min, t_max, worklist.pad_boxes(chunk_aabb),
        chunk_aabb.shape[0], BLOCK))
    return counts, chunk_list


def trace_vpu(tri_planes, chunk_aabb, o, d, t_min, t_max):
    """The `vpu` route's query: on CPU tensors `vpu_worklists` and the
    plain version, on CUDA tensors K5 alone (it launches or raises). o, d:
    V3s, or [3, R] tensors on a CUDA device."""
    if t_max.device.type == "cpu":
        counts, chunk_list = vpu_worklists(chunk_aabb, o, d, t_min, t_max)
        return trace_vpu_plain(tri_planes, counts, chunk_list, o, d, t_min,
                               t_max)
    return vpu_kernel(tri_planes, chunk_aabb, _stacked(o), _stacked(d),
                      t_min.contiguous(), t_max.contiguous())
