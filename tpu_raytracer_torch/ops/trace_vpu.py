"""Closest-hit by the elementwise exact-f32 sweep of chunk worklists:
the trace-kernel mode `vpu` (the reference's `_mt_kernel`,
`tpu_raytracer/ops/pallas_trace.py:1257-1323`, fed by the prepass
`_block_entry`, :1326).

  - `trace_vpu_plain`, the plain version: per block of BLOCK lanes, the
    chunks of its worklist (ops/worklist.py), each tested with
    `trace_api.mt_argmin`;
  - kernel K5 (`csrc/trace_vpu.cu`, `tpurt_vpu_closest_hit`), which
    `trace_vpu` launches on CUDA tensors.
The test is K1's and each lane keeps (t, triangle id) lexicographically;
the worklists come from padded boxes, so they hold every chunk K1's cull
keeps and both return `trace_api.trace_plain`'s answer on every lane.
`vpu` serves occlusion queries with the same sweep: `tri >= 0`.
"""

from __future__ import annotations

import torch

from ..utils.vec3 import V3
from . import worklist
from .trace_api import CT, INF, LAUNCHES, _check, load_kernels, mt_argmin

BLOCK = 128       # rays per K5 block: one worklist, one thread a ray


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


def vpu_kernel(tri_planes, counts, chunk_list, o, d, t_min, t_max):
    """Launch K5 on CUDA tensors: o, d [3, R] f32; t_min, t_max [R] f32
    (t_max <= 0: dead lane); tri_planes [4, 3, Tp] f32; the worklists of
    `vpu_worklists`, all contiguous on one CUDA device. Raises on
    anything else."""
    device = o.device
    if device.type != "cuda":
        raise ValueError(f"vpu_kernel needs CUDA tensors, got {device}")
    r = o.shape[1]
    tp = tri_planes.shape[2]
    if tp % CT:
        raise ValueError(f"tri_planes width {tp} is not a multiple of {CT}")
    nb = max(-(-r // BLOCK), 1)
    f32 = torch.float32
    _check(o, "o", (3, r), f32, device)
    _check(d, "d", (3, r), f32, device)
    _check(t_min, "t_min", (r,), f32, device)
    _check(t_max, "t_max", (r,), f32, device)
    _check(tri_planes, "tri_planes", (4, 3, tp), f32, device)
    _check(counts, "counts", (nb,), torch.int32, device)
    _check(chunk_list, "chunk_list", (tp // CT, nb), torch.int32, device)
    if r >= 2 ** 31 or 12 * tp >= 2 ** 31:
        raise ValueError("rays or triangle slots exceed int32 indexing")
    lib = load_kernels()
    t_out = torch.empty((r,), dtype=f32, device=device)
    tri_out = torch.empty((r,), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.tpurt_vpu_closest_hit(
            o.data_ptr(), d.data_ptr(), t_min.data_ptr(), t_max.data_ptr(),
            tri_planes.data_ptr(), counts.data_ptr(), chunk_list.data_ptr(),
            r, tp, t_out.data_ptr(), tri_out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"K5 launch failed: CUDA error {err}")
    LAUNCHES["vpu_closest_hit"] += 1
    return {"t": t_out, "tri": tri_out}


def vpu_worklists(chunk_aabb, o: V3, d: V3, t_min, t_max):
    """(counts, chunk_list): worklists of single chunks over blocks of
    BLOCK lanes, from the padded chunk boxes."""
    counts, chunk_list, _ = worklist.worklists(worklist.block_entry(
        o, d, t_min, t_max, worklist.pad_boxes(chunk_aabb),
        chunk_aabb.shape[0], BLOCK))
    return counts, chunk_list


def trace_vpu(tri_planes, chunk_aabb, o: V3, d: V3, t_min, t_max):
    """The `vpu` route's query: `vpu_worklists`, then the plain version
    on CPU tensors or K5 on CUDA tensors (it launches or raises)."""
    counts, chunk_list = vpu_worklists(chunk_aabb, o, d, t_min, t_max)
    if o.x.device.type == "cpu":
        return trace_vpu_plain(tri_planes, counts, chunk_list, o, d, t_min,
                               t_max)
    return vpu_kernel(tri_planes, counts, chunk_list, torch.stack(list(o)),
                      torch.stack(list(d)), t_min.contiguous(),
                      t_max.contiguous())
