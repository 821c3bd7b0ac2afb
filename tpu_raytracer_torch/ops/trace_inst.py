"""Two-level instanced ray queries: one object-space triangle block per
mesh, shared by every instance of it; each instance adds a world->object
affine and a world AABB (the reference's shared-BLAS mode,
`tpu_raytracer/ops/pallas_trace.py:1850-2261`).

Rays are moved into each instance's object space with UNNORMALIZED
directions, so the hit parameter t is the same in both spaces. A hit is
(t, object triangle id, instance id).

  - `trace_instanced_plain`, the twin of the reference's
    `_trace_instanced_xla`: a scan over (instance, group) units in the
    scene's unit order with a running arg-min;
  - kernel K4 (`csrc/trace_inst.cu`, `tpurt_inst_closest_hit` and
    `tpurt_inst_any_hit`), which `trace_instanced_kernel` launches.
`ops/trace_api.py:scene_trace` takes the plain version for a CPU tensor
and K4 for a CUDA tensor, with no fallback between them.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from ..utils.vec3 import V3
from .intersect import INF, fma, safe_inv_dir
from .trace_api import (CT, _check, count_launch, load_kernels, mt_argmin,
                        slab_pass)

# triangles per object group, the instanced cull unit: two 128-triangle
# chunks (the reference's INST_GRP = 2)
GROUP = 2 * CT
INST_COLS = 23            # inst_table row width
MAX_UNITS = 128           # K4's unit capacity (TPURT_INST_MAX_UNITS)


def inst_units(num_instances: int):
    """(grp, units): K4 sorts units of `grp` consecutive instances, grp
    the smallest power of two that keeps the unit count within MAX_UNITS
    (the rule of csrc/trace_inst.cu:launch)."""
    grp = 1
    while -(-num_instances // grp) > MAX_UNITS:
        grp *= 2
    return grp, -(-num_instances // grp)


def pack_triangles_instanced(mesh_tris):
    """Per-mesh object-space packing
    (`tpu_raytracer/ops/pallas_trace.py:pack_triangles_instanced`).

    mesh_tris: list of (v0 [t, 3], e1, e2) per mesh. Each mesh is padded
    to a multiple of GROUP triangles, so no group spans two meshes.

    Returns (planes [4, 3, TpO], gaabb [8, NGO] object group AABBs, rows
    min xyz | max xyz | 0 0, an empty group as (INF, -INF); spans
    [2, NMesh] i32 = (first group, group count) per mesh)."""
    planes_list, aabb_cols, spans = [], [], []
    g0 = 0
    for v0, e1, e2 in mesh_tris:
        t = v0.shape[0]
        tp = max(((t + GROUP - 1) // GROUP) * GROUP, GROUP)
        p = np.zeros((4, 3, tp), np.float32)
        p[0, :, :t] = v0.T
        p[1, :, :t] = e1.T
        p[2, :, :t] = e2.T
        p[3, 0, :t] = 1.0
        planes_list.append(p)
        ng = tp // GROUP
        v1 = v0 + e1
        v2 = v0 + e2
        mn = np.minimum(np.minimum(v0, v1), v2)
        mx = np.maximum(np.maximum(v0, v1), v2)
        for g in range(ng):
            lo, hi = g * GROUP, min((g + 1) * GROUP, t)
            box = np.zeros(8, np.float32)
            if lo < hi:
                box[0:3] = mn[lo:hi].min(axis=0)
                box[3:6] = mx[lo:hi].max(axis=0)
            else:
                box[0:3] = INF
                box[3:6] = -INF
            aabb_cols.append(box)
        spans.append((g0, ng))
        g0 += ng
    planes = np.concatenate(planes_list, axis=2)
    gaabb = np.stack(aabb_cols, axis=1)
    return planes, gaabb, np.asarray(spans, np.int32).T


def to_object(row, o: V3, d: V3):
    """World -> object space through one inst_table row ([>= 12] f32:
    A^-1 row-major | b). Rounded as XLA:CPU rounds the reference's
    `ray_o @ a.T + b`: fma(a[r,2], z, fma(a[r,1], y, a[r,0] * x)) + b[r];
    the direction is the same expression without `+ b`."""
    def rows(v):
        return [fma(row[3 * k + 2], v.z, fma(row[3 * k + 1], v.y,
                                             row[3 * k] * v.x))
                for k in range(3)]
    return (V3(*(x + row[9 + k] for k, x in enumerate(rows(o)))),
            V3(*rows(d)))


def trace_instanced_plain(obj_planes, obj_gaabb, inst_table, inst_aabb,
                          unit_inst, unit_group, o: V3, d: V3, t_min, t_max):
    """Closest hit over every (instance, group) unit, in unit order, with
    a running arg-min; `t_max <= 0` marks a dead lane. Returns {"t": [R]
    f32 (INF on a miss), "tri": [R] i32 object triangle, "inst": [R] i32}.

    Strict `<` against the running best: an exact-t tie goes to the
    earlier instance, then group, then lane. Each instance is tested only
    against the rays whose window passes its world AABB, and each group
    only against the rays whose object-space window passes its AABB
    (`slab_pass`), which changes no result. K4 computes the same
    operations in the same order."""
    r = o.x.shape[0]
    device = o.x.device
    t_best = torch.full((r,), INF, dtype=torch.float32, device=device)
    idx_best = torch.full((r,), -1, dtype=torch.int32, device=device)
    inst_best = torch.full((r,), -1, dtype=torch.int32, device=device)
    inv = safe_inv_dir(d)
    live = t_max > 0.0
    inst_boxes = inst_aabb.cpu().tolist()
    group_boxes = obj_gaabb.T.cpu().tolist()
    units = zip(unit_inst.cpu().tolist(), unit_group.cpu().tolist())
    for i, run in itertools.groupby(units, key=lambda u: u[0]):
        sel = live & slab_pass(inst_boxes[i], o, inv, t_min,
                               torch.minimum(t_max, t_best))
        lanes_i = torch.nonzero(sel).squeeze(1)
        if lanes_i.numel() == 0:
            continue
        oo, od = to_object(inst_table[i], V3(*(x[lanes_i] for x in o)),
                           V3(*(x[lanes_i] for x in d)))
        o_inv = safe_inv_dir(od)
        lo_i, hi_i = t_min[lanes_i], t_max[lanes_i]
        for _, g in run:
            sel = slab_pass(group_boxes[g], oo, o_inv, lo_i,
                            torch.minimum(hi_i, t_best[lanes_i]))
            sub = torch.nonzero(sel).squeeze(1)
            if sub.numel() == 0:
                continue
            lanes = lanes_i[sub]
            best = t_best[lanes]
            t_new, k = mt_argmin(
                obj_planes[:, :, g * GROUP:(g + 1) * GROUP],
                V3(*(x[sub] for x in oo)), V3(*(x[sub] for x in od)),
                lo_i[sub], hi_i[sub], best)
            improved = t_new < best
            t_best[lanes] = torch.where(improved, t_new, best)
            idx_best[lanes] = torch.where(
                improved, (k + g * GROUP).to(torch.int32), idx_best[lanes])
            inst_best[lanes] = torch.where(improved, i, inst_best[lanes])
    return {"t": torch.where(idx_best < 0, INF, t_best), "tri": idx_best,
            "inst": inst_best}


def trace_instanced_kernel(obj_planes, obj_gaabb, inst_table, inst_aabb,
                           inst_span, o, d, t_min, t_max,
                           any_hit: bool = False):
    """Launch K4 on CUDA tensors: closest-hit, or with `any_hit` the
    any-hit entry (tri = 1 / -1, t = t_max, inst = an occluder or -1).

    o, d: [3, R] f32; t_min, t_max: [R] f32 (t_max <= 0: dead lane);
    obj_planes [4, 3, NGO * 256], obj_gaabb [8, NGO], inst_table [I, 23]
    and inst_aabb [I, 8] f32; inst_span [2, I] i32 (first group, count,
    each span inside [0, NGO), as the builder makes them); all contiguous
    on one CUDA device, with I * NGO * 256 < 2^32 (the kernel keys a hit
    by instance * slots + triangle in 32 bits). Raises on anything else."""
    device = o.device
    if device.type != "cuda":
        raise ValueError(
            f"trace_instanced_kernel needs CUDA tensors, got {device}")
    r = o.shape[1]
    ngo = obj_gaabb.shape[1]
    n_inst = inst_table.shape[0]
    f32 = torch.float32
    _check(o, "o", (3, r), f32, device)
    _check(d, "d", (3, r), f32, device)
    _check(t_min, "t_min", (r,), f32, device)
    _check(t_max, "t_max", (r,), f32, device)
    _check(obj_planes, "obj_planes", (4, 3, ngo * GROUP), f32, device)
    _check(obj_gaabb, "obj_gaabb", (8, ngo), f32, device)
    _check(inst_table, "inst_table", (n_inst, INST_COLS), f32, device)
    _check(inst_aabb, "inst_aabb", (n_inst, 8), f32, device)
    _check(inst_span, "inst_span", (2, n_inst), torch.int32, device)
    if r >= 2 ** 31 or 12 * ngo * GROUP >= 2 ** 31:
        raise ValueError("rays or triangle slots exceed int32 indexing")
    if n_inst * ngo * GROUP >= 2 ** 32:
        raise ValueError(f"{n_inst} instances x {ngo * GROUP} slots exceed "
                         f"the kernel's 32-bit hit key")
    lib = load_kernels()
    t_out = torch.empty((r,), dtype=f32, device=device)
    tri_out = torch.empty((r,), dtype=torch.int32, device=device)
    inst_out = torch.empty((r,), dtype=torch.int32, device=device)
    fn = lib.tpurt_inst_any_hit if any_hit else lib.tpurt_inst_closest_hit
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(o.data_ptr(), d.data_ptr(), t_min.data_ptr(),
                 t_max.data_ptr(), obj_planes.data_ptr(),
                 obj_gaabb.data_ptr(), inst_table.data_ptr(),
                 inst_aabb.data_ptr(), inst_span.data_ptr(), r, n_inst, ngo,
                 t_out.data_ptr(), tri_out.data_ptr(), inst_out.data_ptr(),
                 stream)
    if err != 0:
        raise RuntimeError(f"instanced {'any' if any_hit else 'closest'}-hit "
                           f"kernel launch failed: CUDA error {err}")
    count_launch("inst_any_hit" if any_hit else "inst_closest_hit")
    return {"t": t_out, "tri": tri_out, "inst": inst_out}

