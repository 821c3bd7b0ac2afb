"""Closest- and any-hit by the feature-matmul Moller-Trumbore test: the
trace-kernel modes `mxu3`, `mxu1`, `mxuw[N]` and the in-kernel cull of
`mxuf*` (the reference's `TPU_RT_INCULL`).

det, u·det, v·det and t·det are linear in a 16-feature ray vector
phi = [o_i d_j (9), d (3), o (3), 1]; the reference multiplies phi by a
per-triangle coefficient table on its matrix unit, in bf16 hi/lo splits
with f32 accumulation, and tests the window on the products
(`tpu_raytracer/ops/pallas_trace.py:251-376, 701-794, 1070-1254`).
This module holds:
  - the twins of `mt_coef_device` (both layouts), `_split_bf16`,
    `mt_coef48` and the feature rows of `_feat48_from`;
  - `trace_mxu_plain`, the plain version of kernel K6: the bf16 products
    formed exactly and summed in f64, rounded once to f32, then the
    reference's window test;
  - `trace_mxu`, which launches K6 (`csrc/trace_mxu.cu`) on CUDA tensors.
Each lane keeps its (t, triangle id) pairs lexicographically, so an
exact-t tie goes to the lowest id in any sweep order (the port's rule).
Any-hit returns tri = 1 / -1 and t = t_max, K2's contract.
"""

from __future__ import annotations

import torch

from ..utils.vec3 import V3
from . import worklist
from .trace_api import (CT, INF, LAUNCHES, MT_EPS, MXUW_GROUP, _check,
                        _cross, _dot, load_kernels, safe_inv, slab_pass,
                        trace_route)

BLOCK = 128       # rays per K6 block: one worklist, four warps of 32 rays


# ---------------------------------------------------------------------------
# Coefficient tables and features
# ---------------------------------------------------------------------------

def mt_coef(tri_planes: torch.Tensor, wide: bool = False,
            group: int = MXUW_GROUP) -> torch.Tensor:
    """Planes [4, 3, Tp] -> feature-matmul coefficients, the twin of
    `mt_coef_device` (pallas_trace.py:251-307):
        det   =  d . (e2 x e1)
        u_num =  det3(o, d, e2) + d . (v0 x e2)
        v_num = -det3(o, d, e1) - d . (v0 x e1)
        t_num =  o . n - v0 . n,  n = e1 x e2
    Narrow: [16, NC*4*CT], chunk c at columns [c*4CT, (c+1)*4CT) as
    [det | u | v | t] blocks of CT. Wide: [16, NG*4*group*CT], group g
    a [det | u | v | t]-major block of 4*group*CT columns, each quantity
    chunk-major. The crosses and the dot fuse their first products as
    XLA:CPU does (`trace_api._cross`, `_dot`). Padding triangles are all
    zero, so det = 0 and they never hit. K6 reads only the narrow layout
    (through `kernel_table`); the wide one is kept as the reference's twin
    for its tests."""
    tp = tri_planes.shape[2]
    nc = tp // CT
    v0, e1, e2 = tri_planes[0], tri_planes[1], tri_planes[2]
    n = _cross(*e1, *e2)
    z = torch.zeros_like(v0[0])

    def skew(e):
        # entry 3*i + j: o_i d_j S = det3(o, d, e)
        return [z, e[2], -e[1], -e[2], z, e[0], e[1], -e[0], z]

    c_det = [z] * 9 + list(_cross(*e2, *e1)) + [z] * 4
    c_u = skew(e2) + list(_cross(*v0, *e2)) + [z] * 4
    c_v = [-s for s in skew(e1)] + [-x for x in _cross(*v0, *e1)] + [z] * 4
    c_t = [z] * 12 + list(n) + [-_dot(*v0, *n)]
    coef = torch.stack([torch.stack(cols) for cols in (c_det, c_u, c_v, c_t)])
    if not wide:                                       # [4, 16, Tp]
        return (coef.reshape(4, 16, nc, CT).permute(1, 2, 0, 3)
                .reshape(16, nc * 4 * CT))
    ng = -(-nc // group)
    pad = ng * group * CT - tp
    if pad:
        coef = torch.cat([coef, coef.new_zeros((4, 16, pad))], dim=2)
    coef = coef.reshape(4, 16, ng, group, CT).permute(1, 2, 0, 3, 4)
    return coef.reshape(16, ng * 4 * group * CT)


def split_bf16(x: torch.Tensor):
    """f32 -> (hi, lo) bf16 with hi + lo ~ x to 16 significant bits, each
    rounded to nearest even (`_split_bf16`, pallas_trace.py:1149-1163).
    x - hi is exact in f32."""
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.float()).to(torch.bfloat16)


def mt_coef48(tri_planes: torch.Tensor, group: int = 1) -> torch.Tensor:
    """The fused 3-pass table [48, NG*group*4*CT] bf16, rows [c_hi; c_lo;
    c_hi], the chunk count padded to a multiple of `group` with zero
    columns (`mt_coef48`, pallas_trace.py:343-357). K6 reads group 1;
    other groups are kept as the reference's twin for its tests."""
    coef = mt_coef(tri_planes)
    nc = coef.shape[1] // (4 * CT)
    pad = (-(-nc // group) * group - nc) * 4 * CT
    if pad:
        coef = torch.cat([coef, coef.new_zeros((16, pad))], dim=1)
    hi, lo = split_bf16(coef)
    return torch.cat([hi, lo, hi])


def kernel_table(tri_planes: torch.Tensor) -> torch.Tensor:
    """K6's coefficient table: `mt_coef48` at group 1, one row of 48 bf16
    per column of it [NC*4*CT, 48], so a thread reads a column's k-pairs
    as 32-bit words."""
    return mt_coef48(tri_planes).T.contiguous()


def mode_table(tri_planes: torch.Tensor, kernel: str, incull: bool,
               instanced: bool = False):
    """`kernel_table` of a flattened scene whose mode routes its
    closest-hit queries to K6 (its any-hit queries go there only with
    them), else None."""
    route = trace_route(kernel, incull, tri_planes.shape[2], False)[0]
    if instanced or route not in ("mxu", "incull"):
        return None
    return kernel_table(tri_planes)


def feat48(o: V3, d: V3) -> torch.Tensor:
    """[f_hi; f_hi; f_lo] [48, R] bf16, the split of the features phi =
    [o_i d_j (9), d (3), o (3), 1] (`_feat48_from`, :360-376): one K = 48
    product against `mt_coef48` sums hi*hi + hi*lo + lo*hi."""
    ox, oy, oz = o
    dx, dy, dz = d
    phi = torch.stack([ox * dx, ox * dy, ox * dz, oy * dx, oy * dy, oy * dz,
                       oz * dx, oz * dy, oz * dz, dx, dy, dz, ox, oy, oz,
                       torch.ones_like(ox)])
    f_hi, f_lo = split_bf16(phi)
    return torch.cat([f_hi, f_hi, f_lo])


# ---------------------------------------------------------------------------
# Plain PyTorch version (CPU tensors; also the on-card comparison baseline)
# ---------------------------------------------------------------------------

def window_test(prod: torch.Tensor, t_min, t_max, any_hit: bool):
    """The reference's test on products [L, 4*CT] ([det | u | v | t]
    numerators, :1231-1249; any-hit division-free, :758-765). t_min,
    t_max [L, 1]. Returns (hit [L, CT], t [L, CT]); t is None for
    any-hit."""
    det, u_n, v_n, t_n = prod.split(CT, dim=1)
    sgn = torch.where(det >= 0.0, 1.0, -1.0)
    d_abs = det * sgn
    ok = d_abs > MT_EPS
    u2 = u_n * sgn
    v2 = v_n * sgn
    inside = ok & (u2 >= 0.0) & (v2 >= 0.0) & (u2 + v2 <= d_abs) \
        & (t_max > 0.0)
    if any_hit:
        tn2 = t_n * sgn
        return inside & (tn2 > t_min * d_abs) & (tn2 < t_max * d_abs), None
    t_val = (t_n * sgn) / torch.where(ok, d_abs, 1.0)
    return inside & (t_val > t_min) & (t_val < t_max), t_val


def trace_mxu_plain(coef48_t, units, grp: int, o: V3, d: V3, t_min, t_max,
                    passes: int = 3, any_hit: bool = False,
                    block: int = BLOCK):
    """K6's plain version. coef48_t: `kernel_table` [NC*4*CT, 48] bf16;
    units [nb, NU] bool: the units (grp consecutive chunks) block b of
    `block` lanes sweeps. Per swept chunk the products are phi's bf16
    split against the table's, `passes` = 3 (hi*hi + hi*lo + lo*hi) or 1
    (hi*hi), each exact in f64 and summed there, rounded once to f32; the
    sum's order then does not matter. Returns {"t", "tri"}."""
    r = t_min.shape[0]
    nc = coef48_t.shape[0] // (4 * CT)
    k = 48 if passes == 3 else 16
    f48 = feat48(o, d).T[:, :k].double()                     # [R, k]
    table = coef48_t[:, :k].double()
    t_best = torch.full((r,), INF, dtype=torch.float32, device=t_min.device)
    idx_best = torch.full((r,), -1, dtype=torch.int32, device=t_min.device)
    hit_any = torch.zeros((r,), dtype=torch.bool, device=t_min.device)
    lane = torch.arange(block, device=t_min.device)
    for u in range(units.shape[1]):
        blocks = torch.nonzero(units[:, u]).squeeze(1)
        if blocks.numel() == 0:
            continue
        lanes = (blocks[:, None] * block + lane).reshape(-1)
        lanes = lanes[lanes < r]
        lo, hi = t_min[lanes, None], t_max[lanes, None]
        for c in range(u * grp, min((u + 1) * grp, nc)):
            cols = table[c * 4 * CT:(c + 1) * 4 * CT]         # [4*CT, k]
            prod = (f48[lanes] @ cols.T).float()
            hit, t_val = window_test(prod, lo, hi, any_hit)
            if any_hit:
                hit_any[lanes] |= hit.any(dim=1)
                continue
            t_cand = torch.where(hit, t_val, INF)
            t_new, j = t_cand.min(dim=1)                      # first minimum
            ids = (j + c * CT).to(torch.int32)
            tb, ib = t_best[lanes], idx_best[lanes]
            better = (t_new < tb) | ((t_new == tb) & (t_new < INF)
                                     & (ids < ib))
            t_best[lanes] = torch.where(better, t_new, tb)
            idx_best[lanes] = torch.where(better, ids, ib)
    if any_hit:
        return {"t": t_max.clone(),
                "tri": torch.where(hit_any, 1, -1).to(torch.int32)}
    return {"t": torch.where(idx_best < 0, INF, t_best), "tri": idx_best}


def incull_units(group_aabb, o: V3, d: V3, t_min, t_max,
                 block: int = BLOCK) -> torch.Tensor:
    """[nb, NG] bool: block b sweeps group g when some live lane's window
    (t_min, t_max) passes the group box's padded slab test (`slab_pass`):
    the in-kernel guard of #5 (`slab_any`, :727-743), made conservative
    as K1's cull is."""
    r = t_min.shape[0]
    nb = max(-(-r // block), 1)
    inv = safe_inv(d)
    live = t_max > 0.0
    cols = []
    for box in group_aabb.cpu().tolist():
        ok = live & slab_pass(box, o, inv, t_min, t_max)
        ok = torch.cat([ok, ok.new_zeros((nb * block - r,))])
        cols.append(ok.reshape(nb, block).any(dim=1))
    return torch.stack(cols, dim=1)


def worklist_units(counts, unit_list) -> torch.Tensor:
    """[nb, NU] bool from worklists: block b sweeps its first counts[b]
    units."""
    n_units, nb = unit_list.shape
    units = torch.zeros((nb, n_units), dtype=torch.bool,
                        device=counts.device)
    listed = torch.arange(n_units, device=counts.device)[:, None] \
        < counts[None, :]
    units[torch.arange(nb, device=counts.device).expand(n_units, nb)[listed],
          unit_list[listed].long()] = True
    return units


# ---------------------------------------------------------------------------
# K6 (CUDA tensors) and the mode's entry point
# ---------------------------------------------------------------------------

def mxu_kernel(coef48_t, group_aabb, counts, unit_list, o, d, t_min, t_max,
               grp, passes, incull, any_hit):
    """Launch K6 on CUDA tensors: o, d [3, R] f32; t_min, t_max [R] f32
    (t_max <= 0: dead lane); coef48_t from `kernel_table`; with `incull`
    the units' union boxes group_aabb, else the worklists of
    `mxu_worklists`; all contiguous on one CUDA device. Raises on
    anything else, and on a variant no route takes."""
    device = o.device
    if device.type != "cuda":
        raise ValueError(f"mxu_kernel needs CUDA tensors, got {device}")
    r = o.shape[1]
    f32 = torch.float32
    cols = coef48_t.shape[0]
    if cols % (4 * CT):
        raise ValueError(f"coefficient table has {cols} columns, not a "
                         f"multiple of {4 * CT}")
    nc = cols // (4 * CT)
    nb = max(-(-r // BLOCK), 1)
    _check(o, "o", (3, r), f32, device)
    _check(d, "d", (3, r), f32, device)
    _check(t_min, "t_min", (r,), f32, device)
    _check(t_max, "t_max", (r,), f32, device)
    _check(coef48_t, "coef48_t", (cols, 48), torch.bfloat16, device)
    if incull:
        _check(group_aabb, "group_aabb", (-(-nc // grp), 8), f32, device)
    else:
        _check(counts, "counts", (nb,), torch.int32, device)
        _check(unit_list, "unit_list", (-(-nc // grp), nb), torch.int32,
               device)
    if passes not in (1, 3) or (incull and passes != 3) \
            or (any_hit and not incull):
        raise ValueError(f"K6 has no variant passes={passes}, "
                         f"incull={incull}, any_hit={any_hit}")
    if r >= 2 ** 31 or 48 * cols >= 2 ** 31:
        raise ValueError("rays or table exceed int32 indexing")
    lib = load_kernels()
    t_out = torch.empty((r,), dtype=f32, device=device)
    tri_out = torch.empty((r,), dtype=torch.int32, device=device)
    null = 0
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        args = (o.data_ptr(), d.data_ptr(), t_min.data_ptr(),
                t_max.data_ptr(), coef48_t.data_ptr(),
                group_aabb.data_ptr() if incull else null,
                null if incull else counts.data_ptr(),
                null if incull else unit_list.data_ptr(), r, nc, grp)
        if any_hit:
            err = lib.tpurt_mxu_any_hit(*args, t_out.data_ptr(),
                                        tri_out.data_ptr(), stream)
        else:
            err = lib.tpurt_mxu_closest_hit(*args, passes, int(incull),
                                            t_out.data_ptr(),
                                            tri_out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"K6 {'any' if any_hit else 'closest'}-hit "
                           f"launch failed: CUDA error {err}")
    LAUNCHES["mxu_any_hit" if any_hit else "mxu_closest_hit"] += 1
    return {"t": t_out, "tri": tri_out}


def mxu_worklists(chunk_aabb, grp: int, o: V3, d: V3, t_min, t_max):
    """(counts, unit_list): worklists of grp-chunk units over blocks of
    BLOCK lanes, from the padded chunk boxes."""
    counts, unit_list, _ = worklist.worklists(worklist.block_entry(
        o, d, t_min, t_max, worklist.pad_boxes(chunk_aabb),
        chunk_aabb.shape[0], BLOCK, grp))
    return counts, unit_list


def trace_mxu(coef48_t, chunk_aabb, o: V3, d: V3, t_min, t_max, grp: int,
              passes: int = 3, incull: bool = False, any_hit: bool = False):
    """One query of a K6 route: the plain version on CPU tensors, K6 on
    CUDA tensors (it launches or raises). Worklist variants (`mxu3`,
    `mxu1`, `mxuw[N]`) sweep `mxu_worklists`; the in-kernel cull
    (`incull`) slab-tests each group's padded union box against the
    block's windows in the kernel. Any-hit is served only by the
    in-kernel cull, as in the reference's routes."""
    if coef48_t is None:
        raise ValueError("the scene carries no coefficient table for K6: "
                         "build it under a mode whose route takes K6")
    group_aabb = counts = unit_list = None
    if incull:
        group_aabb = worklist.group_boxes(chunk_aabb, grp)
    else:
        counts, unit_list = mxu_worklists(chunk_aabb, grp, o, d, t_min,
                                          t_max)
    if o.x.device.type == "cpu":
        units = (incull_units(group_aabb, o, d, t_min, t_max) if incull
                 else worklist_units(counts, unit_list))
        return trace_mxu_plain(coef48_t, units, grp, o, d, t_min, t_max,
                               passes, any_hit)
    return mxu_kernel(coef48_t, group_aabb, counts, unit_list,
                      torch.stack(list(o)), torch.stack(list(d)),
                      t_min.contiguous(), t_max.contiguous(), grp, passes,
                      incull, any_hit)
