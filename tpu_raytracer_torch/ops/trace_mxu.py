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
    `mt_coef48` and the feature rows of `_feat48_from`, and K6's layout
    of `mt_coef48`, `kernel_table` (`table_columns` undoes it);
  - `trace_mxu_plain`, the plain version of kernel K6 over the kernel's
    own (lane, chunk) set, `lane_chunks`: the bf16 products formed exactly
    and summed in f64, rounded once to f32, then the reference's window
    test;
  - `trace_mxu`, which launches K6 (`csrc/trace_mxu.cu`) on CUDA tensors;
    the kernel builds its units itself, with no prepass.
Each lane keeps its (t, triangle id) pairs lexicographically, so an
exact-t tie goes to the lowest id in any sweep order (the port's rule).
Any-hit returns tri = 1 / -1 and t = t_max, K2's contract.
"""

from __future__ import annotations

import torch

from ..utils.vec3 import V3
from . import worklist
from .intersect import INF, MT_EPS, cross, dot, safe_inv_dir
from .trace_api import (BRUTE_FORCE_MAX_TRIS, CT, INCULL_MAX_CHUNKS,
                        MXU_MAX_TP, MXUW_GROUP, _check, _stacked,
                        count_launch, load_kernels, slab_pass, trace_route)

# K6's capacities (csrc/trace_mxu.cu): the routes' largest tables in
# chunks, and the in-kernel cull's in groups of 2
MAX_UNITS = MXU_MAX_TP // CT
MAX_GROUPS = INCULL_MAX_CHUNKS // 2


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
    XLA:CPU does (`intersect.cross`, `dot`). Padding triangles are all
    zero, so det = 0 and they never hit. K6 reads only the narrow layout
    (through `kernel_table`); the wide one is kept as the reference's twin
    for its tests."""
    tp = tri_planes.shape[2]
    nc = tp // CT
    v0, e1, e2 = tri_planes[0], tri_planes[1], tri_planes[2]
    n = cross(*e1, *e2)
    z = torch.zeros_like(v0[0])

    def skew(e):
        # entry 3*i + j: o_i d_j S = det3(o, d, e)
        return [z, e[2], -e[1], -e[2], z, e[0], e[1], -e[0], z]

    c_det = [z] * 9 + list(cross(*e2, *e1)) + [z] * 4
    c_u = skew(e2) + list(cross(*v0, *e2)) + [z] * 4
    c_v = [-s for s in skew(e1)] + [-x for x in cross(*v0, *e1)] + [z] * 4
    c_t = [z] * 12 + list(n) + [-dot(*v0, *n)]
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
    """K6's coefficient table: the hi and lo halves of `mt_coef48` at
    group 1 in mma.sync's A-fragment order, triangles as the product's
    rows: [NC, CT/16, 4, 32, 16] bf16. Entry [c, tt, qd, lane] holds the
    eight 32-bit words thread `lane` = 4 g + q of a warp needs for the
    16-triangle tile tt of chunk c in quantity block qd (det, u, v, t):
    the hi pairs k = 2q, 2q+1 of triangles 16 tt + g and 16 tt + g + 8,
    then their pairs k = 2q+8, 2q+9, then the same lo pairs, the lower k
    in the lower half, so it loads them as two 16-byte words.
    `table_columns` undoes it."""
    coef = mt_coef48(tri_planes)[:32]          # hi rows, lo rows
    nc = coef.shape[1] // (4 * CT)
    # row hl*16 + j*8 + q*2 + half, column c*4CT + qd*CT + tt*16 + hh*8 + g
    x = coef.reshape(2, 2, 4, 2, nc, 4, CT // 16, 2, 8)
    return (x.permute(4, 6, 5, 8, 2, 0, 1, 7, 3)
            .reshape(nc, CT // 16, 4, 32, 16).contiguous())


def table_columns(table: torch.Tensor) -> torch.Tensor:
    """`mt_coef48`'s columns [NC*4*CT, 48] (rows hi, lo, hi) from
    `kernel_table`'s layout, bit for bit."""
    nc = table.shape[0]
    # c, tt, qd, g, q, hl, j, hh, half -> c, qd, tt, hh, g, hl, j, q, half
    x = table.reshape(nc, CT // 16, 4, 8, 4, 2, 2, 2, 2)
    x = x.permute(0, 2, 1, 7, 3, 5, 6, 4, 8).reshape(nc * 4 * CT, 32)
    return torch.cat([x, x[:, :16]], dim=1)


def mode_table(tri_planes: torch.Tensor, kernel: str, incull: bool,
               instanced: bool = False,
               brute_max: int = BRUTE_FORCE_MAX_TRIS):
    """`kernel_table` of a flattened scene whose mode routes its
    closest-hit queries to K6 (its any-hit queries go there only with
    them), else None: past `brute_max` slots every query walks the BVH,
    so no mode builds it."""
    route = trace_route(kernel, incull, tri_planes.shape[2], False,
                        brute_max)[0]
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


def trace_mxu_plain(table, chunks, o: V3, d: V3, t_min, t_max,
                    passes: int = 3, any_hit: bool = False):
    """K6's plain version. table: `kernel_table`; chunks [R, NC] bool:
    lane r tests chunk c when chunks[r, c] (`lane_chunks`, the kernel's
    own set). Per tested chunk the products are phi's bf16 split against
    the table's, `passes` = 3 (hi*hi + hi*lo + lo*hi) or 1 (hi*hi), each
    exact in f64 and summed there, rounded once to f32; the sum's order
    then does not matter. Returns {"t", "tri"}."""
    r = t_min.shape[0]
    cols = table_columns(table)
    k = 48 if passes == 3 else 16
    f48 = feat48(o, d).T[:, :k].double()                     # [R, k]
    cols = cols[:, :k].double()
    t_best = torch.full((r,), INF, dtype=torch.float32, device=t_min.device)
    idx_best = torch.full((r,), -1, dtype=torch.int32, device=t_min.device)
    hit_any = torch.zeros((r,), dtype=torch.bool, device=t_min.device)
    for c in range(chunks.shape[1]):
        lanes = torch.nonzero(chunks[:, c]).squeeze(1)
        if lanes.numel() == 0:
            continue
        lo, hi = t_min[lanes, None], t_max[lanes, None]
        chunk = cols[c * 4 * CT:(c + 1) * 4 * CT]             # [4*CT, k]
        prod = (f48[lanes] @ chunk.T).float()
        hit, t_val = window_test(prod, lo, hi, any_hit)
        if any_hit:
            hit_any[lanes] |= hit.any(dim=1)
            continue
        t_cand = torch.where(hit, t_val, INF)
        t_new, j = t_cand.min(dim=1)                          # first minimum
        ids = (j + c * CT).to(torch.int32)
        tb, ib = t_best[lanes], idx_best[lanes]
        better = (t_new < tb) | ((t_new == tb) & (t_new < INF) & (ids < ib))
        t_best[lanes] = torch.where(better, t_new, tb)
        idx_best[lanes] = torch.where(better, ids, ib)
    if any_hit:
        return {"t": t_max.clone(),
                "tri": torch.where(hit_any, 1, -1).to(torch.int32)}
    return {"t": torch.where(idx_best < 0, INF, t_best), "tri": idx_best}


def lane_chunks(chunk_aabb, grp: int, incull: bool, o: V3, d: V3, t_min,
                t_max) -> torch.Tensor:
    """[R, NC] bool: the chunks K6 tests for each lane. A live lane (t_max
    > 0) tests chunk c when its window (t_min, t_max) passes c's padded
    box (`slab_pass`; mxu3, mxu1, mxuw[N]: grp only groups the kernel's
    box tests), or with `incull` the padded union box of c's group of grp
    chunks (the in-kernel guard of #5, `slab_any`, :727-743, made
    conservative as K1's cull is)."""
    inv = safe_inv_dir(d)
    nc = chunk_aabb.shape[0]
    if incull:
        boxes = worklist.group_boxes(chunk_aabb, grp).cpu().tolist()
        groups = torch.stack([slab_pass(box, o, inv, t_min, t_max)
                              for box in boxes], dim=1)
        chunks = groups.repeat_interleave(grp, dim=1)[:, :nc]
    else:
        chunks = torch.stack([slab_pass(box, o, inv, t_min, t_max)
                              for box in chunk_aabb.cpu().tolist()], dim=1)
    return chunks & (t_max > 0.0)[:, None]


# ---------------------------------------------------------------------------
# K6 (CUDA tensors) and the mode's entry point
# ---------------------------------------------------------------------------

def mxu_kernel(table, chunk_aabb, o, d, t_min, t_max, grp, passes,
               incull, any_hit):
    """Launch K6 on CUDA tensors: o, d [3, R] f32; t_min, t_max [R] f32
    (t_max <= 0: dead lane); table from `kernel_table`; chunk_aabb [NC, 8]
    f32; all contiguous on one CUDA device. The kernel builds its units
    itself (`lane_chunks`). Raises on anything else, and on a variant no
    route takes."""
    device = o.device
    if device.type != "cuda":
        raise ValueError(f"mxu_kernel needs CUDA tensors, got {device}")
    r = o.shape[1]
    f32 = torch.float32
    nc = table.shape[0]
    _check(o, "o", (3, r), f32, device)
    _check(d, "d", (3, r), f32, device)
    _check(t_min, "t_min", (r,), f32, device)
    _check(t_max, "t_max", (r,), f32, device)
    _check(table, "table", (nc, CT // 16, 4, 32, 16), torch.bfloat16,
           device)
    _check(chunk_aabb, "chunk_aabb", (nc, 8), f32, device)
    if passes not in (1, 3) or (incull and passes != 3) \
            or (any_hit and not incull):
        raise ValueError(f"K6 has no variant passes={passes}, "
                         f"incull={incull}, any_hit={any_hit}")
    if grp < 1 or not 1 <= (-(-nc // grp) if incull else nc) <= (
            MAX_GROUPS if incull else MAX_UNITS):
        raise ValueError(f"K6 takes up to {MAX_UNITS} chunks, or "
                         f"{MAX_GROUPS} groups with the cull, not {nc} "
                         f"chunks in groups of {grp}")
    if r >= 2 ** 31:
        raise ValueError("rays exceed int32 indexing")
    lib = load_kernels()
    t_out = torch.empty((r,), dtype=f32, device=device)
    tri_out = torch.empty((r,), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        args = (o.data_ptr(), d.data_ptr(), t_min.data_ptr(),
                t_max.data_ptr(), table.data_ptr(), chunk_aabb.data_ptr(), r,
                nc, grp)
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
    count_launch("mxu_any_hit" if any_hit else "mxu_closest_hit")
    return {"t": t_out, "tri": tri_out}


def trace_mxu(table, chunk_aabb, o, d, t_min, t_max, grp: int,
              passes: int = 3, incull: bool = False, any_hit: bool = False):
    """One query of a K6 route: the plain version over `lane_chunks` on
    CPU tensors, K6 on CUDA tensors (it launches or raises). A lane tests
    the chunks whose boxes its window passes (`mxu3`, `mxu1`, `mxuw[N]`),
    or with `incull` the chunks of the groups of grp whose union box it
    passes. Any-hit is served only by the in-kernel cull, as in the
    reference's routes. o, d: V3s, or [3, R] tensors on a CUDA device."""
    if table is None:
        raise ValueError("the scene carries no coefficient table for K6: "
                         "build it under a mode whose route takes K6")
    if t_max.device.type == "cpu":
        chunks = lane_chunks(chunk_aabb, grp, incull, o, d, t_min, t_max)
        return trace_mxu_plain(table, chunks, o, d, t_min, t_max, passes,
                               any_hit)
    return mxu_kernel(table, chunk_aabb, _stacked(o), _stacked(d),
                      t_min.contiguous(), t_max.contiguous(), grp, passes,
                      incull, any_hit)
