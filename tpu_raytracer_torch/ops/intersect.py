"""Ray-primitive intersection on torch tensors
(`tpu_raytracer/ops/intersect.py`): Moller-Trumbore ray/triangle, the
slab test of one AABB, and the guarded reciprocal of a direction.

This is the one home of the arithmetic every exact trace shares: the
multiply-adds that XLA:CPU contracts in the reference (`fma`, `cross`,
`dot`), which the plain versions write out and the CUDA kernels compute
with `__fmaf_rn` in the same places (`csrc/mt.cuh:mt_test`). Functions
take (x, y, z) component triples (V3s, or plane rows) that broadcast
against each other.
"""

from __future__ import annotations

import torch

from ..utils.vec3 import V3

INF = 3.0e38
MT_EPS = 1e-9
DIR_EPS = 1e-12   # |d| below this is clamped before the slab test's 1/d


def _round_to_odd(s, p, c, tie):
    """s = p + c rounded to f64, moved one f64 ulp toward the exact sum
    (the two-sum gives its error) where `tie` and s is inexact."""
    pc = s - p
    err = (p - (s - pc)) + (c - pc)             # s + err == p + c exactly
    away = torch.copysign(torch.full_like(s, INF), err)
    return torch.where(tie & (err != 0.0), torch.nextafter(s, away), s)


def fma(a, b, c):
    """a * b + c rounded once to f32, as XLA:CPU's contractions and the
    kernels' `__fmaf_rn` round it. The product is exact in f64, so the f64
    sum s rounds to the fused result, except where s lands exactly on an
    f32 rounding midpoint (its low 29 bits 1 and 28 zeros) while the exact
    sum does not: there s is rounded to odd before it is rounded to f32.
    Results in f32's subnormal range keep the f64 rounding (XLA:CPU
    flushes them to zero)."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    tie = (s.view(torch.int64) & 0x1FFFFFFF) == 0x10000000
    return _round_to_odd(s, p, cd, tie).to(torch.float32)


def cross(ax, ay, az, bx, by, bz):
    """a x b with each component's first product fused, as XLA:CPU
    contracts `a1*b2 - a2*b1` into fma(a1, b2, -(a2*b1))."""
    return (fma(ay, bz, -(az * by)), fma(az, bx, -(ax * bz)),
            fma(ax, by, -(ay * bx)))


def dot(ax, ay, az, bx, by, bz):
    """sum(a * b) as XLA:CPU reduces it: fma(az, bz, fma(ay, by, ax*bx))."""
    return fma(az, bz, fma(ay, by, ax * bx))


def safe_inv_dir(d) -> V3:
    """1/d per component, |d| clamped to DIR_EPS first (slab tests)."""
    return V3(*(1.0 / torch.where(torch.abs(x) < DIR_EPS,
                                  torch.where(x < 0.0, -DIR_EPS, DIR_EPS), x)
                for x in d))


def moller_trumbore(o, d, v0, e1, e2, t_min, t_max):
    """Ray/triangle test, e1 = v1 - v0 and e2 = v2 - v0. Returns (hit, t,
    u, v, front): t is INF where there is no hit inside (t_min, t_max);
    `front` is det > 0, the CCW front face that wgpu's `front_face`
    reports. The terms are the reference's (intersect.py:22-46, and the
    same ones in `_trace_brute_xla`) with XLA:CPU's multiply-adds written
    out, so t, u and v match it bit for bit."""
    dx, dy, dz = d
    px, py, pz = cross(dx, dy, dz, *e2)
    det = dot(*e1, px, py, pz)
    ok = torch.abs(det) > MT_EPS
    inv_det = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    tx, ty, tz = o[0] - v0[0], o[1] - v0[1], o[2] - v0[2]
    u = dot(tx, ty, tz, px, py, pz) * inv_det
    qx, qy, qz = cross(tx, ty, tz, *e1)
    v = dot(dx, dy, dz, qx, qy, qz) * inv_det
    t = dot(*e2, qx, qy, qz) * inv_det
    hit = (ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > t_min)
           & (t < t_max))
    return hit, torch.where(hit, t, INF), u, v, det > 0.0


def aabb_slab(o, inv, box_min, box_max, t_min, t_max):
    """The reference's slab test, unpadded: True where the ray's window
    (t_min, t_max) overlaps the box, `<=` at the edge (intersect.py:
    49-57)."""
    near, far = [], []
    for o_k, inv_k, lo, hi in zip(o, inv, box_min, box_max):
        a = (lo - o_k) * inv_k
        b = (hi - o_k) * inv_k
        near.append(torch.minimum(a, b))
        far.append(torch.maximum(a, b))
    t_entry = torch.maximum(torch.maximum(torch.maximum(near[0], near[1]),
                                          near[2]), t_min)
    t_exit = torch.minimum(torch.minimum(torch.minimum(far[0], far[1]),
                                         far[2]), t_max)
    return t_entry <= t_exit
