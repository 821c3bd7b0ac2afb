"""Ray-scene queries: closest-hit (`scene_trace`) and occlusion
(`scene_occluded`) over a flattened scene's triangle planes.

Port of `tpu_raytracer/ops/trace_api.py`. Dispatch is by the rays'
device and nothing else:
  - CPU tensor: the plain PyTorch version, `trace_plain` (a chunked
    exact-f32 Moller-Trumbore scan with a running arg-min, the twin of
    the reference's `_trace_brute_xla`);
  - CUDA tensor: kernel K1 (`tpurt_closest_hit`), or K2 (`tpurt_any_hit`)
    for `any_hit=True`, from `csrc/trace.cu`. A CUDA tensor never takes
    the plain version: the kernel launches or the call raises.

Both paths return the reference's layout, {"t": [R] f32, "tri": [R] i32}:
closest-hit gives (INF, -1) on a miss or a dead lane (t_max <= 0). K2
returns tri = 1 / -1 and t = t_max, the TPU any-hit kernel's contract;
`scene_occluded` reads `tri >= 0` either way.
"""

from __future__ import annotations

import ctypes
import os
import shutil

import numpy as np
import torch

from ..runtime.build import CSRC_DIR, load_library
from ..utils.vec3 import V3

INF = 3.0e38
CT = 128          # triangles per chunk: the kernels' cull granularity
MT_EPS = 1e-9
DIR_EPS = 1e-12   # |d| below this is clamped before the slab test's 1/d

# Launches of each kernel, counted where the wrapper launches it (and
# nowhere else), so a run can show which kernels its main path reached.
LAUNCHES = {"closest_hit": 0, "any_hit": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def pack_triangles(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray):
    """Host-side packing to the kernel layout
    (`tpu_raytracer/ops/pallas_trace.py:pack_triangles`).

    Returns (tri_planes [4, 3, Tp], chunk_aabb [Tp/CT, 8]); plane 3 row 0
    is the validity mask (1.0 real, 0.0 padding)."""
    t = v0.shape[0]
    tp = max(((t + CT - 1) // CT) * CT, CT)
    planes = np.zeros((4, 3, tp), np.float32)
    planes[0, :, :t] = v0.T
    planes[1, :, :t] = e1.T
    planes[2, :, :t] = e2.T
    planes[3, 0, :t] = 1.0

    nc = tp // CT
    aabb = np.zeros((nc, 8), np.float32)
    v1 = v0 + e1
    v2 = v0 + e2
    mn = np.minimum(np.minimum(v0, v1), v2)
    mx = np.maximum(np.maximum(v0, v1), v2)
    for c in range(nc):
        lo = c * CT
        hi = min((c + 1) * CT, t)
        if lo < hi:
            aabb[c, 0:3] = mn[lo:hi].min(axis=0)
            aabb[c, 3:6] = mx[lo:hi].max(axis=0)
        else:
            aabb[c, 0:3] = INF
            aabb[c, 3:6] = -INF
    return planes, aabb


# ---------------------------------------------------------------------------
# Plain PyTorch version (CPU tensors; also the on-card comparison baseline)
# ---------------------------------------------------------------------------

def fma(a, b, c):
    """a * b + c rounded once to f32. The product is exact in f64, so the
    f64 sum rounds to the fused result except when it lands exactly on an
    f32 rounding midpoint (about 1 in 2^29)."""
    return (a.double() * b.double() + c.double()).to(torch.float32)


def _cross(ax, ay, az, bx, by, bz):
    """a x b with each component's first product fused, as XLA:CPU
    contracts `a1*b2 - a2*b1` into fma(a1, b2, -(a2*b1))."""
    return (fma(ay, bz, -(az * by)), fma(az, bx, -(ax * bz)),
            fma(ax, by, -(ay * bx)))


def _dot(ax, ay, az, bx, by, bz):
    """sum(a * b) as XLA:CPU reduces it: fma(az, bz, fma(ay, by, ax*bx))."""
    return fma(az, bz, fma(ay, by, ax * bx))


def slab_pass(box, o: V3, inv: V3, t_lo, t_hi):
    """Conservative slab test of one chunk AABB [8] against each ray's
    window (t_lo, t_hi), as K1 and K2 compute it. The box is padded by
    1e-5 of its coordinates' magnitude (plus 1e-6), far above the rounding
    of this test and of the intersection test, so a chunk holding a
    triangle the exact test would accept is never culled (flat walls give
    zero-thickness boxes)."""
    box = np.asarray(box, np.float32)   # f32 scalar math, as in the kernels
    if not box[0] <= box[3]:             # empty chunk
        return torch.zeros_like(t_lo, dtype=torch.bool)
    for k, (o_k, inv_k) in enumerate(zip(o, inv)):
        lo, hi = box[k], box[3 + k]
        pad = np.float32(1e-5) * (abs(lo) + abs(hi)) + np.float32(1e-6)
        a = (float(lo - pad) - o_k) * inv_k
        b = (float(hi + pad) - o_k) * inv_k
        t_lo = torch.maximum(t_lo, torch.minimum(a, b))
        t_hi = torch.minimum(t_hi, torch.maximum(a, b))
    return t_lo <= t_hi


def trace_plain(tri_planes, chunk_aabb, o: V3, d: V3, t_min, t_max):
    """Closest hit over all triangles: a scan over 128-triangle chunks with
    a running arg-min. `t_max <= 0` marks a dead lane. Returns
    {"t": [R] f32 (INF on a miss), "tri": [R] i32}.

    The Moller-Trumbore terms are those of the reference's
    `_trace_brute_xla` (trace_api.py:74-85) with the multiply-adds that
    XLA:CPU fuses written as explicit FMAs (`_cross`, `_dot`), so the port
    reproduces the reference's t bit for bit and with it every exact-t
    tie between triangles that meet at an edge. Each chunk is tested only
    against the rays whose window passes its AABB (`slab_pass`), which
    changes no result. K1 computes the same operations in the same
    order."""
    r = o.x.shape[0]
    device = o.x.device
    nc = tri_planes.shape[2] // CT
    planes = tri_planes.reshape(4, 3, nc, CT)
    boxes = chunk_aabb.cpu().tolist()
    t_best = torch.full((r,), INF, dtype=torch.float32, device=device)
    idx_best = torch.full((r,), -1, dtype=torch.int32, device=device)
    inv = V3(*(1.0 / torch.where(torch.abs(x) < DIR_EPS,
                                 torch.where(x < 0.0, -DIR_EPS, DIR_EPS), x)
               for x in d))
    live = t_max > 0.0
    for c in range(nc):
        sel = live & slab_pass(boxes[c], o, inv, t_min,
                               torch.minimum(t_max, t_best))
        lanes = torch.nonzero(sel).squeeze(1)
        if lanes.numel() == 0:
            continue
        ox, oy, oz = (x[lanes, None] for x in o)
        dx, dy, dz = (x[lanes, None] for x in d)
        t_lo, t_hi = t_min[lanes, None], t_max[lanes, None]
        best = t_best[lanes]
        v0x, v0y, v0z = planes[0, :, c]
        e1x, e1y, e1z = planes[1, :, c]
        e2x, e2y, e2z = planes[2, :, c]
        valid = planes[3, 0, c] > 0.5
        px, py, pz = _cross(dx, dy, dz, e2x, e2y, e2z)
        det = _dot(e1x, e1y, e1z, px, py, pz)
        ok = torch.abs(det) > MT_EPS
        inv_det = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
        tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
        u = _dot(tx, ty, tz, px, py, pz) * inv_det
        qx, qy, qz = _cross(tx, ty, tz, e1x, e1y, e1z)
        v = _dot(dx, dy, dz, qx, qy, qz) * inv_det
        t = _dot(e2x, e2y, e2z, qx, qy, qz) * inv_det
        hit = (ok & valid & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
               & (t > t_lo) & (t < t_hi) & (t < best[:, None]))
        t_cand = torch.where(hit, t, INF)
        # argmin returns the first minimum: ties go to the lowest id
        k = torch.argmin(t_cand, dim=1)
        t_new = t_cand.gather(1, k[:, None]).squeeze(1)
        improved = t_new < best
        t_best[lanes] = torch.where(improved, t_new, best)
        idx_best[lanes] = torch.where(improved, (k + c * CT).to(torch.int32),
                                      idx_best[lanes])
    return {"t": torch.where(idx_best < 0, INF, t_best), "tri": idx_best}


# ---------------------------------------------------------------------------
# K1 / K2 (CUDA tensors)
# ---------------------------------------------------------------------------

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-fmad=false", "-Xptxas", "-v"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(cuda_home, "bin", "nvcc")


def load_kernels() -> ctypes.CDLL:
    """Build `csrc/trace.cu` with nvcc for sm_90a (at first use, cached by
    source hash) and bind K1 and K2."""
    lib = load_library("trace_kernels", [os.path.join(CSRC_DIR, "trace.cu")],
                       [_nvcc(), *NVCC_FLAGS])
    for fn in (lib.tpurt_closest_hit, lib.tpurt_any_hit):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [
            ctypes.c_void_p] * 3
    return lib


def _check(x: torch.Tensor, name: str, shape, dtype, device) -> None:
    if x.device != device or x.dtype != dtype or tuple(x.shape) != shape \
            or not x.is_contiguous():
        raise ValueError(
            f"{name}: want contiguous {dtype} {shape} on {device}, got "
            f"{'contiguous' if x.is_contiguous() else 'strided'} "
            f"{x.dtype} {tuple(x.shape)} on {x.device}")


def trace_kernel(tri_planes, chunk_aabb, o, d, t_min, t_max,
                 any_hit: bool = False):
    """Launch K1 (closest-hit) or K2 (any-hit) on CUDA tensors.

    o, d: [3, R] f32; t_min, t_max: [R] f32 (t_max <= 0: dead lane);
    tri_planes [4, 3, Tp] and chunk_aabb [Tp/128, 8] f32, all contiguous
    on one CUDA device. Raises on anything else."""
    device = o.device
    if device.type != "cuda":
        raise ValueError(f"trace_kernel needs CUDA tensors, got {device}")
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
    if r >= 2 ** 31:
        raise ValueError(f"{r} rays exceed the kernels' int32 indexing")
    lib = load_kernels()
    t_out = torch.empty((r,), dtype=f32, device=device)
    tri_out = torch.empty((r,), dtype=torch.int32, device=device)
    fn = lib.tpurt_any_hit if any_hit else lib.tpurt_closest_hit
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(o.data_ptr(), d.data_ptr(), t_min.data_ptr(),
                 t_max.data_ptr(), tri_planes.data_ptr(),
                 chunk_aabb.data_ptr(), r, tp, t_out.data_ptr(),
                 tri_out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{'any' if any_hit else 'closest'}-hit kernel "
                           f"launch failed: CUDA error {err}")
    LAUNCHES["any_hit" if any_hit else "closest_hit"] += 1
    return {"t": t_out, "tri": tri_out}


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def _lanes(x, r, device):
    """Scalar or [R] window bound -> [R] f32 tensor."""
    if isinstance(x, torch.Tensor) and x.dim() == 1:
        return x.to(torch.float32)
    return torch.full((r,), float(x), dtype=torch.float32, device=device)


def scene_trace(scene, ray_o: V3, ray_d: V3, t_min, t_max, any_hit=False,
                active=None):
    """Closest-hit (or, with `any_hit`, occlusion) query.

    ray_o/ray_d: V3s of [R] components; t_min/t_max: scalars or [R];
    active: optional [R] bool (inactive lanes are dead: t_max = 0)."""
    device = ray_o.x.device
    r = ray_o.x.shape[0]
    t_min = _lanes(t_min, r, device)
    t_max = _lanes(t_max, r, device)
    if active is not None:
        t_max = torch.where(active, t_max, 0.0)
    if device.type == "cpu":
        return trace_plain(scene.tri_planes, scene.chunk_aabb, ray_o, ray_d,
                           t_min, t_max)
    o = torch.stack([ray_o.x, ray_o.y, ray_o.z])
    d = torch.stack([ray_d.x, ray_d.y, ray_d.z])
    return trace_kernel(scene.tri_planes, scene.chunk_aabb, o, d,
                        t_min.contiguous(), t_max.contiguous(),
                        any_hit=any_hit)


def scene_occluded(scene, ray_o: V3, ray_d: V3, t_min, t_max, active=None):
    res = scene_trace(scene, ray_o, ray_d, t_min, t_max, any_hit=True,
                      active=active)
    return res["tri"] >= 0
