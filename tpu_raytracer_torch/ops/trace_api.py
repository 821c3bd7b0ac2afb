"""Ray-scene queries: closest-hit (`scene_trace`) and occlusion
(`scene_occluded`).

Port of `tpu_raytracer/ops/trace_api.py`. Dispatch is by the scene's
kind, its size against its cap `brute_max` and its trace-kernel mode
(`kernel`, `incull`: `trace_route`) and the rays' device and nothing
else. A flattened scene of more than `brute_max` triangle slots (by
default BRUTE_FORCE_MAX_TRIS) takes the stackless BVH walk over its
`bvh_rec` stream under every mode, both queries (`ops/traversal.py`):
the plain walk `traversal.trace_plain` on a CPU tensor, kernel K8
(`csrc/trace_bvh.cu`) on a CUDA tensor. Under the cap, a flattened scene
under the default mode (`mxuf*`, `mxuv*`):
  - CPU tensor: the plain PyTorch version, `trace_plain` (a chunked
    exact-f32 Moller-Trumbore scan with a running arg-min, the twin of
    the reference's `_trace_brute_xla`);
  - CUDA tensor: kernel K1 (`tpurt_closest_hit`), or K2 (`tpurt_any_hit`)
    for `any_hit=True`, from `csrc/trace.cu`; past MXUF_MAX_TP triangle
    slots, kernel K3 (`ops/trace_stream.py`, `csrc/trace_stream.cu`),
    both queries. K1/K2 and K3 are instances of one sweep
    (`csrc/sweep.cuh`) that takes each 128-ray block's units of chunks
    front to back with an early exit, at unit capacities SWEPT_MAX_UNITS
    and `trace_stream.MAX_UNITS`.
The other modes take K5 (`vpu`: `ops/trace_vpu.py`) or K6 (`mxu3`,
`mxu1`, `mxuw[N]` and the in-kernel cull: `ops/trace_mxu.py`), each a
plain version on a CPU tensor and the kernel on a CUDA tensor. An
instanced scene ignores the mode: `ops/trace_inst.py`, the plain version
on a CPU tensor and kernel K4 on a CUDA tensor. A CUDA tensor never takes
a plain version: the kernel launches or the call raises.

Every path returns the reference's layout, {"t": [R] f32, "tri": [R]
i32}, plus "inst": [R] i32 for an instanced scene: closest-hit gives
(INF, -1) on a miss or a dead lane (t_max <= 0). The sweeps' any-hit
kernels return tri = 1 / -1 and t = t_max, the TPU any-hit kernels'
contract; the walk's any-hit returns its first hit's (t, tri), as the
reference's walk does; `scene_occluded` reads `tri >= 0` either way.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import os
import re
import shutil
import threading

import numpy as np
import torch

from ..runtime.build import CSRC_DIR, load_library
from ..utils.vec3 import V3
from .intersect import INF, moller_trumbore, safe_inv_dir

CT = 128          # triangles per chunk: the kernels' cull granularity
# Past this many triangle slots a flattened scene's queries take the BVH
# walk (K8) instead of a sweep: the reference's cap
# (tpu_raytracer/ops/trace_api.py:45), set from a TPU v5e measurement
# (scripts/ucb_bigscene.py), not from this card. A scene may set its own
# (`SceneBuilder.build(brute_max=)`, the reference's TPU_RT_BRUTE_MAX).
BRUTE_FORCE_MAX_TRIS = 2 * 1024 * 1024
# The reference's caps on its mode chain (tpu_raytracer/ops/pallas_trace.py
# :201-204, 1485-1565), in triangle slots, set by the TPU's VMEM and not
# yet by a measurement on the H100. Past MXUF_MAX_TP a flattened scene's
# default route is K3 (the reference's streamed kernel); past MXUW_MAX_TP
# `mxuw` falls to `mxu3`, and past MXU_MAX_TP `mxu3`/`mxu1` to `vpu`.
MXUF_MAX_TP = 32 * 1024
MXUW_MAX_TP = 48 * 1024
MXU_MAX_TP = 48 * 1024
MXUW_GROUP = 8    # chunks per unit of `mxuw` without a number (GROUP)
# K1/K2's unit capacity (csrc/trace.cu: TPURT_SWEPT_MAX_UNITS): tables of
# up to 32 chunks sweep chunk by chunk, MXUF_MAX_TP's 256 in units of 8
SWEPT_MAX_UNITS = 32
INCULL_MAX_CHUNKS = 64   # the in-kernel cull's scenes (:1486)

# The trace-kernel modes a scene may name (`SceneBuilder.build(kernel=)`,
# the reference's TPU_RT_KERNEL): the default fused modes mxuf[N] and
# mxuv[N], the wide mxuw[N], the one-chunk mxu3 and mxu1, and vpu.
_MODE = re.compile(r"(mxuf|mxuv|mxuw)([1-9][0-9]*)?|mxu[13]|vpu")

# Launches of each kernel, counted where the wrapper launches it (and
# nowhere else), so a run can show which kernels its main path reached.
LAUNCHES = {"closest_hit": 0, "any_hit": 0, "inst_closest_hit": 0,
            "inst_any_hit": 0, "stream_closest_hit": 0, "stream_any_hit": 0,
            "vpu_closest_hit": 0, "mxu_closest_hit": 0, "mxu_any_hit": 0,
            "table_gather": 0, "bvh_closest_hit": 0, "bvh_any_hit": 0,
            "path_prime": 0, "path_bounce": 0, "path_finish": 0, "post": 0,
            "spatial_tap": 0, "spatial_close": 0, "spatial_finish": 0}


# row bands (parallel/tiles.py) launch from one thread each
_LAUNCH_LOCK = threading.Lock()
_THREAD = threading.local()


def count_launch(name: str) -> None:
    """Count one launch of kernel `name` in LAUNCHES, and in the calling
    thread's own counts inside `thread_launches`. Inside
    `captured_launches` the call is recorded into a CUDA graph and
    launches nothing, so it is counted there instead."""
    captured = getattr(_THREAD, "captured", None)
    if captured is not None:
        captured[name] += 1
        return
    add_launches({name: 1})


def add_launches(counts: dict) -> None:
    """Count the launches `counts` (kernel name -> launches) as made now:
    a replayed CUDA graph adds those its capture recorded."""
    with _LAUNCH_LOCK:
        for k, v in counts.items():
            LAUNCHES[k] += v
    own = getattr(_THREAD, "launches", None)
    if own is not None:
        for k, v in counts.items():
            own[k] += v


@contextlib.contextmanager
def captured_launches():
    """While the calling thread captures a CUDA graph: yields a dict with
    LAUNCHES' keys that counts the launches the capture records, which
    LAUNCHES does not count (the graph's replays do, `add_launches`)."""
    _THREAD.captured = dict.fromkeys(LAUNCHES, 0)
    try:
        yield _THREAD.captured
    finally:
        _THREAD.captured = None


@contextlib.contextmanager
def thread_launches():
    """Count the calling thread's launches apart as well: yields a dict
    with LAUNCHES' keys that counts them until the block ends."""
    _THREAD.launches = dict.fromkeys(LAUNCHES, 0)
    try:
        yield _THREAD.launches
    finally:
        _THREAD.launches = None


def reset_launch_counts() -> None:
    with _LAUNCH_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def check_mode(kernel: str) -> str:
    """`kernel` if it names a trace-kernel mode, else ValueError."""
    if not isinstance(kernel, str) or not _MODE.fullmatch(kernel):
        raise ValueError(f"kernel={kernel!r}: want mxuf[N], mxuv[N], "
                         f"mxuw[N], mxu3, mxu1 or vpu")
    return kernel


def trace_route(kernel: str, incull: bool, tp: int, any_hit: bool,
                brute_max: int = BRUTE_FORCE_MAX_TRIS,
                permuted: bool = False):
    """(route, grp, passes) of a flattened scene's query under mode
    `kernel` (with the in-kernel cull if `incull`) at `tp` triangle
    slots, its rays `permuted` or not (`scene_trace(reorder=)`: a
    permuted stream never takes "incull", as the reference takes its cull
    only without a permutation, pallas_trace.py:1485, and falls through
    its chain). Past `brute_max` slots every mode and query takes "bvh", the
    walk (ops/traversal.py, K8), as the reference reaches its mode chain
    only under its cap (trace_api.py:141-150). Under it, the reference's
    mode chain (pallas_trace.py:1485-1565) in its order, less its TPU
    mechanics. Routes:
      "incull" - K6 with the in-kernel group cull, closest- and any-hit,
                 grp 2 (<= 48 chunks) or 4 (#5; mxuf* only);
      "vpu"    - K5 for both queries (any-hit reads `tri >= 0`) (#8);
      "mxu"    - K6 over units of grp chunks, closest-hit only,
                 passes 3 or 1 (#7: mxu3, mxu1; #6: mxuw[N], grp N);
      "swept"  - K1 / K2, the default (#1-#3);
      "stream" - K3 past MXUF_MAX_TP slots (#4);
      "bvh"    - K8, the BVH walk, past `brute_max` slots (traversal.py
                 :trace, an XLA while_loop in the reference).
    An any-hit query of every mode but vpu takes swept or stream, as the
    reference remaps it to its any-hit kernel (:1547-1551)."""
    if tp > brute_max:
        return "bvh", 1, 0
    nc = tp // CT
    if (incull and not permuted and kernel.startswith("mxuf")
            and nc <= INCULL_MAX_CHUNKS and tp <= MXUF_MAX_TP):
        return "incull", 2 if nc <= 48 else 4, 3
    mode = "any" if any_hit and kernel != "vpu" else kernel
    if mode.startswith("mxuw") and tp > MXUW_MAX_TP:
        mode = "mxu3"
    if mode in ("mxu3", "mxu1") and tp > MXU_MAX_TP:
        mode = "vpu"
    if mode == "vpu":
        return "vpu", 1, 0
    if mode.startswith("mxuw"):
        return "mxu", int(mode[4:] or MXUW_GROUP), 3
    if mode in ("mxu3", "mxu1"):
        return "mxu", 1, int(mode[3])
    return ("stream" if tp > MXUF_MAX_TP else "swept"), 1, 0


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

def _slab_window(box, o: V3, inv: V3, t_lo, t_hi):
    """The window (t_lo, t_hi) clipped to the padded slabs of a box [8]
    (min xyz, max xyz) that is not empty, in f32 as the kernels clip it."""
    for k, (o_k, inv_k) in enumerate(zip(o, inv)):
        lo, hi = box[k], box[3 + k]
        pad = np.float32(1e-5) * (abs(lo) + abs(hi)) + np.float32(1e-6)
        a = (float(lo - pad) - o_k) * inv_k
        b = (float(hi + pad) - o_k) * inv_k
        t_lo = torch.maximum(t_lo, torch.minimum(a, b))
        t_hi = torch.minimum(t_hi, torch.maximum(a, b))
    return t_lo, t_hi


def slab_pass(box, o: V3, inv: V3, t_lo, t_hi):
    """Conservative slab test of one AABB [8] (a chunk's, an instance's or
    an object group's) against each ray's window (t_lo, t_hi), as the
    kernels compute it. The box is padded by 1e-5 of its coordinates'
    magnitude (plus 1e-6), far above the rounding of this test and of the
    intersection test, so a box holding a triangle the exact test would
    accept is never culled (flat walls give zero-thickness boxes)."""
    box = np.asarray(box, np.float32)   # f32 scalar math, as in the kernels
    if not box[0] <= box[3]:             # empty box
        return torch.zeros_like(t_lo, dtype=torch.bool)
    t_lo, t_hi = _slab_window(box, o, inv, t_lo, t_hi)
    return t_lo <= t_hi


def mt_argmin(tris, o: V3, d: V3, t_lo, t_hi, best):
    """One Moller-Trumbore step: L rays against the N triangles of `tris`
    ([4, 3, N] planes), each ray's hit kept only inside (t_lo, t_hi) and
    below its running best. o/d hold [L] components; t_lo, t_hi, best
    are [L]. Returns (t_new [L], k [L]): the nearest such hit and its
    lane in `tris`, INF where there is none; an exact-t tie goes to the
    lowest lane (argmin returns the first minimum). Leading batch
    dimensions broadcast: rays [B, L] against tris [4, 3, B, 1, N] give
    [B, L] results.

    The test is `intersect.moller_trumbore`, the terms of the
    reference's `_trace_brute_xla` (trace_api.py:74-85) with the
    multiply-adds that XLA:CPU fuses written as explicit FMAs, so t
    matches the reference's bit for bit, and with it every exact-t tie
    between triangles that meet at an edge. The kernels compute the same
    operations in the same order."""
    hit, t, _, _, _ = moller_trumbore(
        [x[..., None] for x in o], [x[..., None] for x in d], tris[0],
        tris[1], tris[2], t_lo[..., None],
        torch.minimum(t_hi, best)[..., None])
    t_cand = torch.where(hit & (tris[3, 0] > 0.5), t, INF)
    k = torch.argmin(t_cand, dim=-1)
    return t_cand.gather(-1, k[..., None]).squeeze(-1), k


def trace_plain(tri_planes, chunk_aabb, o: V3, d: V3, t_min, t_max):
    """Closest hit over all triangles: a scan over 128-triangle chunks with
    a running arg-min (`mt_argmin`). `t_max <= 0` marks a dead lane.
    Returns {"t": [R] f32 (INF on a miss), "tri": [R] i32}.

    Each chunk is tested only against the rays whose window passes its
    AABB (`slab_pass`), which changes no result. K1 computes the same
    operations in the same order."""
    r = o.x.shape[0]
    device = o.x.device
    nc = tri_planes.shape[2] // CT
    planes = tri_planes.reshape(4, 3, nc, CT)
    boxes = chunk_aabb.cpu().tolist()
    t_best = torch.full((r,), INF, dtype=torch.float32, device=device)
    idx_best = torch.full((r,), -1, dtype=torch.int32, device=device)
    inv = safe_inv_dir(d)
    live = t_max > 0.0
    for c in range(nc):
        sel = live & slab_pass(boxes[c], o, inv, t_min,
                               torch.minimum(t_max, t_best))
        lanes = torch.nonzero(sel).squeeze(1)
        if lanes.numel() == 0:
            continue
        best = t_best[lanes]
        t_new, k = mt_argmin(planes[:, :, c], V3(*(x[lanes] for x in o)),
                             V3(*(x[lanes] for x in d)), t_min[lanes],
                             t_max[lanes], best)
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
KERNEL_SOURCES = ("trace.cu", "trace_stream.cu", "trace_inst.cu",
                  "trace_vpu.cu", "trace_mxu.cu", "gather.cu",
                  "trace_bvh.cu", "marks.cu", "path_trace.cu", "post.cu",
                  "spatial.cu")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(cuda_home, "bin", "nvcc")


@functools.cache
def load_kernels() -> ctypes.CDLL:
    """Build the traversal kernels K1, K2 (`csrc/trace.cu`), K3
    (`csrc/trace_stream.cu`), K4 (`csrc/trace_inst.cu`), K5
    (`csrc/trace_vpu.cu`), K6 (`csrc/trace_mxu.cu`) and K8 (the BVH walk,
    `csrc/trace_bvh.cu`, wrapped by `ops/traversal.py`), the table
    gather K7 (`csrc/gather.cu`, wrapped by `ops/table_gather.py`) and the
    path tracer's shading K9 (`csrc/path_trace.cu`, wrapped by
    `ops/path_trace.py`), the post pass K10 (`csrc/post.cu`, wrapped by
    `ops/post.py`) and ReSTIR's spatial reuse K11 (`csrc/spatial.cu`,
    wrapped by `ops/restir.py`), with
    the frame's stage marks (`csrc/marks.cu`, launched by
    `utils/profiling.py:stage`), into one library with one nvcc call for
    sm_90a (at first use, cached by source hash) and bind them. Once per
    process: every wrapper calls this before each launch, and finding
    nvcc and binding again cost more host time than a small launch takes
    on the card."""
    lib = load_library(
        "trace_kernels", [os.path.join(CSRC_DIR, f) for f in KERNEL_SOURCES],
        [_nvcc(), *NVCC_FLAGS],
        headers=[os.path.join(CSRC_DIR, f)
                 for f in ("mt.cuh", "mma.cuh", "sweep.cuh")])
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.tpurt_closest_hit, lib.tpurt_any_hit,
               lib.tpurt_stream_closest_hit, lib.tpurt_stream_any_hit):
        fn.restype = i32
        fn.argtypes = [ptr] * 6 + [i32] * 2 + [ptr] * 3
    lib.tpurt_vpu_closest_hit.restype = i32
    lib.tpurt_vpu_closest_hit.argtypes = [ptr] * 6 + [i32] * 3 + [ptr] * 3
    for fn in (lib.tpurt_inst_closest_hit, lib.tpurt_inst_any_hit):
        fn.restype = i32
        fn.argtypes = [ptr] * 9 + [i32] * 3 + [ptr] * 4
    lib.tpurt_mxu_closest_hit.restype = i32
    lib.tpurt_mxu_closest_hit.argtypes = [ptr] * 6 + [i32] * 5 + [ptr] * 3
    lib.tpurt_mxu_any_hit.restype = i32
    lib.tpurt_mxu_any_hit.argtypes = [ptr] * 6 + [i32] * 3 + [ptr] * 3
    lib.tpurt_table_gather.restype = i32
    lib.tpurt_table_gather.argtypes = [ptr] * 2 + [i32] * 3 + [ptr] * 2
    for fn in (lib.tpurt_bvh_closest_hit, lib.tpurt_bvh_any_hit):
        fn.restype = i32
        fn.argtypes = [ptr] * 7 + [i32] * 2 + [ptr] * 3
    lib.tpurt_mark.restype = i32
    lib.tpurt_mark.argtypes = [i32, ptr, i32, ptr]
    for fn, args in ((lib.tpurt_path_prime, [ptr] * 2),
                     (lib.tpurt_path_bounce, [ptr, i32, ptr]),
                     (lib.tpurt_path_finish, [ptr] * 2),
                     (lib.tpurt_post, [ptr] * 2),
                     (lib.tpurt_post_occupancy, [ptr]),
                     (lib.tpurt_spatial_tap, [ptr, i32, ptr]),
                     (lib.tpurt_spatial_close, [ptr] * 2),
                     (lib.tpurt_spatial_finish, [ptr] * 2)):
        fn.restype = i32
        fn.argtypes = args
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
    return launch_sweep("", tri_planes, chunk_aabb, o, d, t_min, t_max,
                        any_hit)


def launch_sweep(kind: str, tri_planes, chunk_aabb, o, d, t_min, t_max,
                 any_hit: bool, max_units: int | None = None):
    """Check the inputs of an instance of the sweep of `csrc/sweep.cuh`
    and launch it: `kind` "" is K1/K2 (`tpurt_closest_hit`,
    `tpurt_any_hit`), "stream_" K3 (`tpurt_stream_*`), "vpu_" K5
    (`tpurt_vpu_closest_hit`, closest-hit only, which also takes its unit
    capacity, `max_units`). Counts the launch in LAUNCHES under the
    entry's name."""
    device = o.device
    if device.type != "cuda":
        raise ValueError(f"the {kind}sweep kernels need CUDA tensors, got "
                         f"{device}")
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
    if r >= 2 ** 31 or 12 * tp >= 2 ** 31:
        raise ValueError("rays or triangle slots exceed int32 indexing")
    name = f"{kind}{'any' if any_hit else 'closest'}_hit"
    fn = getattr(load_kernels(), f"tpurt_{name}")
    t_out = torch.empty((r,), dtype=f32, device=device)
    tri_out = torch.empty((r,), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(o.data_ptr(), d.data_ptr(), t_min.data_ptr(),
                 t_max.data_ptr(), tri_planes.data_ptr(),
                 chunk_aabb.data_ptr(), r, tp,
                 *(() if max_units is None else (max_units,)),
                 t_out.data_ptr(), tri_out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    count_launch(name)
    return {"t": t_out, "tri": tri_out}


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def _lanes(x, r, device):
    """Scalar or [R] window bound -> [R] f32 tensor."""
    if isinstance(x, torch.Tensor) and x.dim() == 1:
        return x.to(torch.float32)
    return torch.full((r,), float(x), dtype=torch.float32, device=device)


REORDERS = ("none", "live", "bins")
# the routes whose streams `reorder` permutes: the sweeps of the
# reference's trace_brute_pallas (K1/K2, K3, K5, K6), not the instanced
# kernel K4 nor the walk K8, which the reference leaves in order
PERMUTED_ROUTES = ("swept", "stream", "vpu", "mxu")


def _rows(v) -> V3:
    """A V3 of [R] components, or the rows of a [3, R] tensor as one."""
    return V3(*v.unbind(0)) if isinstance(v, torch.Tensor) else v


def _stacked(v):
    """A [3, R] tensor, or a V3's components stacked into one."""
    return v if isinstance(v, torch.Tensor) else torch.stack(list(v))


def scene_trace(scene, ray_o, ray_d, t_min, t_max, any_hit=False,
                active=None, reorder: str = "none"):
    """Closest-hit (or, with `any_hit`, occlusion) query.

    ray_o/ray_d: V3s of [R] components, or contiguous [3, R] tensors,
    which the kernels read as they are (the path tracer's K9 writes its
    rays so); t_min/t_max: scalars or [R];
    active: optional [R] bool (inactive lanes are dead: t_max = 0).
    reorder: "none" keeps the caller's order; "live" and "bins" permute
    the stream of a route in PERMUTED_ROUTES before the trace and restore
    the results after it (ops/compaction.py), the plain versions' too.
    Every lane's answer is the same in every mode: the routes keep each
    lane's (t, triangle id) minimum, whatever the lanes beside it."""
    if reorder not in REORDERS:
        raise ValueError(f"reorder={reorder!r}: want one of {REORDERS}")
    x = _rows(ray_o).x
    device, r = x.device, x.shape[0]
    t_min = _lanes(t_min, r, device)
    t_max = _lanes(t_max, r, device)
    if active is not None:
        t_max = torch.where(active, t_max, 0.0)
    from . import compaction
    name, grp, passes = ("instanced", 1, 0) if scene.instanced else \
        trace_route(scene.kernel, scene.incull, scene.tri_planes.shape[2],
                    any_hit, scene.brute_max, permuted=reorder != "none")
    if reorder != "none" and name in PERMUTED_ROUTES and r:
        src, dest = compaction.permutation(reorder, ray_d, t_max)
        res = _route(scene, name, grp, passes, any_hit,
                     V3(*(x[src] for x in _rows(ray_o))),
                     V3(*(x[src] for x in _rows(ray_d))), t_min[src],
                     t_max[src])
        return {k: v[dest] for k, v in res.items()}
    return _route(scene, name, grp, passes, any_hit, ray_o, ray_d, t_min,
                  t_max)


def _route(scene, name, grp, passes, any_hit, ray_o, ray_d, t_min, t_max):
    """The query on route `name` (trace_route's, or "instanced") with the
    rays as V3s or [3, R] tensors and the window (t_min, t_max) as [R]
    tensors."""
    # imported here: these modules build on this one
    from . import trace_inst, trace_mxu, trace_vpu, traversal
    device = t_max.device
    if device.type == "cpu":
        ray_o, ray_d = _rows(ray_o), _rows(ray_d)
    if name == "bvh":
        bvh = (scene.bvh_rec, scene.bvh_skip, scene.bvh_tri)
        if device.type == "cpu":
            res = traversal.trace_plain(*bvh, ray_o, ray_d, t_min, t_max,
                                        any_hit=any_hit)
            return {"t": res["t"], "tri": res["tri"]}
        return traversal.trace_bvh_kernel(
            *bvh, _stacked(ray_o), _stacked(ray_d), t_min.contiguous(),
            t_max.contiguous(), any_hit=any_hit)
    if name == "vpu":
        return trace_vpu.trace_vpu(scene.tri_planes, scene.chunk_aabb, ray_o,
                                   ray_d, t_min, t_max)
    if name in ("mxu", "incull"):
        return trace_mxu.trace_mxu(scene.coef48_t, scene.chunk_aabb, ray_o,
                                   ray_d, t_min, t_max, grp, passes,
                                   incull=name == "incull", any_hit=any_hit)
    if device.type == "cpu":
        if scene.instanced:
            return trace_inst.trace_instanced_plain(
                scene.tri_planes, scene.obj_group_aabb, scene.inst_table,
                scene.inst_aabb, scene.unit_inst, scene.unit_group, ray_o,
                ray_d, t_min, t_max)
        return trace_plain(scene.tri_planes, scene.chunk_aabb, ray_o, ray_d,
                           t_min, t_max)
    o, d = _stacked(ray_o), _stacked(ray_d)
    t_min, t_max = t_min.contiguous(), t_max.contiguous()
    if scene.instanced:
        return trace_inst.trace_instanced_kernel(
            scene.tri_planes, scene.obj_group_aabb, scene.inst_table,
            scene.inst_aabb, scene.inst_group_span, o, d, t_min, t_max,
            any_hit=any_hit)
    if name == "stream":
        from .trace_stream import trace_stream_kernel
        return trace_stream_kernel(scene.tri_planes, scene.chunk_aabb, o, d,
                                   t_min, t_max, any_hit=any_hit)
    return trace_kernel(scene.tri_planes, scene.chunk_aabb, o, d, t_min,
                        t_max, any_hit=any_hit)


def scene_occluded(scene, ray_o, ray_d, t_min, t_max, active=None,
                   reorder: str = "none"):
    res = scene_trace(scene, ray_o, ray_d, t_min, t_max, any_hit=True,
                      active=active, reorder=reorder)
    return res["tri"] >= 0
