"""BVH construction: binned-SAH over triangle AABBs, flattened to a
unified depth-first record stream (see `tpu_raytracer/ops/bvh.py` for the
stream format).

The scene builder reorders every triangle into this tree's DFS leaf
order, which sets the 128-triangle chunk layout and every triangle id.
The JAX package builds the tree with its native C++ builder; the port
builds the same source (`csrc/host/bvh_builder.cpp`, a verbatim copy)
with the same g++ flags, so both produce the same tree.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os

import numpy as np

from ..runtime.build import CSRC_DIR, load_library

LEAF_SIZE = 4
NUM_BINS = 16
REC_WIDTH = 12


@dataclasses.dataclass
class BVH:
    rec: np.ndarray        # [S, 12] f32: box min|max, or tri v0|e1|e2
    skip: np.ndarray       # [S] i32: box -> miss target; tri -> -1
    tri_id: np.ndarray     # [S] i32: tri -> triangle index; box -> -1
    box_left: np.ndarray   # [S] i32 left child box (-1 if none)
    box_right: np.ndarray  # [S] i32 right child box
    depth: np.ndarray      # [S] i32 depth of each box record (-1 for tris)
    max_depth: int


def _native():
    lib = load_library(
        "bvh_builder", [os.path.join(CSRC_DIR, "host", "bvh_builder.cpp")],
        ["g++", "-O3", "-shared", "-fPIC", "-std=c++17"], timeout=120)
    fn = lib.tpurt_build_bvh
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 7 + [
                       ctypes.c_int]
    return fn


def build_bvh(aabb_min: np.ndarray, aabb_max: np.ndarray,
              leaf_size: int = LEAF_SIZE, num_bins: int = NUM_BINS) -> BVH:
    """Build over per-triangle AABBs [T, 3]. Triangle records come back
    zero-filled; `fill_triangles` populates them."""
    fn = _native()
    t = aabb_min.shape[0]
    cap = 3 * max(t, 1) + 8
    mn = np.ascontiguousarray(aabb_min, np.float32)
    mx = np.ascontiguousarray(aabb_max, np.float32)
    rec = np.zeros((cap, REC_WIDTH), np.float32)
    ints = np.zeros((5, cap), np.int32)   # skip, tri, left, right, depth
    out_depth = np.zeros((1,), np.int32)
    s = fn(mn.ctypes.data, mx.ctypes.data, t, leaf_size, num_bins,
           rec.ctypes.data, *(ints[k].ctypes.data for k in range(5)),
           out_depth.ctypes.data, cap)
    if s < 0:
        raise RuntimeError("BVH record stream overflowed its capacity")
    if s == 0:  # empty scene: one degenerate box that always misses
        s = 1
        ints[:, 0] = (1, -1, -1, -1, -1)
    skip, tri, left, right, depth = (ints[k, :s].copy() for k in range(5))
    return BVH(rec=rec[:s].copy(), skip=skip, tri_id=tri, box_left=left,
               box_right=right, depth=depth, max_depth=int(out_depth[0]))


def fill_triangles(bvh: BVH, v0: np.ndarray, e1: np.ndarray,
                   e2: np.ndarray) -> None:
    """Populate triangle records from triangle-indexed arrays."""
    is_tri = bvh.skip < 0
    ids = bvh.tri_id[is_tri]
    bvh.rec[is_tri, 0:3] = v0[ids]
    bvh.rec[is_tri, 3:6] = e1[ids]
    bvh.rec[is_tri, 6:9] = e2[ids]
