"""Linear BVH on the device: Morton codes, a stable sort, Karras's
hierarchy and a bottom-up box pass (`tpu_raytracer/ops/lbvh.py`).

`morton_reorder` re-sorts a flattened scene's triangle stream by the
Morton code of each triangle's box centre and recomputes the chunk
boxes: the retopology that keeps chunk culling tight after large motion
(`ops/refit.py:update_instances(repack=True)`). `build_lbvh` builds
Karras's tree (2012) over triangle boxes.

torch has no uint32 `*`, `>>` or `|` on the CPU, so codes are int64
holding 30-bit values; every product stays below 2^42 and every mask is
below 2^32, which is the uint32 arithmetic of the reference. Sorts are
stable, as `jnp.argsort` is: codes tie often at 10 bits an axis, and the
tie order fixes triangle ids and with them exact-t winners.
"""

from __future__ import annotations

import dataclasses

import torch

from .intersect import INF
from .trace_api import CT
from .trace_mxu import mode_table


def _expand_bits(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of v to every third bit."""
    v = v.to(torch.int64)
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton_codes(centroids, scene_min, scene_max) -> torch.Tensor:
    """30-bit Morton codes (int64) of [T, 3] centroids within the bounds."""
    q = (centroids - scene_min) / torch.clamp(scene_max - scene_min,
                                              min=1e-12)
    q = torch.clamp(q * 1024.0, 0.0, 1023.0).to(torch.int64)
    return ((_expand_bits(q[:, 0]) << 2) | (_expand_bits(q[:, 1]) << 1)
            | _expand_bits(q[:, 2]))


def _clz32(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of 32-bit values held in int64 (5 shift steps)."""
    msb = torch.zeros_like(x)
    cur = x
    for sh in (16, 8, 4, 2, 1):
        y = cur >> sh
        take = y != 0
        cur = torch.where(take, y, cur)
        msb = msb + torch.where(take, sh, 0)
    return torch.where(x == 0, 32, 31 - msb)


def _delta(codes, i, j, t: int) -> torch.Tensor:
    """Common-prefix length of sorted keys i and j, -1 outside [0, t);
    equal codes continue the prefix into the index bits (Karras's tie
    break for duplicate codes)."""
    valid = (j >= 0) & (j < t)
    j_c = torch.clamp(j, 0, t - 1)
    x = codes[i] ^ codes[j_c]
    lz = torch.where(x != 0, _clz32(x), 32 + _clz32(i ^ j_c))
    return torch.where(valid, lz, -1)


def build_lbvh(aabb_min: torch.Tensor, aabb_max: torch.Tensor) -> dict:
    """Karras LBVH over [T, 3] triangle boxes, on their device.

    Returns order [T] (triangle ids in Morton order, the leaf order),
    left / right [T-1] (a child id < T-1 is an internal node, one >= T-1
    the leaf at sorted position id - (T-1)), and node_min / node_max
    [2T-1, 3] (internal nodes first, then leaves)."""
    t = aabb_min.shape[0]
    dev = aabb_min.device
    smin = aabb_min.amin(dim=0)
    smax = aabb_max.amax(dim=0)
    codes = morton_codes((aabb_min + aabb_max) * 0.5, smin, smax)
    order = torch.argsort(codes, stable=True)
    codes = codes[order]

    n_int = t - 1
    i = torch.arange(n_int, dtype=torch.int64, device=dev)

    def delta(j):
        return _delta(codes, i, j, t)

    # direction and an upper bound of the range by doubling
    d = torch.sign(delta(i + 1) - delta(i - 1))
    d = torch.where(d == 0, 1, d)
    delta_min = delta(i - d)
    lmax = torch.full((n_int,), 2, dtype=torch.int64, device=dev)
    for _ in range(31):
        lmax = torch.where(delta(i + lmax * d) > delta_min, lmax * 2, lmax)

    # binary search of the range's other end
    length = torch.zeros_like(i)
    step = lmax
    for _ in range(32):
        step = torch.clamp(step // 2, min=0)
        ok = (step > 0) & (delta(i + (length + step) * d) > delta_min)
        length = torch.where(ok, length + step, length)
    j_end = i + length * d

    # split: binary search of the highest differing bit
    delta_node = delta(j_end)
    s = torch.zeros_like(i)
    denom = torch.full_like(i, 2)
    for _ in range(32):
        tstep = (length + denom - 1) // denom
        ok = (tstep >= 1) & (delta(i + (s + tstep) * d) > delta_node)
        s = torch.where(ok, s + tstep, s)
        denom = denom * 2
    gamma = i + s * d + torch.clamp(d, max=0)

    lo = torch.minimum(i, j_end)
    hi = torch.maximum(i, j_end)
    # a child covering one sorted position is a leaf
    left = torch.where(lo == gamma, gamma + n_int, gamma)
    right = torch.where(hi == gamma + 1, gamma + 1 + n_int, gamma + 1)

    # bottom-up boxes: sweep until every internal node is complete (at
    # most the tree's depth sweeps)
    node_min = torch.cat([aabb_min.new_full((n_int, 3), INF),
                          aabb_min[order]])
    node_max = torch.cat([aabb_max.new_full((n_int, 3), -INF),
                          aabb_max[order]])
    while n_int > 0:
        new_min = torch.minimum(node_min[left], node_min[right])
        new_max = torch.maximum(node_max[left], node_max[right])
        # a node is ready when both subtrees are complete
        ready = ((node_min[left] < 1.0e38).all(dim=1)
                 & (node_min[right] < 1.0e38).all(dim=1))
        node_min[:n_int] = torch.where(ready[:, None], new_min,
                                       node_min[:n_int])
        node_max[:n_int] = torch.where(ready[:, None], new_max,
                                       node_max[:n_int])
        if bool(ready.all()):
            break
    i32 = torch.int32
    return {"order": order.to(i32), "left": left.to(i32),
            "right": right.to(i32), "node_min": node_min,
            "node_max": node_max}


def chunk_boxes(chunk_aabb, mn, mx, tp: int) -> torch.Tensor:
    """chunk_aabb with columns 0:6 the per-CT-chunk min / max of the
    [T, 3] triangle boxes (mn, mx), padded to tp rows with empty boxes."""
    pad = tp - mn.shape[0]
    mn = torch.cat([mn, mn.new_full((pad, 3), INF)])
    mx = torch.cat([mx, mx.new_full((pad, 3), -INF)])
    out = chunk_aabb.clone()
    out[:, 0:3] = mn.reshape(-1, CT, 3).amin(dim=1)
    out[:, 3:6] = mx.reshape(-1, CT, 3).amax(dim=1)
    return out


def _tri_boxes(tri_planes, t: int):
    """(v0, e1, e2, box min, box max) [T, 3] of the first t triangles."""
    v0, e1, e2 = (tri_planes[k, :, :t].T for k in range(3))
    v1, v2 = v0 + e1, v0 + e2
    return (v0, e1, e2, torch.minimum(torch.minimum(v0, v1), v2),
            torch.maximum(torch.maximum(v0, v1), v2))


def morton_order(scene) -> torch.Tensor:
    """The stable Morton order [T] (int64) of a flattened scene's
    triangles, by box centre within the scene's bounds."""
    _, _, _, mn, mx = _tri_boxes(scene.tri_planes, scene.tri_inst.shape[0])
    return torch.argsort(morton_codes((mn + mx) * 0.5, mn.amin(dim=0),
                                      mx.amax(dim=0)), stable=True)


def morton_reorder(scene):
    """A flattened scene with its triangles re-sorted by `morton_order`:
    planes, chunk boxes, shading rows and per-triangle fields follow the
    order, as do the BVH's triangle ids (bvh_tri) and the refit's rows
    (bvh_tri_rows); K6's table is rebuilt where the scene has one."""
    t = scene.tri_inst.shape[0]
    order = morton_order(scene)
    v0, e1, e2, mn, mx = _tri_boxes(scene.tri_planes, t)
    planes = scene.tri_planes.clone()
    planes[0, :, :t] = v0[order].T
    planes[1, :, :t] = e1[order].T
    planes[2, :, :t] = e2[order].T

    inv = torch.argsort(order).to(torch.int32)
    bvh_tri = torch.where(scene.bvh_skip < 0,
                          inv[torch.clamp(scene.bvh_tri, min=0).long()],
                          scene.bvh_tri)
    return dataclasses.replace(
        scene,
        tri_planes=planes,
        chunk_aabb=chunk_boxes(scene.chunk_aabb, mn[order], mx[order],
                                planes.shape[2]),
        coef48_t=(None if scene.coef48_t is None else mode_table(
            planes, scene.kernel, scene.incull, brute_max=scene.brute_max)),
        tri_table=scene.tri_table[order],
        tri_table_local=scene.tri_table_local[order],
        tri_inst=scene.tri_inst[order],
        tri_prim=scene.tri_prim[order],
        tri_local=scene.tri_local[order],
        bvh_tri=bvh_tri,
        bvh_tri_rows=scene.bvh_tri_rows[order],
    )
