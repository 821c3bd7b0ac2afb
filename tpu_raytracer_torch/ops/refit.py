"""Scene refit: instances moved to new transforms, every derived table
rebuilt on the scene's device (`tpu_raytracer/ops/refit.py`).

The reference app rebuilds its TLAS to move instances (builder.rs:454-468).
Here a refit retransforms the object-space copy of the scene:

  * world triangles -> the trace planes (tri_planes) and chunk boxes,
  * the world shading rows (tri_table) from the object-space copy
    (tri_table_local) through each instance's normal matrix,
  * the instance transform and normal-matrix tables,
  * the BVH's triangle records, and its box records bottom up, one
    masked sweep a level,
  * K6's coefficient table, where the scene has one.

Topology stays (the same BVH, refit only). Every step is tensor code on
the scene's device with no read back to the host, so `update_instances`
can run every frame: the only host work is resolving a `changed` set's
triangle indices, once per (scene, changed) pair.

`update_instances` returns a new scene, as the reference's jitted refit
does; `update_instances_` writes the same result into the scene's own
tensors, so a CUDA graph that reads the scene at its captured addresses
sees the refit (render/graph.py).
"""

from __future__ import annotations

import dataclasses
import weakref

import numpy as np
import torch

from .bvh import LEAF_SIZE
from .lbvh import chunk_boxes, morton_reorder
from .intersect import INF, fma
from .trace_mxu import mode_table


def _matmul(a, v):
    """[N, 3, 3] @ [N, 3, K] -> [N, 3, K], each sum as XLA:CPU reduces the
    reference's einsums: fma(a2, v2, fma(a1, v1, a0 * v0)). The same
    rounding on every device, and the reference's bit for bit."""
    def col(j):
        return a[:, :, j:j + 1], v[:, j:j + 1, :]
    return fma(*col(2), fma(*col(1), torch.mul(*col(0))))


def _affine(transforms):
    """[I, 3, 4] or [I, 4, 4] -> (A [I, 3, 3], t [I, 3], inv(A)^T [I, 3,
    3], det(A) [I]).

    inv(A)^T in closed form: its rows are the cross products of A's rows
    over det(A). Elementwise, so no solver runs and nothing waits for
    the device (torch.linalg.inv checks its result on the host)."""
    a = transforms[:, :3, :3]
    r0, r1, r2 = a[:, 0], a[:, 1], a[:, 2]
    c0 = torch.linalg.cross(r1, r2)
    det = (r0 * c0).sum(dim=-1)
    nm = torch.stack([c0, torch.linalg.cross(r2, r0),
                      torch.linalg.cross(r0, r1)], dim=1) / det[:, None, None]
    return a, transforms[:, :3, 3], nm, det


def update_instances(scene, transforms, changed=None, repack=False):
    """The scene with its instances moved to `transforms`.

    transforms: [I, 3, 4] or [I, 4, 4] object->world affines of every
    instance (scene.inst_transform's rows for the ones that stay). A
    tensor on the scene's device is used as it is; anything else is
    copied there, which waits for the copy.

    changed: the ids of the instances that moved, or None for all.
    Restricting the refit to their triangles makes its cost follow the
    moved geometry; the ids resolve to triangle indices on the host once
    per (scene, changed) pair.

    repack: re-sort the triangles by Morton code after a full refit
    (ops/lbvh.py), so chunk culling stays tight after large motion (the
    reference app's full TLAS rebuild, builder.rs:465).

    An instanced scene moves its instances by their transform rows
    alone, whatever `changed` and `repack` say: its geometry is shared
    and stays in object space."""
    transforms = torch.as_tensor(transforms, dtype=torch.float32,
                                 device=scene.tri_planes.device)
    if scene.instanced:
        return _update_instanced(scene, transforms)
    if repack:
        return morton_reorder(update_instances(scene, transforms))
    if changed is not None:
        return _update_changed(scene, transforms, tuple(sorted(changed)))
    return _update_full(scene, transforms)


def refit_fields(scene) -> tuple:
    """The names of the scene tensors a refit writes."""
    if scene.instanced:
        return ("inst_table", "inst_aabb", "inst_transform",
                "inst_normal_mat")
    return ("tri_planes", "chunk_aabb", "tri_table", "bvh_rec",
            "inst_transform", "inst_normal_mat") + (
        () if scene.coef48_t is None else ("coef48_t",))


def update_instances_(scene, transforms, changed=None, repack=False):
    """`update_instances` written in place: each of the scene's
    `refit_fields` takes the refit's result by `copy_`, so every address
    stays. Returns the scene. `changed` resolves on the host at its first
    use for the scene (`changed_indices`); call that before capturing a
    graph. A repack re-sorts the triangles into new tensors, so it is
    refused here."""
    if repack:
        raise ValueError("update_instances_ refits in place; a repack "
                         "re-sorts the triangles: call update_instances")
    new = update_instances(scene, transforms, changed)
    if new is not scene:
        for name in refit_fields(scene):
            getattr(scene, name).copy_(getattr(new, name))
    return scene


def _world(scene, a, t, nm, local, tl):
    """World triangles (v0, e1, e2 [N, 3]) and shading vectors ([N, 3, 6]:
    the three vertex normals, then the three tangents) of N triangles
    with per-triangle affines a, t and normal matrices nm, object rows
    `local` of local_* and object shading rows tl [N, 26]."""
    tri = _matmul(a, torch.stack([scene.local_v0[local], scene.local_e1[local],
                                  scene.local_e2[local]], dim=2))
    shade = torch.cat([tl[:, 0:9].reshape(-1, 3, 3),
                       tl[:, 15:24].reshape(-1, 3, 3)], dim=1)
    shade = _matmul(nm, shade.transpose(1, 2))
    return tri[:, :, 0] + t, tri[:, :, 1], tri[:, :, 2], shade


def _shading(tri_table, rows, v0, e1, e2, shade):
    """tri_table with rows `rows` (all when None) given world normals and
    tangents (shade [N, 3, 6]) and world v0 | e1 | e2; the uvs, tangent
    sign and material stay."""
    old = tri_table if rows is None else tri_table[rows]
    cols = shade.transpose(1, 2)                    # [N, 6, 3]
    new = torch.cat([cols[:, 0:3].reshape(-1, 9), old[:, 9:15],
                     cols[:, 3:6].reshape(-1, 9), old[:, 24:26], v0, e1, e2],
                    dim=1)
    if rows is None:
        return new
    out = tri_table.clone()
    out[rows] = new
    return out


def _records(scene, rows, v0, e1, e2, tri_mn, tri_mx):
    """bvh_rec with the triangle records at `rows` set to (v0, e1, e2)
    and every box refit over triangle boxes tri_mn / tri_mx [T, 3]."""
    rec = scene.bvh_rec.clone()
    rec[rows, 0:9] = torch.cat([v0, e1, e2], dim=1)
    return _refit_boxes(scene, rec, tri_mn, tri_mx)


def _update_full(scene, transforms):
    """Every instance retransformed."""
    a, t, nm, _ = _affine(transforms)
    inst = scene.tri_inst.long()
    v0, e1, e2, shade = _world(scene, a[inst], t[inst], nm[inst],
                               scene.tri_local.long(), scene.tri_table_local)
    n = v0.shape[0]
    planes = scene.tri_planes.clone()
    planes[0:3, :, :n] = torch.stack([v0.T, e1.T, e2.T])
    v1, v2 = v0 + e1, v0 + e2
    mn = torch.minimum(torch.minimum(v0, v1), v2)
    mx = torch.maximum(torch.maximum(v0, v1), v2)
    return dataclasses.replace(
        scene,
        tri_planes=planes,
        coef48_t=_coef(scene, planes),
        chunk_aabb=chunk_boxes(scene.chunk_aabb, mn, mx, planes.shape[2]),
        tri_table=_shading(scene.tri_table, None, v0, e1, e2, shade),
        bvh_rec=_records(scene, scene.bvh_tri_rows.long(), v0, e1, e2, mn,
                         mx),
        inst_transform=transforms[:, :3, :4].contiguous(),
        inst_normal_mat=nm,
    )


def _coef(scene, planes):
    """K6's table of the new planes, where the scene carries one."""
    if scene.coef48_t is None:
        return None
    return mode_table(planes, scene.kernel, scene.incull,
                      brute_max=scene.brute_max)


def _update_instanced(scene, transforms):
    """An instanced scene's inst_table and inst_aabb from new affines:
    work per instance; the object blocks stay as they are."""
    a, t, nm, det = _affine(transforms)
    n_i = a.shape[0]
    a_inv = nm.transpose(-1, -2)
    b = -_matmul(a_inv, t[:, :, None])[:, :, 0]
    detsign = torch.where(det >= 0.0, 1.0, -1.0)
    inst_table = torch.cat([a_inv.reshape(n_i, 9), b, nm.reshape(n_i, 9),
                            detsign[:, None], scene.inst_table[:, 22:23]],
                           dim=1)

    # each instance's object box: the union of its mesh's group boxes
    # (unit_inst / unit_group list every (instance, group) pair); an
    # instance with no group keeps (inf, -inf), as segment_min/max do
    g = scene.obj_group_aabb
    seg = scene.unit_inst.long()[:, None].expand(-1, 3)
    grp = scene.unit_group.long()
    inf = float("inf")
    mn_o = g.new_full((n_i, 3), inf).scatter_reduce(
        0, seg, g[0:3, grp].T, "amin")
    mx_o = g.new_full((n_i, 3), -inf).scatter_reduce(
        0, seg, g[3:6, grp].T, "amax")
    c_w = _matmul(a, ((mn_o + mx_o) * 0.5)[:, :, None])[:, :, 0] + t
    e_w = _matmul(a.abs(), ((mx_o - mn_o) * 0.5)[:, :, None])[:, :, 0]
    inst_aabb = scene.inst_aabb.clone()
    inst_aabb[:, 0:3] = c_w - e_w
    inst_aabb[:, 3:6] = c_w + e_w
    return dataclasses.replace(
        scene,
        inst_table=inst_table,
        inst_aabb=inst_aabb,
        inst_transform=transforms[:, :3, :4].contiguous(),
        inst_normal_mat=nm,
    )


_CHANGED_CACHE: dict = {}
_CHANGED_CACHE_MAX = 64


def _resolve_changed(scene, changed: tuple) -> tuple:
    """Host half of a changed-instance refit, once per (scene, changed):
    the moved triangles' indices (sel), their local_* rows, their
    instance's position in `changed`, their BVH record rows, and
    `changed` itself, each on the scene's device. Reads tri_inst to the
    host."""
    dev = scene.tri_planes.device
    inst_h = scene.tri_inst.cpu().numpy()
    sel = np.nonzero(np.isin(inst_h, np.asarray(changed)))[0]
    remap = np.zeros(max(int(inst_h.max(initial=0)) + 1, 1), np.int64)
    remap[list(changed)] = np.arange(len(changed))
    rows = scene.bvh_tri_rows.cpu().numpy()[sel]
    local = scene.tri_local.cpu().numpy()[sel]
    return tuple(torch.as_tensor(x, dtype=torch.int64, device=dev)
                 for x in (sel, local, remap[inst_h[sel]], rows, changed))


def changed_indices(scene, changed) -> tuple:
    """The device indices of a changed-instance refit of `scene` (see
    `_resolve_changed`), resolved on the host at the first call for
    (scene, changed) and served from a cache after it.

    The cache keys on id(tri_inst), which a refit keeps. Each entry holds
    a weakref to that tensor whose callback evicts the entry, so an id
    that CPython recycles after the scene dies can never serve another
    scene's indices; the cache also drops its oldest entry beyond
    _CHANGED_CACHE_MAX, so a long-lived process does not pin old
    tensors; a caller that captures the indices in a CUDA graph keeps the
    returned tuple."""
    changed = tuple(sorted(changed))
    key = (id(scene.tri_inst), changed)
    if key not in _CHANGED_CACHE:
        while len(_CHANGED_CACHE) >= _CHANGED_CACHE_MAX:
            _CHANGED_CACHE.pop(next(iter(_CHANGED_CACHE)))
        guard = weakref.ref(scene.tri_inst,
                            lambda _r, k=key: _CHANGED_CACHE.pop(k, None))
        _CHANGED_CACHE[key] = (_resolve_changed(scene, changed), guard)
    return _CHANGED_CACHE[key][0]


def _update_changed(scene, transforms, changed: tuple):
    """Refit restricted to the `changed` instances' triangles: O(moved
    triangles) transforms, then O(T) box reductions."""
    if not changed:
        return scene
    return _changed_device(scene, transforms,
                           *changed_indices(scene, changed))


def _changed_device(scene, transforms, sel, local, sub_inst, rows, ch):
    """Device half of the changed-instance refit."""
    tf = transforms[ch]
    a, t, nm, _ = _affine(tf)
    v0, e1, e2, shade = _world(scene, a[sub_inst], t[sub_inst],
                               nm[sub_inst], local,
                               scene.tri_table_local[sel])
    planes = scene.tri_planes.clone()
    planes[0:3, :, sel] = torch.stack([v0.T, e1.T, e2.T])

    # boxes over the updated planes, the padding masked by its valid row
    w0 = planes[0].T
    w1, w2 = w0 + planes[1].T, w0 + planes[2].T
    valid = (planes[3, 0] > 0.5)[:, None]
    mn = torch.where(valid, torch.minimum(torch.minimum(w0, w1), w2), INF)
    mx = torch.where(valid, torch.maximum(torch.maximum(w0, w1), w2), -INF)
    n = scene.tri_inst.shape[0]

    inst_tf = scene.inst_transform.clone()
    inst_tf[ch] = tf[:, :3, :4]
    inst_nm = scene.inst_normal_mat.clone()
    inst_nm[ch] = nm
    return dataclasses.replace(
        scene,
        tri_planes=planes,
        coef48_t=_coef(scene, planes),
        chunk_aabb=chunk_boxes(scene.chunk_aabb, mn, mx, planes.shape[2]),
        tri_table=_shading(scene.tri_table, sel, v0, e1, e2, shade),
        bvh_rec=_records(scene, rows, v0, e1, e2, mn[:n], mx[:n]),
        inst_transform=inst_tf,
        inst_normal_mat=inst_nm,
    )


def _refit_boxes(scene, rec, tri_mn, tri_mx):
    """Bottom-up box refit of the BVH stream's box records.

    A leaf box takes the min / max over its (up to LEAF_SIZE) triangle
    records, an inner box the union of its two children, level by level
    from the deepest: bvh_max_depth masked sweeps over the whole stream,
    a Python loop with no read back to the host."""
    s = rec.shape[0]
    skip, left = scene.bvh_skip, scene.bvh_left
    is_box = skip >= 0
    is_leaf_box = is_box & (left < 0)
    idx = torch.arange(s, device=rec.device)

    # a leaf box's triangles are the records idx+1 .. skip-1
    mn = rec.new_full((s, 3), INF)
    mx = rec.new_full((s, 3), -INF)
    for k in range(LEAF_SIZE):
        child = torch.clamp(idx + 1 + k, max=s - 1)
        ok = (is_leaf_box & (idx + 1 + k < skip))[:, None]
        tid = torch.clamp(scene.bvh_tri[child], min=0).long()
        mn = torch.where(ok, torch.minimum(mn, tri_mn[tid]), mn)
        mx = torch.where(ok, torch.maximum(mx, tri_mx[tid]), mx)
    mn = torch.where(is_leaf_box[:, None], mn, rec[:, 0:3])
    mx = torch.where(is_leaf_box[:, None], mx, rec[:, 3:6])

    depth = scene.bvh_max_depth
    left = torch.clamp(left, min=0).long()
    right = torch.clamp(scene.bvh_right, min=0).long()
    is_inner = is_box & (scene.bvh_left >= 0)
    for d in range(depth):
        at = (is_inner & (scene.bvh_depth == depth - 1 - d))[:, None]
        mn = torch.where(at, torch.minimum(mn[left], mn[right]), mn)
        mx = torch.where(at, torch.maximum(mx[left], mx[right]), mx)
    rec[:, 0:3] = torch.where(is_box[:, None], mn, rec[:, 0:3])
    rec[:, 3:6] = torch.where(is_box[:, None], mx, rec[:, 3:6])
    return rec
