"""The port's BVH walk (`ops/traversal.py`, `ops/intersect.py`) and its
route (`trace_api.trace_route`, `SceneBuilder.build(brute_max=)`)
against the reference's, and mirrors of tests/test_bvh.py.

Tolerances, each with its measured value:
  - the port's walk against the reference's `traversal.trace` on the same
    tree and rays, closest and any-hit: tri equal on every lane and t, u,
    v and front bit-equal (measured: equal; the reference's walk itself
    equals its swept scan `_trace_brute_xla`, tri on every lane and t
    bit-equal, on 4,096 random rays at 300 random triangles and 20,000
    rays in the Cornell box);
  - the mirrors of tests/test_bvh.py keep its tolerances (walk against
    brute force within 1e-4 in t);
  - the forced walk (brute_max=1) against the default sweep, and against
    the reference's scene_trace under TPU_RT_BRUTE_MAX=1: tri equal on
    every lane and t bit-equal (measured: equal);
  - a 32^2 Cornell frame, 4 frames, built with brute_max=1 against the
    reference's frame under the same knob: PSNR >= FRAME_DB, the port's
    CPU floor (measured value beside it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_raytracer.models import scenes as ref_scenes
from tpu_raytracer.ops import bvh as ref_bvh
from tpu_raytracer.ops import trace_api as ref_trace
from tpu_raytracer.ops import traversal as ref_traversal
from tpu_raytracer.render import camera as camera_mod
from tpu_raytracer.render import pipeline as ref_pipeline
from tpu_raytracer.render import renderer as ref_renderer
from tpu_raytracer.utils.image import psnr
from tpu_raytracer_torch.models import scenes
from tpu_raytracer_torch.ops import bvh as bvh_ops
from tpu_raytracer_torch.ops import refit, trace_api, traversal
from tpu_raytracer_torch.render import pipeline, renderer
from tpu_raytracer_torch.scene import geometry
from tpu_raytracer_torch.utils.vec3 import V3

FRAME_DB = 49.0        # measured 112.35 dB (4 frames at 32^2)
W = H = 32
FRAMES = 4
MODES = [("mxuf2", False), ("mxuv2", False), ("mxuw", False),
         ("mxuw4", False), ("mxu3", False), ("mxu1", False), ("vpu", False),
         ("mxuf2", True)]

torch.set_num_threads(1)


def _random_tris(n, seed=0, spread=4.0):
    r = np.random.default_rng(seed)
    v0 = (r.random((n, 3), np.float32) - 0.5) * spread
    e1 = (r.random((n, 3), np.float32) - 0.5)
    e2 = (r.random((n, 3), np.float32) - 0.5)
    return v0.astype(np.float32), e1.astype(np.float32), e2.astype(np.float32)


def _build(v0, e1, e2):
    v1, v2 = v0 + e1, v0 + e2
    mn = np.minimum(np.minimum(v0, v1), v2)
    mx = np.maximum(np.maximum(v0, v1), v2)
    tree = bvh_ops.build_bvh(mn, mx)
    bvh_ops.fill_triangles(tree, v0, e1, e2)
    return tree


def _random_rays(n, seed, spread=8.0):
    r = np.random.default_rng(seed)
    o = ((r.random((n, 3), np.float32) - 0.5) * spread).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _v3(x):
    return V3(*torch.from_numpy(np.ascontiguousarray(x.T)))


def _walk(tree, o, d, t_min, t_max, **kw):
    return traversal.trace_plain(
        torch.from_numpy(tree.rec), torch.from_numpy(tree.skip),
        torch.from_numpy(tree.tri_id), _v3(o), _v3(d), t_min, t_max, **kw)


def _brute(v0, e1, e2, o, d, t_min, t_max):
    return traversal.trace_brute(*map(torch.from_numpy, (v0, e1, e2)),
                                 _v3(o), _v3(d), t_min, t_max)


# --- mirrors of tests/test_bvh.py ------------------------------------------

def test_stream_structure_invariants():
    v0, e1, e2 = _random_tris(257, seed=1)
    tree = _build(v0, e1, e2)
    s = tree.rec.shape[0]
    is_tri = tree.skip < 0
    assert (np.sort(tree.tri_id[is_tri]) == np.arange(257)).all()
    boxes = np.where(~is_tri)[0]
    assert (tree.skip[boxes] > boxes).all()
    assert (tree.skip[boxes] <= s).all()
    for b in boxes:
        left, right = tree.box_left[b], tree.box_right[b]
        if left >= 0:
            for c in (left, right):
                assert (tree.rec[b, 0:3] <= tree.rec[c, 0:3] + 1e-6).all()
                assert (tree.rec[b, 3:6] >= tree.rec[c, 3:6] - 1e-6).all()
    ref = ref_bvh.build_bvh(*(np.minimum(np.minimum(v0, v0 + e1), v0 + e2),
                              np.maximum(np.maximum(v0, v0 + e1), v0 + e2)))
    ref_bvh.fill_triangles(ref, v0, e1, e2)
    for name in ("rec", "skip", "tri_id"):
        assert np.array_equal(getattr(tree, name), getattr(ref, name)), name


def test_traversal_matches_brute_force():
    v0, e1, e2 = _random_tris(300, seed=2)
    tree = _build(v0, e1, e2)
    o, d = _random_rays(512, seed=3)
    got = _walk(tree, o, d, 1e-3, 1e4)
    want = _brute(v0, e1, e2, o, d, 1e-3, 1e4)
    got_t, want_t = got["t"].numpy(), want["t"].numpy()
    got_tri, want_tri = got["tri"].numpy(), want["tri"].numpy()
    hit = want_tri >= 0
    assert (got_tri >= 0).sum() == hit.sum() > 0
    assert np.abs(np.where(hit, got_t - want_t, 0)).max() < 1e-4
    mismatch = (got_tri != want_tri) & hit
    assert np.abs(got_t[mismatch] - want_t[mismatch]).max(initial=0) < 1e-4


def test_any_hit_occlusion():
    v0, e1, e2 = _random_tris(100, seed=4)
    tree = _build(v0, e1, e2)
    o, d = _random_rays(256, seed=5)
    occ = traversal.occluded(*(torch.from_numpy(x) for x in (
        tree.rec, tree.skip, tree.tri_id)), _v3(o), _v3(d), 1e-3, 1e4)
    want = _brute(v0, e1, e2, o, d, 1e-3, 1e4)["tri"] >= 0
    assert want.any() and torch.equal(occ, want)


def test_sphere_mesh_self_consistency():
    """Rays at an icosphere from outside: all hit near r = 0.5, on the
    front face."""
    mesh = geometry.create_sphere(3)
    tri = mesh.indices.reshape(-1, 3)
    v0 = mesh.positions[tri[:, 0]]
    e1 = mesh.positions[tri[:, 1]] - v0
    e2 = mesh.positions[tri[:, 2]] - v0
    tree = _build(v0, e1, e2)
    r = np.random.default_rng(6)
    d = r.normal(size=(512, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    res = _walk(tree, -d * 3.0, d, 1e-3, 1e4)
    assert (res["tri"] >= 0).all()
    assert np.abs(res["t"].numpy() - 2.5).max() < 0.02
    assert res["front"].all()


def test_empty_scene():
    tree = bvh_ops.build_bvh(np.zeros((0, 3), np.float32),
                             np.zeros((0, 3), np.float32))
    o = np.zeros((4, 3), np.float32)
    d = np.float32([[0, 0, 1.0]] * 4)
    for any_hit in (False, True):
        res = _walk(tree, o, d, 1e-3, 1e4, any_hit=any_hit)
        assert (res["tri"] == -1).all() and (res["t"] == trace_api.INF).all()


# --- the walk against the reference's, bit for bit --------------------------

def _reference_walk(rec, skip, tri, o, d, t_min, t_max, any_hit):
    res = ref_traversal.trace(jnp.asarray(rec), jnp.asarray(skip),
                              jnp.asarray(tri), jnp.asarray(o),
                              jnp.asarray(d), t_min, jnp.asarray(t_max),
                              any_hit=any_hit)
    return {k: np.asarray(v) for k, v in res.items()}


def _walk_cases():
    """(bvh_rec, bvh_skip, bvh_tri, o [R, 3], d [R, 3], t_max [R]) of the
    random-triangle tree (rays through it) and of the Cornell box (rays
    from inside it), each with random t_max and 30% dead lanes."""
    g = np.random.default_rng(9)
    v0, e1, e2 = _random_tris(300, seed=2)
    tree = _build(v0, e1, e2)
    o, d = _random_rays(2048, seed=10, spread=4.0)
    cornell = scenes.create_cornell_box("cpu")
    co = g.uniform(-0.95, 0.95, (2048, 3)).astype(np.float32)
    cd = g.standard_normal((2048, 3)).astype(np.float32)
    cd /= np.linalg.norm(cd, axis=1, keepdims=True)
    out = {}
    for name, rec, skip, tri, ro, rd, far in (
            ("random", tree.rec, tree.skip, tree.tri_id, o, d, 12.0),
            ("cornell", cornell.bvh_rec.numpy(), cornell.bvh_skip.numpy(),
             cornell.bvh_tri.numpy(), co, cd, 3.0)):
        t_max = g.uniform(0.01, far, ro.shape[0]).astype(np.float32)
        t_max[g.uniform(size=ro.shape[0]) < 0.3] = 0.0
        out[name] = (rec, skip, tri, ro, rd, t_max)
    return out


@pytest.fixture(scope="module")
def walk_cases():
    return _walk_cases()


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("case", ["random", "cornell"])
def test_walk_equals_reference(walk_cases, case, any_hit):
    rec, skip, tri, o, d, t_max = walk_cases[case]
    want = _reference_walk(rec, skip, tri, o, d, 1e-3, t_max, any_hit)
    got = traversal.trace_plain(*map(torch.from_numpy, (rec, skip, tri)),
                                _v3(o), _v3(d), 1e-3,
                                torch.from_numpy(t_max), any_hit=any_hit)
    hit = want["tri"] >= 0
    assert 0.05 < hit.mean() < 0.95
    assert not hit[t_max <= 0].any()
    assert np.array_equal(got["tri"].numpy(), want["tri"])
    assert np.array_equal(got["t"].numpy().view(np.int32),
                          want["t"].view(np.int32))
    for k in ("u", "v", "front"):
        assert np.array_equal(got[k].numpy()[hit], want[k][hit]), k


def test_walk_counts_its_steps(walk_cases):
    """`count` adds each lane's box and triangle records read, the boxes
    it missed and the records touched, and changes no answer; dead lanes
    read none, a live lane at least the root box."""
    rec, skip, tri, o, d, t_max = walk_cases["cornell"]
    args = (*map(torch.from_numpy, (rec, skip, tri)), _v3(o), _v3(d), 1e-3,
            torch.from_numpy(t_max))
    plain = traversal.trace_plain(*args)
    counted = traversal.trace_plain(*args, count=True)
    for k in plain:
        assert torch.equal(plain[k], counted[k]), k
    box, tri_steps = counted["box_steps"].numpy(), counted["tri_steps"].numpy()
    assert (box[t_max <= 0] == 0).all() and (tri_steps[t_max <= 0] == 0).all()
    assert (box[t_max > 0] >= 1).all()
    hit = counted["tri"].numpy() >= 0
    assert (tri_steps[hit] >= 1).all()
    touched = counted["touched"].numpy()
    assert touched[0] and touched.sum() <= rec.shape[0]
    assert (tri_steps.sum() > 0) and not touched[skip < 0].all()
    jumps = counted["jumps"].numpy()
    assert (jumps <= box).all() and (jumps[t_max <= 0] == 0).all()


def walk_path(rec, skip, o, d, t_min, t_max, any_hit=False):
    """One ray's walk taken a record at a time in Python, with the plain
    walk's own tests (`aabb_slab`, `moller_trumbore` on one-lane
    tensors): [(ptr, next, hit)] for each record it reads, in order;
    `next` is the record it reads after (len(rec) at the end), `hit`
    whether a box or triangle test passed. o, d: [3] f32 arrays."""
    from tpu_raytracer_torch.ops.intersect import (aabb_slab,
                                                   moller_trumbore,
                                                   safe_inv_dir)
    s = rec.shape[0]
    lo = V3(*(torch.tensor([x], dtype=torch.float32) for x in o))
    ld = V3(*(torch.tensor([x], dtype=torch.float32) for x in d))
    inv = safe_inv_dir(ld)
    lt = torch.tensor([t_min], dtype=torch.float32)
    best = torch.tensor([t_max], dtype=torch.float32)
    row = torch.from_numpy(rec)
    path, ptr = [], 0 if t_max > 0 else s
    while ptr < s:
        r = row[ptr:ptr + 1]
        if skip[ptr] >= 0:
            hit = bool(aabb_slab(lo, inv, r[:, 0:3].T, r[:, 3:6].T, lt,
                                 best)[0])
            nxt = ptr + 1 if hit else int(skip[ptr])
        else:
            won, t = moller_trumbore(lo, ld, r[:, 0:3].T, r[:, 3:6].T,
                                     r[:, 6:9].T, lt, best)[:2]
            hit = bool(won[0])
            if hit:
                best = t
            nxt = s if hit and any_hit else ptr + 1
        path.append((ptr, nxt, hit))
        ptr = nxt
    return path


def test_walk_counts_its_jumps():
    """`count`'s jumps, box steps and triangle steps equal a count of each
    lane's records taken one ray at a time (`walk_path`) on the
    300-triangle tree, closest- and any-hit; jumps are the boxes missed."""
    v0, e1, e2 = _random_tris(300, seed=2)
    tree = _build(v0, e1, e2)
    o, d = _random_rays(96, seed=11, spread=4.0)
    t_max = np.random.default_rng(12).uniform(0.01, 12.0, 96).astype(
        np.float32)
    t_max[::7] = 0.0
    for any_hit in (False, True):
        counted = _walk(tree, o, d, 1e-3, torch.from_numpy(t_max),
                        any_hit=any_hit, count=True)
        jumps, boxes, tris = [], [], []
        for i in range(96):
            path = walk_path(tree.rec, tree.skip, o[i], d[i], 1e-3,
                             float(t_max[i]), any_hit)
            box = [(p, hit) for p, _, hit in path if tree.skip[p] >= 0]
            jumps.append(sum(not hit for _, hit in box))
            boxes.append(len(box))
            tris.append(len(path) - len(box))
        assert counted["jumps"].tolist() == jumps
        assert counted["box_steps"].tolist() == boxes
        assert counted["tri_steps"].tolist() == tris
        assert 0 < sum(jumps) < sum(boxes)
        assert all(j == 0 for j, t in zip(jumps, t_max) if t <= 0)


def test_step_stats(walk_cases):
    """bigscene.step_stats (phase 23's and the variant runs' step
    statistics) against numpy on the plain walk's counts of the Cornell
    rays: steps per ray mean, p99 and max, warps of 32 lanes in call
    order (the last one padded with idle lanes), jumps."""
    from tpu_raytracer_torch import bigscene

    rec, skip, tri, o, d, t_max = walk_cases["cornell"]
    counted = traversal.trace_plain(
        *map(torch.from_numpy, (rec, skip, tri)), _v3(o), _v3(d), 1e-3,
        torch.from_numpy(t_max), count=True)
    got = bigscene.step_stats(counted)
    steps = (counted["box_steps"] + counted["tri_steps"]).numpy()
    jumps = counted["jumps"].numpy()
    assert steps.shape[0] % 32 == 0
    warp_max = steps.reshape(-1, 32).max(1)
    assert got["mean"] == pytest.approx(steps.mean(), rel=1e-12)
    assert got["p99"] == pytest.approx(np.quantile(steps, 0.99), rel=1e-12)
    assert got["max"] == steps.max()
    assert got["warp_max_over_mean"] == pytest.approx(
        warp_max.mean() / steps.mean(), rel=1e-12)
    assert got["jumps_mean"] == pytest.approx(jumps.mean(), rel=1e-12)
    assert got["jumps_max"] == jumps.max() > 0
    assert got["warp_max_over_mean"] > 1.0
    short = bigscene.step_stats({k: v[:40] for k, v in counted.items()})
    padded = np.concatenate([steps[:40], np.zeros(24, steps.dtype)])
    assert short["warp_max_over_mean"] == pytest.approx(
        padded.reshape(-1, 32).max(1).mean() / steps[:40].mean(), rel=1e-12)


def test_big_scene_and_walk_rays_small():
    """bigscene.big_scene (chip_smoke.py phase 23's scene, and
    bvh_variants.py's) at subdivision 1 with the cap at 1: 2 x 80 + 4
    triangles, every query routed to the walk; walk_rays' two sets with
    unit directions."""
    from tpu_raytracer_torch import bigscene

    scene = bigscene.big_scene("cpu", 1, (-0.3, 0.3), brute_max=1)
    assert scene.num_triangles == 2 * 20 * 4 + 4
    tp = scene.tri_planes.shape[2]
    for any_hit in (False, True):
        route = trace_api.trace_route(scene.kernel, scene.incull, tp,
                                      any_hit, scene.brute_max)
        assert route[0] == "bvh"
    rays = bigscene.walk_rays("cpu", 64)
    assert sorted(rays) == ["coherent", "incoherent"]
    for o, d, t_min, t_max in rays.values():
        assert o.shape == d.shape == (3, 64)
        assert torch.allclose(torch.linalg.vector_norm(d, dim=0),
                              torch.ones(64), atol=1e-6)
        assert (t_min == 1e-3).all() and (t_max == 100.0).all()
    res = traversal.trace_plain(scene.bvh_rec, scene.bvh_skip,
                                scene.bvh_tri, V3(*rays["coherent"][0]),
                                V3(*rays["coherent"][1]), 1e-3, 100.0)
    assert (res["tri"] >= 0).any()


# --- the route ----------------------------------------------------------------

@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("kernel,incull", MODES,
                         ids=[f"{k}{'+cull' if c else ''}" for k, c in MODES])
def test_route_walks_past_the_cap(kernel, incull, any_hit):
    """Every mode and both queries take the walk past brute_max, and
    under it the route they took before."""
    cap = 11 * trace_api.CT
    for tp in (11 * trace_api.CT, 3 * trace_api.BRUTE_FORCE_MAX_TRIS):
        past = trace_api.trace_route(kernel, incull, tp, any_hit, tp - 1)
        assert past == ("bvh", 1, 0)
    under = trace_api.trace_route(kernel, incull, cap, any_hit, cap)
    assert under[0] != "bvh"
    assert under == trace_api.trace_route(kernel, incull, cap, any_hit)
    assert trace_api.trace_route(
        kernel, incull, trace_api.BRUTE_FORCE_MAX_TRIS + trace_api.CT,
        any_hit) == ("bvh", 1, 0)


def test_instanced_scene_never_walks(monkeypatch):
    """An instanced scene takes its own route whatever its cap."""
    gallery = scenes.create_instancing_gallery_scene("cpu", n=9, subdiv=2)
    assert gallery.instanced
    o, d = _random_rays(256, seed=12)
    want = [trace_api.scene_trace(gallery, _v3(o), _v3(d), 1e-3, 20.0,
                                  any_hit=any_hit) for any_hit in (0, 1)]

    def refuse(*args, **kw):
        raise AssertionError("an instanced scene walked the BVH")

    monkeypatch.setattr(traversal, "trace_plain", refuse)
    gallery.brute_max = 1
    for any_hit in (False, True):
        got = trace_api.scene_trace(gallery, _v3(o), _v3(d), 1e-3, 20.0,
                                    any_hit=any_hit)
        assert (want[any_hit]["tri"] >= 0).any()
        for k in want[any_hit]:
            assert torch.equal(got[k], want[any_hit][k]), k


def test_build_keeps_the_cap_and_skips_the_mxu_table():
    """The cap is a scene field: a scene past it builds no K6 table, and
    the refit and the repack keep the field and walk the moved scene."""
    walk = scenes.create_cornell_box("cpu", kernel="mxu3", brute_max=1)
    sweep = scenes.create_cornell_box("cpu", kernel="mxu3")
    assert walk.brute_max == 1 and walk.coef48_t is None
    assert sweep.brute_max == trace_api.BRUTE_FORCE_MAX_TRIS
    assert sweep.coef48_t is not None
    with pytest.raises(ValueError, match="brute_max"):
        scenes.create_cornell_box("cpu", brute_max=0)
    tf = walk.inst_transform.clone()
    tf[6, :, 3] += torch.tensor([0.05, 0.02, 0.0])
    o, d = _random_rays(512, seed=13, spread=1.8)
    for kw in ({}, {"changed": (6,)}, {"repack": True}):
        moved = refit.update_instances(walk, tf, **kw)
        assert moved.brute_max == 1 and moved.coef48_t is None
        got = trace_api.scene_trace(moved, _v3(o), _v3(d), 1e-3, 50.0)
        want = traversal.trace_plain(moved.bvh_rec, moved.bvh_skip,
                                     moved.bvh_tri, _v3(o), _v3(d), 1e-3,
                                     50.0)
        assert (got["tri"] >= 0).any()
        assert torch.equal(got["tri"], want["tri"])
        assert torch.equal(got["t"], want["t"])


# --- mirror of test_bvh.py::test_brute_max_routing_knob ------------------------

@pytest.fixture(scope="module")
def knob_rays():
    rng = np.random.default_rng(61)
    r = 600
    ro = rng.uniform(-0.8, 0.8, (r, 3)).astype(np.float32)
    rd = rng.standard_normal((r, 3)).astype(np.float32)
    return ro, rd / np.linalg.norm(rd, axis=-1, keepdims=True)


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_brute_max_routing_knob(trace_env, knob_rays, any_hit):
    """Cornell built with brute_max=1 walks the BVH: against the default
    build's sweep and against the reference's scene_trace under
    TPU_RT_BRUTE_MAX=1, tri equal on every lane, t bit-equal; any-hit
    occlusion equal to the closest hit's."""
    ro, rd = knob_rays
    walk = scenes.create_cornell_box("cpu", brute_max=1)
    sweep = scenes.create_cornell_box("cpu")
    got = trace_api.scene_trace(walk, _v3(ro), _v3(rd), 1e-3, 50.0,
                                any_hit=any_hit)
    swept = trace_api.scene_trace(sweep, _v3(ro), _v3(rd), 1e-3, 50.0)
    trace_env.setenv("TPU_RT_BRUTE_MAX", "1")
    ref = ref_trace.scene_trace(ref_scenes.create_cornell_box(),
                                jnp.asarray(ro), jnp.asarray(rd), 1e-3, 50.0,
                                any_hit=any_hit)
    assert np.array_equal(got["tri"].numpy(), np.asarray(ref["tri"]))
    assert np.array_equal(got["t"].numpy(), np.asarray(ref["t"]))
    if any_hit:
        assert torch.equal(got["tri"] >= 0, swept["tri"] >= 0)
        return
    assert (swept["tri"] >= 0).float().mean() > 0.5
    assert torch.equal(got["tri"], swept["tri"])
    assert torch.equal(got["t"], swept["t"])


def test_forced_walk_frame_matches_reference(trace_env):
    """4 ReSTIR frames of the 32^2 Cornell box with every query through
    the walk, in both packages."""
    trace_env.setenv("TPU_RT_BRUTE_MAX", "1")
    ref = ref_scenes.create_cornell_box()
    port = scenes.create_cornell_box("cpu", brute_max=1)
    cam = camera_mod.CameraController()
    r_state = ref_pipeline.init_state(W, H)
    p_state = pipeline.init_state(W, H, "cpu")
    for f in range(FRAMES):
        u = cam.uniform(1.0, f, port.num_lights)
        r_ldr, _, r_state, _ = ref_pipeline.render_frame(
            ref, ref_renderer.camera_to_device(u), jnp.uint32(f), r_state,
            W, H)
        p_ldr, _, p_state, _ = pipeline.render_frame(
            port, renderer.camera_to_device(u, "cpu"), f, p_state, W, H)
    got = p_ldr.numpy()
    assert got.shape == (W * H, 3) and np.isfinite(got).all()
    p = psnr(got, np.asarray(r_ldr, np.float32))
    assert p >= FRAME_DB, f"PSNR vs reference = {p:.2f} dB"
    jax.clear_caches()
