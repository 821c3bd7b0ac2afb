"""The port's refit (ops/refit.py) and its scene fields against the
reference's, and mirrors of tests/test_refit.py.

Tolerances, each with its measured value:
  - the builder's refit fields (flattened Cornell, the mini gallery):
    EXACTLY equal, integers and floats alike (the same numpy host code);
  - refit tables against the reference's refit on the same transforms:
    the geometry (tri_planes, chunk_aabb, bvh_rec) and every permuted
    field EXACTLY equal - the port writes the fused multiply-adds XLA:CPU
    makes of the reference's einsums - and the normal matrices, the
    shading rows and the instance rows within REFIT_ATOL (measured max
    2.4e-7 on Cornell, 4.8e-7 on the gallery's inst_table): the port
    inverts A in closed form (cross products over det A), the reference
    by LU;
  - the plain trace on the port's refit scene against the reference's
    `_trace_brute_xla` on its own: tri equal on every lane and t within
    T_ATOL (measured 0: the planes are equal); on the reference's refit
    tables carried by convert.py: tri and t exact;
  - config 4 at 64x36 (3 fly-through frames, the crystal refit each
    frame): each frame's ldr against the reference's, PSNR >= FLY_DB
    (measured 122.0, 39.8 and 50.2 dB: one sample a frame, so 3 pixels
    whose paths flip cost frame 1 its 40 dB; ROADMAP's floor, 38, stays),
    and against the port's frame on the reference's refit tables carried
    by convert.py, PSNR >= REFIT_FRAME_DB (measured inf, 176.4 and 156.6
    dB: the refit's own share of the gap).
  - the port's BVH walk (`traversal.trace_plain`) over a refit scene's
    `bvh_rec`, and over the one after a repack, against the swept trace
    of the same scene: tri equal on every lane and t bit-equal (measured:
    equal), and the reference's checks (tests/test_refit.py:57-60,
    117-123) against the fresh build and the unpacked scene;
  - `update_instances_` (the refit written into the scene's tensors)
    against `update_instances` on the same transforms: every field it
    writes EQUAL word for word (the same arithmetic, copied; Cornell with
    changed=(6,), the full refit, the instanced gallery, mxu3's K6
    table), every address kept; over a 4-frame wobble against the
    reference's changed refit, the geometry EXACT and the rest within
    REFIT_ATOL (measured 2.4e-7 on tri_table and inst_normal_mat).
"""

import dataclasses
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_raytracer.models import scenes as ref_scenes
from tpu_raytracer.ops import refit as ref_refit
from tpu_raytracer.ops import trace_api as ref_trace
from tpu_raytracer.render import camera as camera_mod
from tpu_raytracer.render import pipeline as ref_pipeline
from tpu_raytracer.render import renderer as ref_renderer
from tpu_raytracer.utils.image import psnr
from tpu_raytracer_torch import convert
from tpu_raytracer_torch.models import scenes
from tpu_raytracer_torch.ops import refit, trace_api, trace_mxu, traversal
from tpu_raytracer_torch.render import pipeline, renderer
from tpu_raytracer_torch.scene.builder import SceneBuilder
from tpu_raytracer_torch.scene.geometry import create_cube, create_plane
from tpu_raytracer_torch.scene.material import Material
from tpu_raytracer_torch.utils.math3d import rotation_y, scale, translation
from tpu_raytracer_torch.utils.vec3 import V3

REFIT_ATOL = 1e-6
T_ATOL = 1e-4
FLY_DB = 38.0
REFIT_FRAME_DB = 120.0
FLY_W, FLY_H, FLY_FRAMES = 64, 36, 3
CRYSTAL = 6

FIELDS = ["bvh_left", "bvh_right", "bvh_depth", "bvh_tri_rows",
          "tri_table_local", "tri_inst", "tri_prim", "tri_local",
          "local_v0", "local_e1", "local_e2", "inst_mesh_id",
          "inst_transform", "inst_normal_mat"]
EXACT = ["tri_planes", "chunk_aabb", "bvh_rec", "inst_transform",
         "tri_inst", "tri_prim", "tri_local", "bvh_tri", "bvh_tri_rows",
         "tri_table_local"]
CLOSE = ["tri_table", "inst_normal_mat"]

torch.set_num_threads(1)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def cornell():
    ref = ref_scenes.create_cornell_box()
    return ref, _np(ref), scenes.create_cornell_box("cpu")


@pytest.fixture(scope="module")
def gallery():
    ref = ref_scenes.create_instancing_gallery_scene(n=9, subdiv=2)
    return ref, _np(ref), scenes.create_instancing_gallery_scene(
        "cpu", n=9, subdiv=2)


def _wobble(base, i):
    """bench.py:194-199: the crystal's transform at frame i."""
    tf = np.array(base, np.float32)
    tf[CRYSTAL] = (translation([0.4, -0.5 + 0.02 * (i % 8), 0.3])
                   @ rotation_y(0.1 * i) @ scale(0.5))[:3, :4]
    return tf


def _rays(n=512, seed=0, spread=6.0):
    r = np.random.default_rng(seed)
    o = ((r.random((n, 3), np.float32) - 0.5) * spread).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _trace(scene, o, d):
    return trace_api.scene_trace(scene, V3(*torch.from_numpy(o.T.copy())),
                                 V3(*torch.from_numpy(d.T.copy())), 1e-3,
                                 100.0)


@pytest.mark.parametrize("field", FIELDS + ["bvh_max_depth"])
@pytest.mark.parametrize("which", ["cornell", "gallery"])
def test_builder_refit_fields_equal_reference(request, which, field):
    _, ref, port = request.getfixturevalue(which)
    if field == "bvh_max_depth":
        assert port.bvh_max_depth == ref.bvh_max_depth
        return
    want = np.asarray(getattr(ref, field))
    got = getattr(port, field).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("which", ["cornell", "gallery"])
def test_convert_carries_refit_fields(request, which):
    _, ref, port = request.getfixturevalue(which)
    got = convert.scene_from_reference(ref, "cpu")
    for name in FIELDS:
        assert torch.equal(getattr(got, name), getattr(port, name)), name
    assert got.bvh_max_depth == port.bvh_max_depth


@pytest.fixture(scope="module")
def cornell_refits(cornell):
    """(reference, port) refits of Cornell under each path, the crystal
    moved to bench.py's frame-3 wobble."""
    ref, ref_np, port = cornell
    tf = _wobble(ref_np.inst_transform, 3)
    out = {}
    for path, kw in (("full", {}), ("changed", {"changed": (CRYSTAL,)}),
                     ("repack", {"repack": True})):
        out[path] = (ref_refit.update_instances(ref, jnp.asarray(tf), **kw),
                     refit.update_instances(port, torch.from_numpy(tf), **kw))
    return out


@pytest.mark.parametrize("path", ["full", "changed", "repack"])
def test_refit_tables_match_reference(cornell_refits, path):
    ref, port = cornell_refits[path]
    ref = _np(ref)
    for name in EXACT:
        assert np.array_equal(getattr(port, name).numpy(),
                              np.asarray(getattr(ref, name))), name
    for name in CLOSE:
        np.testing.assert_allclose(getattr(port, name).numpy(),
                                   np.asarray(getattr(ref, name)), rtol=0,
                                   atol=REFIT_ATOL, err_msg=name)


@pytest.mark.parametrize("path", ["full", "changed", "repack"])
def test_refit_trace_matches_reference(cornell_refits, path):
    """The plain trace on the port's refit scene against _trace_brute_xla
    on the reference's; then on the reference's own refit tables carried
    over by convert.py, exactly."""
    ref, port = cornell_refits[path]
    o, d = _rays(seed=1, spread=1.9)
    want = ref_trace._trace_brute_xla(ref.tri_planes, jnp.asarray(o),
                                      jnp.asarray(d), 1e-3, 100.0)
    w_tri, w_t = np.asarray(want["tri"]), np.asarray(want["t"])
    got = _trace(port, o, d)
    hit = w_tri >= 0
    assert hit.mean() > 0.5
    assert np.array_equal(got["tri"].numpy(), w_tri)
    assert np.abs(np.where(hit, got["t"].numpy() - w_t, 0)).max() <= T_ATOL
    carried = _trace(convert.scene_from_reference(_np(ref), "cpu"), o, d)
    assert np.array_equal(carried["tri"].numpy(), w_tri)
    assert np.array_equal(carried["t"].numpy()[hit], w_t[hit])


def test_instanced_refit_matches_reference(gallery):
    ref, ref_np, port = gallery
    tf = np.array(ref_np.inst_transform)
    rng = np.random.default_rng(0)
    for i in range(tf.shape[0]):
        m = (translation(rng.uniform(-1, 1, 3)) @ rotation_y(rng.uniform(0, 6))
             @ scale(rng.uniform(0.3, 1.2)))
        tf[i] = (m @ np.vstack([tf[i], [0, 0, 0, 1]]))[:3, :4]
    tf = tf.astype(np.float32)
    want = _np(ref_refit.update_instances(ref, jnp.asarray(tf)))
    got = refit.update_instances(port, torch.from_numpy(tf))
    for name in ("inst_aabb", "inst_transform"):
        assert np.array_equal(getattr(got, name).numpy(),
                              np.asarray(getattr(want, name))), name
    for name in ("inst_table", "inst_normal_mat"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), rtol=0,
                                   atol=REFIT_ATOL, err_msg=name)
    o, d = _rays(seed=2, spread=8.0)
    g = _trace(got, o, d)
    w = _trace(convert.scene_from_reference(want, "cpu"), o, d)
    hit = w["tri"].numpy() >= 0
    assert hit.any() and np.array_equal(g["tri"].numpy() >= 0, hit)
    assert np.abs(g["t"].numpy() - w["t"].numpy())[hit].max() <= T_ATOL


def test_refit_rebuilds_the_mxu_table():
    """Under a K6 mode the refit rebuilds coef48_t from the new planes."""
    scene = scenes.create_cornell_box("cpu", kernel="mxu3")
    tf = _wobble(scene.inst_transform.numpy(), 5)
    for kw in ({}, {"changed": (CRYSTAL,)}, {"repack": True}):
        moved = refit.update_instances(scene, torch.from_numpy(tf), **kw)
        assert not torch.equal(moved.tri_planes, scene.tri_planes)
        assert torch.equal(moved.coef48_t,
                           trace_mxu.kernel_table(moved.tri_planes))


# --- mirrors of tests/test_refit.py --------------------------------------

def _two_box_scene(box_pos):
    b = SceneBuilder()
    plane_id = b.add_mesh(create_plane())
    cube_id = b.add_mesh(create_cube())
    mat = b.add_material(Material((0.7, 0.7, 0.7, 1.0)))
    b.add_instance(plane_id, mat, translation([0, -1, 0]) @ scale(4.0))
    b.add_instance(cube_id, mat,
                   translation(box_pos) @ rotation_y(0.3) @ scale(0.5))
    b.register_quad_light(plane_id, translation([0, 2, 0]) @ scale(0.5),
                          [1, 1, 1], 5.0)
    return b.build("cpu")


def _moved(scene, pos, angle):
    tf = scene.inst_transform.numpy().copy()
    tf[1] = (translation(pos) @ rotation_y(angle) @ scale(0.5))[:3, :4]
    return torch.from_numpy(tf)


def _walk(scene, o, d):
    return traversal.trace_plain(
        scene.bvh_rec, scene.bvh_skip, scene.bvh_tri,
        V3(*torch.from_numpy(o.T.copy())), V3(*torch.from_numpy(d.T.copy())),
        1e-3, 100.0)


def _walk_equals_sweep(scene, o, d):
    """The walk over the scene's BVH records gives its swept answer."""
    walk, swept = _walk(scene, o, d), _trace(scene, o, d)
    assert torch.equal(walk["tri"], swept["tri"])
    assert torch.equal(walk["t"], swept["t"])
    return walk


def _same_hits(got, want):
    hit = want["tri"].numpy() >= 0
    assert np.array_equal(got["tri"].numpy() >= 0, hit)
    assert np.abs(np.where(hit, got["t"].numpy() - want["t"].numpy(),
                           0)).max() < T_ATOL
    return hit


def test_update_instances_matches_fresh_build():
    scene = _two_box_scene([0.0, -0.5, 0.0])
    fresh = _two_box_scene([0.6, -0.2, 0.3])
    moved = refit.update_instances(scene, _moved(scene, [0.6, -0.2, 0.3], 0.3))
    o, d = _rays()
    got = _trace(moved, o, d)
    want = _trace(fresh, o, d)
    hit = _same_hits(got, want)
    # the refit BVH stream stays valid for the walk too
    _same_hits(_walk_equals_sweep(moved, o, d), want)
    # shading rows: world normals follow the instance rotation
    row = moved.tri_table[int(got["tri"][int(np.argmax(hit))])].numpy()
    assert np.isfinite(row[0:3] / np.linalg.norm(row[0:3])).all()


def test_refit_changed_subset_matches_full():
    scene = _two_box_scene([0.0, -0.5, 0.0])
    tf = _moved(scene, [0.6, -0.2, 0.3], 0.9)
    full = refit.update_instances(scene, tf)
    part = refit.update_instances(scene, tf, changed=(1,))
    for field in ("tri_planes", "chunk_aabb", "tri_table", "bvh_rec",
                  "inst_transform", "inst_normal_mat"):
        np.testing.assert_allclose(getattr(part, field).numpy(),
                                   getattr(full, field).numpy(), rtol=0,
                                   atol=REFIT_ATOL, err_msg=field)


def test_refit_repack_preserves_trace():
    """repack=True must not change a trace result; each winner's shading
    row is its triangle's; a refit after a repack still works."""
    scene = _two_box_scene([0.0, -0.5, 0.0])
    tf = _moved(scene, [0.9, -0.1, 0.6], 1.3)
    plain = refit.update_instances(scene, tf)
    packed = refit.update_instances(scene, tf, repack=True)
    o, d = _rays()
    want = _trace(plain, o, d)
    got = _trace(packed, o, d)
    hit = _same_hits(got, want)
    rows_w = plain.tri_table[want["tri"][hit].long()]
    rows_g = packed.tri_table[got["tri"][hit].long()]
    np.testing.assert_allclose(rows_g.numpy(), rows_w.numpy(), rtol=0,
                               atol=1e-5)
    # the walk follows the permutation: packed ids, the same rows
    walk = _walk_equals_sweep(packed, o, d)
    _same_hits(walk, want)
    rows_b = packed.tri_table[walk["tri"][hit].long()]
    np.testing.assert_allclose(rows_b.numpy(), rows_w.numpy(), rtol=0,
                               atol=1e-5)
    again = refit.update_instances(packed, tf)
    _same_hits(_trace(again, o, d), want)


def test_refit_identity_is_noop():
    scene = scenes.create_cornell_box_diffuse("cpu")
    moved = refit.update_instances(scene, scene.inst_transform)
    for field in ("tri_planes", "tri_table"):
        np.testing.assert_allclose(getattr(moved, field).numpy(),
                                   getattr(scene, field).numpy(), rtol=0,
                                   atol=1e-5, err_msg=field)
    boxes = scene.bvh_skip.numpy() >= 0
    rec0, rec1 = scene.bvh_rec.numpy(), moved.bvh_rec.numpy()
    assert np.abs(rec1[boxes, 0:6] - rec0[boxes, 0:6]).max() < 1e-4


def test_changed_cache_evicts_on_scene_gc_and_stays_bounded(monkeypatch):
    """Entries die with their keying tensor (a recycled id can never serve
    another scene's indices) and the cache keeps at most its bound."""
    refit._CHANGED_CACHE.clear()
    scene = _two_box_scene([0.0, 0.0, 0.0])
    tf = _moved(scene, [0.2, 0.0, 0.0], 0.3)
    refit.update_instances(scene, tf, changed=(1,))
    assert len(refit._CHANGED_CACHE) == 1
    key = next(iter(refit._CHANGED_CACHE))
    assert key[0] == id(scene.tri_inst)
    del scene
    gc.collect()
    assert key not in refit._CHANGED_CACHE

    assert refit._CHANGED_CACHE_MAX == 64
    monkeypatch.setattr(refit, "_CHANGED_CACHE_MAX", 2)
    scene2 = _two_box_scene([0.3, 0.0, 0.0])
    for changed in ((0,), (1,), (0, 1)):
        refit.update_instances(scene2, tf, changed=changed)
    assert len(refit._CHANGED_CACHE) <= 2
    assert (id(scene2.tri_inst), (0,)) not in refit._CHANGED_CACHE

    # two live scenes resolve to their own index sets
    scene3 = _two_box_scene([-0.4, 0.0, 0.0])
    out2 = refit.update_instances(scene2, tf, changed=(1,))
    out3 = refit.update_instances(scene3, tf, changed=(1,))
    o, d = _rays()
    np.testing.assert_allclose(_trace(out2, o, d)["t"].numpy(),
                               _trace(out3, o, d)["t"].numpy(), atol=1e-5)


def test_changed_indices_resolve_once_per_set(monkeypatch):
    """The host half of a changed refit runs once across frames of one
    changed set (the reference's no-recompile guarantee, ported as no
    host work per frame); a new set resolves anew."""
    calls = []
    resolve = refit._resolve_changed
    monkeypatch.setattr(refit, "_resolve_changed",
                        lambda s, c: calls.append(c) or resolve(s, c))
    scene = _two_box_scene([0.0, -0.5, 0.0])
    for i in range(3):
        scene = refit.update_instances(
            scene, _moved(scene, [0.1 * i, -0.2, 0.0], 0.3), changed=(1,))
    assert calls == [(1,)]
    refit.update_instances(scene, scene.inst_transform, changed=(0, 1))
    assert calls == [(1,), (0, 1)]


def test_config4_flythrough_matches_reference(cornell):
    """bench.py's config 4 at 64x36: each frame presses `d` for 1/60 s,
    restarts the accumulation, moves the crystal and refits it with
    changed=(6,); both packages render the same frames."""
    ref, ref_np, _ = cornell
    port = convert.scene_from_reference(ref_np, "cpu")
    base = ref_np.inst_transform
    cams = [camera_mod.CameraController() for _ in range(3)]
    r_state = ref_pipeline.init_state(FLY_W, FLY_H)
    p_state = pipeline.init_state(FLY_W, FLY_H, "cpu")
    c_state = pipeline.init_state(FLY_W, FLY_H, "cpu")
    for i in range(FLY_FRAMES):
        us = []
        for cam in cams:
            cam.press("d")
            cam.update(1.0 / 60.0)
            cam.release("d")
            us.append(cam.uniform(FLY_W / FLY_H, 0, port.num_lights))
        tf = _wobble(base, i)
        ref = ref_refit.update_instances(ref, jnp.asarray(tf),
                                         changed=(CRYSTAL,))
        port = refit.update_instances(port, torch.from_numpy(tf),
                                      changed=(CRYSTAL,))
        r_ldr, _, r_state, _ = ref_pipeline.render_frame(
            ref, ref_renderer.camera_to_device(us[0]), jnp.uint32(0),
            r_state, FLY_W, FLY_H, static_ok=False)
        p_ldr, _, p_state, _ = pipeline.render_frame(
            port, renderer.camera_to_device(us[1], "cpu"), 0, p_state,
            FLY_W, FLY_H, static_ok=False)
        c_ldr, _, c_state, _ = pipeline.render_frame(
            convert.scene_from_reference(_np(ref), "cpu"),
            renderer.camera_to_device(us[2], "cpu"), 0, c_state, FLY_W,
            FLY_H, static_ok=False)
        got = p_ldr.numpy()
        assert got.shape == (FLY_W * FLY_H, 3) and np.isfinite(got).all()
        p = psnr(got, np.asarray(r_ldr, np.float32))
        assert p >= FLY_DB, f"frame {i}: PSNR {p:.2f} dB"
        p = psnr(got, c_ldr.numpy())
        assert p >= REFIT_FRAME_DB, f"frame {i}: {p:.2f} dB against the " \
            f"frame on the reference's refit tables"


# --- the refit written in place (update_instances_) ----------------------

def _owned(scene):
    """`scene` with its own copy of the fields a refit writes."""
    return dataclasses.replace(scene, **{
        name: getattr(scene, name).clone()
        for name in refit.refit_fields(scene)})


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _in_place_case(request, case):
    """(scene, transforms, changed) of each in-place case."""
    if case == "gallery":
        _, ref_np, port = request.getfixturevalue("gallery")
        tf = np.array(ref_np.inst_transform)
        tf[:, :, 3] += np.random.default_rng(5).uniform(
            -0.5, 0.5, (tf.shape[0], 3))
        return port, tf.astype(np.float32), None
    if case == "mxu3":
        port = scenes.create_cornell_box("cpu", kernel="mxu3")
    else:
        port = request.getfixturevalue("cornell")[2]
    tf = _wobble(port.inst_transform.numpy(), 3)
    return port, tf, None if case == "full" else (CRYSTAL,)


IN_PLACE = ["changed", "full", "gallery", "mxu3"]


@pytest.mark.parametrize("case", IN_PLACE)
def test_update_instances_in_place_equals_functional(request, case):
    """update_instances_ writes what update_instances returns, word for
    word, into every field it names, and leaves the rest alone."""
    port, tf, changed = _in_place_case(request, case)
    want = refit.update_instances(port, torch.from_numpy(tf), changed)
    scene = _owned(port)
    got = refit.update_instances_(scene, torch.from_numpy(tf), changed)
    assert got is scene
    names = refit.refit_fields(scene)
    assert ("coef48_t" in names) == (case == "mxu3")
    assert ("inst_table" in names) == (case == "gallery")
    for name in names:
        assert torch.equal(_bits(getattr(scene, name)),
                           _bits(getattr(want, name))), name
    assert not torch.equal(scene.inst_transform, port.inst_transform)
    for f in dataclasses.fields(scene):
        if f.name not in names:
            assert getattr(scene, f.name) is getattr(port, f.name), f.name


@pytest.mark.parametrize("case", IN_PLACE)
def test_update_instances_in_place_keeps_addresses(request, case):
    """Every field update_instances_ writes keeps its tensor and its
    data_ptr across two refits: a CUDA graph reads it there."""
    port, tf, changed = _in_place_case(request, case)
    scene = _owned(port)
    before = {n: (getattr(scene, n), getattr(scene, n).data_ptr())
              for n in refit.refit_fields(scene)}
    for step in (0.0, 0.1):
        refit.update_instances_(scene, torch.from_numpy(tf + step), changed)
        for n, (t, ptr) in before.items():
            assert getattr(scene, n) is t and t.data_ptr() == ptr, n


def test_in_place_wobble_tracks_reference(cornell):
    """Config 4's 4 first frames: the crystal moved by bench.py's wobble
    and refit in place each frame, against the reference's changed refit
    of the same transforms, frame by frame."""
    ref, _, port = cornell
    scene = _owned(port)
    base = port.inst_transform.numpy()
    worst = {}
    for i in range(4):
        tf = _wobble(base, i)
        ref = ref_refit.update_instances(ref, jnp.asarray(tf),
                                         changed=(CRYSTAL,))
        refit.update_instances_(scene, torch.from_numpy(tf),
                                changed=(CRYSTAL,))
        want = _np(ref)
        for name in refit.refit_fields(scene):
            got, exp = getattr(scene, name).numpy(), np.asarray(
                getattr(want, name))
            if name in EXACT:
                assert np.array_equal(got, exp), (i, name)
            else:
                worst[name] = max(worst.get(name, 0.0),
                                  float(np.abs(got - exp).max()))
    assert set(worst) == {"tri_table", "inst_normal_mat"}
    assert max(worst.values()) <= REFIT_ATOL, worst


def test_in_place_repack_raises(cornell):
    """A repack re-sorts the triangles into new tensors: the in-place
    refit refuses it and writes nothing."""
    scene = _owned(cornell[2])
    planes = scene.tri_planes.clone()
    tf = torch.from_numpy(_wobble(scene.inst_transform.numpy(), 2))
    with pytest.raises(ValueError, match="repack"):
        refit.update_instances_(scene, tf, repack=True)
    assert torch.equal(scene.tri_planes, planes)
