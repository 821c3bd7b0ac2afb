"""Config 1, the progressive diffuse Cornell box, on the port, and the
reference's statistical checks of the path tracer (tests/test_oracle.py,
tests/test_estimators.py) mirrored on the port.

Tolerances, each with its reason:
  - create_cornell_box_diffuse: every table exactly the reference's (the
    build order sets every triangle id).
  - progressive frames at 48^2 against the reference's
    `render_progressive`: PROGRESSIVE_PSNR, test_torch_path.py's floor
    (paths are chaotic: an ulp flips a Russian-roulette draw).
  - the scalar oracle (tests/oracle.py): tests/test_oracle.py's quantile
    assertions unchanged (median relative error < 1e-5, more than 95% of
    lanes below 1e-3).
  - the furnace, sampling and ReSTIR-mean checks: tests/test_estimators.py's
    bounds and sizes unchanged.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracle import SceneView, trace_path_scalar
from tpu_raytracer.models import scenes as ref_scenes
from tpu_raytracer.render import camera as camera_mod
from tpu_raytracer.render import renderer as ref_renderer
from tpu_raytracer_torch.models import scenes
from tpu_raytracer_torch.ops import bsdf, gbuffer, path_trace
from tpu_raytracer_torch.render import pipeline, renderer
from tpu_raytracer_torch.scene.builder import SceneBuilder
from tpu_raytracer_torch.scene.geometry import (create_crystal, create_cube,
                                                create_plane, create_sphere)
from tpu_raytracer_torch.scene.material import NO_TEXTURE, Material
from tpu_raytracer_torch.utils import vec3
from tpu_raytracer_torch.utils.image import psnr
from tpu_raytracer_torch.utils.math3d import (rotation_x, scale,
                                              translation)
from tpu_raytracer_torch.utils.vec3 import V3

PROGRESSIVE_PSNR = 45.0
W = H = 48
PI = np.pi
TABLES = ["tri_planes", "chunk_aabb", "tri_table", "mat_table",
          "light_table", "bvh_rec", "bvh_skip", "bvh_tri"]

# The tests run in several worker processes at once: one torch thread each
# keeps them from oversubscribing the cores.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def diffuse():
    ref = jax.tree_util.tree_map(np.asarray,
                                 ref_scenes.create_cornell_box_diffuse())
    return ref, scenes.create_cornell_box_diffuse("cpu")


@pytest.mark.parametrize("name", TABLES)
def test_diffuse_table_equals_reference(diffuse, name):
    ref, port = diffuse
    want = np.asarray(getattr(ref, name))
    got = getattr(port, name).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


def test_diffuse_metadata(diffuse):
    ref, port = diffuse
    assert port.num_triangles == ref.num_triangles
    assert port.num_lights == ref.num_lights == 1
    assert port.tex_channels == ref.tex_channels
    for group in ("materials", "lights"):
        for k, v in getattr(ref, group).items():
            assert np.array_equal(getattr(port, group)[k].numpy(),
                                  np.asarray(v)), (group, k)


def test_progressive_frames_match_reference(diffuse):
    """bench.py's config-1 sequence, cut to 3 frames at 48^2."""
    _, port = diffuse
    ref = ref_scenes.create_cornell_box_diffuse()
    cam = camera_mod.CameraController()
    acc_r = ref_renderer.make_accum(W, H)
    acc_p = renderer.make_accum(W, H, "cpu")
    for f in range(3):
        u = cam.uniform(1.0, f, ref.num_lights)
        acc_r, _ = ref_renderer.render_progressive(
            ref, ref_renderer.camera_to_device(u), jnp.uint32(f), acc_r, W, H)
        acc_p, rad = renderer.render_progressive(
            port, renderer.camera_to_device(u, "cpu"), f, acc_p, W, H)
    got = acc_p.numpy()
    assert got.shape == (W * H, 3) and np.isfinite(got).all()
    assert (rad.numpy() > 0).any()
    assert psnr(np.clip(got, 0, 1), np.clip(np.asarray(acc_r), 0, 1)) \
        >= PROGRESSIVE_PSNR


def _untextured_cornell_glass():
    """tests/test_oracle.py's Cornell-like box with glass, metal and a
    sphere light, no textures, built by the port's builder."""
    b = SceneBuilder()
    plane_id = b.add_mesh(create_plane())
    cube_id = b.add_mesh(create_cube())
    sphere_id = b.add_mesh(create_sphere(2))
    crystal_id = b.add_mesh(create_crystal())

    m_white = b.add_material(Material((0.73, 0.73, 0.73, 1.0)))
    m_red = b.add_material(Material((0.65, 0.05, 0.05, 1.0)))
    m_metal = b.add_material(Material((0.8, 0.8, 0.8, 1.0)).metallic(0.2))
    m_glass = b.add_material(Material((0.5, 0.8, 1.0, 1.0)).glass(1.5))

    b.add_instance(plane_id, m_white, translation([0, -1, 0]) @ scale(2.0))
    b.add_instance(plane_id, m_white,
                   translation([0, 1, 0]) @ rotation_x(PI) @ scale(2.0))
    b.add_instance(plane_id, m_red,
                   translation([0, 0, -1]) @ rotation_x(PI / 2) @ scale(2.0))
    b.register_quad_light(
        plane_id, translation([0, 0.99, 0]) @ rotation_x(PI) @ scale(0.5),
        [1.0, 1.0, 1.0], 10.0)
    b.add_instance(crystal_id, m_glass,
                   translation([0.4, -0.5, 0.3]) @ scale(0.5))
    b.add_instance(cube_id, m_metal,
                   translation([-0.4, -0.6, -0.2]) @ scale(0.5))
    b.register_sphere_light(
        sphere_id, translation([-0.4, 0.2, 0.5]) @ scale(0.1),
        [0.9, 0.2, 0.1], 8.0)
    return b.build("cpu")


def _run_oracle(scene, n_lanes=220, seed0=12345):
    """tests/test_oracle.py:_run_compare on the port's G-buffer and path
    tracer."""
    mat = scene.mat_table.numpy()
    assert np.isin(mat[:, 12], [NO_TEXTURE, 0]).all(), \
        "oracle covers untextured scenes only"
    assert (mat[:, 13:17] == NO_TEXTURE).all(), \
        "oracle covers untextured scenes only"
    cam = camera_mod.CameraController()
    uniform = renderer.camera_to_device(cam.uniform(1.0, 0, scene.num_lights),
                                        "cpu")
    gb = gbuffer.render_gbuffer(scene, uniform, W, H)
    seeds = np.random.default_rng(seed0).integers(0, 2 ** 32, W * H,
                                                  dtype=np.uint32)
    out = path_trace.trace_path(scene, gb, uniform["view_pos"][:3],
                                torch.from_numpy(seeds.astype(np.int64)))
    rad_vec = out["radiance"].numpy()

    view = SceneView(scene)
    view_pos = uniform["view_pos"][:3].numpy().astype(np.float32)
    valid = gb["valid"].numpy()
    lanes = np.random.default_rng(7).permutation(np.where(valid)[0])[:n_lanes]
    gb_np = {k: v.numpy() for k, v in gb.items()}
    normals = vec3.arr(vec3.oct_decode(gb["oct_normal"][:, 0],
                                       gb["oct_normal"][:, 1])).numpy()
    errs = []
    for lane in lanes:
        lane_gb = {"valid": bool(gb_np["valid"][lane]),
                   "pos": gb_np["pos"][lane],
                   "normal": normals[lane],
                   "albedo": gb_np["albedo"][lane],
                   "mat_id": int(gb_np["mat_id"][lane])}
        want = trace_path_scalar(view, lane_gb, view_pos, int(seeds[lane]))
        got = rad_vec[lane]
        errs.append(np.abs(got - want).max() / (1.0 + np.abs(want).max()))
    errs = np.asarray(errs)
    # most lanes numerically identical; allow a handful of chaotic flips
    assert np.median(errs) < 1e-5, np.median(errs)
    frac_good = (errs < 1e-3).mean()
    assert frac_good > 0.95, (frac_good, np.sort(errs)[-8:])


def test_oracle_diffuse_cornell(diffuse):
    _run_oracle(diffuse[1])


def test_oracle_glass_metal():
    _run_oracle(_untextured_cornell_glass())


def _mat(n, roughness=0.5, metallic=0.0, transmission=0.0, ior=1.0):
    return {k: torch.full((n,), v, dtype=torch.float32) for k, v in (
        ("roughness", roughness), ("metallic", metallic),
        ("transmission", transmission), ("ior", ior))}


def _splat(n, v):
    return V3(*(torch.full((n,), float(c)) for c in v))


def test_diffuse_furnace():
    """Pure Lambert (metallic 0, high roughness): E[f cos / pdf] is the
    albedo within MC error (tests/test_estimators.py)."""
    n = 200000
    state = torch.arange(n, dtype=torch.int64)
    normal = _splat(n, (0.0, 0.0, 1.0))
    wo = vec3.normalize(_splat(n, (0.3, 0.1, 0.9)))
    ones = torch.ones((n,), dtype=torch.bool)
    _, smp = bsdf.sample_bsdf(state, wo, normal, ones, _mat(n, 0.99),
                              _splat(n, (1.0, 1.0, 1.0)), ones)
    mean = vec3.arr(smp["weight"]).mean(dim=0).numpy()
    assert 0.85 < mean[0] < 1.05, mean


def test_sampling_matches_uniform_mc():
    """Importance-sampled E[f cos / pdf] equals uniform-hemisphere MC of
    the same integral for a glossy metal (tests/test_estimators.py)."""
    n = 400000
    normal = _splat(n, (0.0, 0.0, 1.0))
    wo = vec3.normalize(_splat(n, (0.4, 0.0, 0.8)))
    base = _splat(n, (0.9, 0.7, 0.4))
    mat = _mat(n, roughness=0.4, metallic=1.0)
    ones = torch.ones((n,), dtype=torch.bool)
    state = torch.arange(n, dtype=torch.int64) + 77
    _, smp = bsdf.sample_bsdf(state, wo, normal, ones, mat, base, ones)
    est_importance = vec3.arr(smp["weight"]).mean(dim=0).numpy()

    rng = np.random.default_rng(3)
    z = rng.random(n).astype(np.float32)
    phi = rng.random(n).astype(np.float32) * 2 * np.pi
    r = np.sqrt(np.maximum(1 - z * z, 0))
    wi = V3(*(torch.from_numpy(c.astype(np.float32))
              for c in (r * np.cos(phi), r * np.sin(phi), z)))
    f = bsdf.eval_bsdf(normal, wi, wo, mat, base)
    cos = torch.clamp(vec3.dot(normal, wi), min=0.0)
    est_uniform = (vec3.arr(f) * cos[:, None]).mean(dim=0).numpy() \
        * (2 * np.pi)
    assert np.abs(est_importance - est_uniform).max() < 0.05, (
        est_importance, est_uniform)


def test_restir_mean_matches_progressive(diffuse):
    """End-to-end unbiasedness: the ReSTIR frame's average HDR radiance
    matches plain progressive path tracing on the same scene
    (tests/test_estimators.py)."""
    _, scene = diffuse
    w = h = W
    frames = 24
    cam = camera_mod.CameraController()
    state = pipeline.init_state(w, h, "cpu")
    restir_sum = np.zeros(3)
    for frame in range(frames):
        u = renderer.camera_to_device(
            cam.uniform(1.0, frame, scene.num_lights), "cpu")
        _, hdr, state, _ = pipeline.render_frame(scene, u, frame, state, w, h)
        restir_sum += hdr.numpy().mean(axis=0)
    restir_mean = restir_sum / frames

    cam2 = camera_mod.CameraController()
    accum = renderer.make_accum(w, h, "cpu")
    for frame in range(frames):
        u = renderer.camera_to_device(
            cam2.uniform(1.0, frame, scene.num_lights), "cpu")
        accum, _ = renderer.render_progressive(scene, u, frame, accum, w, h)
    prog_mean = accum.numpy().mean(axis=0)

    rel = np.abs(restir_mean - prog_mean) / np.maximum(prog_mean, 1e-6)
    assert rel.max() < 0.15, (restir_mean, prog_mean)
