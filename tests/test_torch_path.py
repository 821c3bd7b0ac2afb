"""The port's G-buffer and path tracer against the reference's.

Tolerances, each from the measured gap (XLA:CPU fuses multiply-adds and
has its own sin/cos/exp; eager PyTorch does neither):
  - G-buffer `valid` and `mat_id`: exact. Positions, normals, uvs and
    motion: GB_ATOL (measured max 7.7e-7). Albedo: ALBEDO_ATOL - the
    checker texture's bilinear filter turns a 6e-7 uv difference into up
    to 9e-5 of albedo where a ray lands on a checker edge.
  - trace_path at 32^2, from the SAME G-buffer and seeds: the final RNG
    state equal on >= 99% of lanes (measured 100%); on those lanes
    radiance within RAD_ATOL (measured max 2.6e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_raytracer.models import scenes as ref_scenes
from tpu_raytracer.ops import gbuffer as ref_gbuffer
from tpu_raytracer.ops import path_trace as ref_path
from tpu_raytracer.ops import restir as ref_restir
from tpu_raytracer.render import camera as camera_mod
from tpu_raytracer.render import renderer as ref_renderer
from tpu_raytracer.utils import rng as ref_rng
from tpu_raytracer.utils.image import psnr
from tpu_raytracer_torch import convert
from tpu_raytracer_torch.ops import gbuffer, path_trace, restir
from tpu_raytracer_torch.render import renderer

GB_ATOL = 1e-5
ALBEDO_ATOL = 1e-3
RAD_ATOL = 1e-4
STATE_AGREE = 0.99
PROGRESSIVE_PSNR = 45.0

# The tests run in several worker processes at once: one torch thread each
# keeps them from oversubscribing the cores.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    ref = ref_scenes.create_cornell_box()
    port = convert.scene_from_reference(
        jax.tree_util.tree_map(np.asarray, ref), "cpu")
    cam = camera_mod.CameraController().uniform(1.0, 0, ref.num_lights)
    return ref, port, cam


def _gb_pair(setup, w, h):
    ref, port, cam = setup
    want = jax.jit(ref_gbuffer.render_gbuffer, static_argnums=(2, 3))(
        ref, ref_renderer.camera_to_device(cam), w, h)
    got = gbuffer.render_gbuffer(port, renderer.camera_to_device(cam, "cpu"),
                                 w, h)
    return {k: np.asarray(v) for k, v in want.items()}, got


def test_primary_rays_match(setup):
    _, _, cam = setup
    o_r, d_r = ref_gbuffer.generate_primary_rays(
        ref_renderer.camera_to_device(cam), 64, 64)
    o_p, d_p = gbuffer.generate_primary_rays(
        renderer.camera_to_device(cam, "cpu"), 64, 64)
    got_d = torch.stack(list(d_p), -1).numpy()
    assert np.abs(got_d - np.asarray(d_r)).max() < 2e-7
    assert np.array_equal(torch.stack(list(o_p), -1).numpy(), np.asarray(o_r))


def test_gbuffer_64_matches(setup):
    want, got = _gb_pair(setup, 64, 64)
    assert set(got) == set(want)
    assert np.array_equal(got["valid"].numpy(), want["valid"])
    assert np.array_equal(got["mat_id"].numpy(), want["mat_id"])
    assert got["valid"].float().mean() > 0.95
    for k in ("pos", "oct_normal", "uv", "motion"):
        assert np.abs(got[k].numpy() - want[k]).max() < GB_ATOL, k
    assert np.abs(got["albedo"].numpy() - want["albedo"]).max() < ALBEDO_ATOL


def test_packed_gbuffer_round_trips(setup):
    want, got = _gb_pair(setup, 16, 16)
    rows = gbuffer.pack_gb(got)
    assert rows.shape == (256, gbuffer.GB_COLS)
    back = gbuffer.unpack_gb(rows)
    for k, v in got.items():
        assert torch.equal(back[k], v), k
    ref_rows = np.asarray(ref_gbuffer.pack_gb(
        {k: jnp.asarray(v) for k, v in want.items()}))
    assert np.abs(rows.numpy() - ref_rows).max() < ALBEDO_ATOL


def test_reservoir_packing_matches_reference():
    """Packed reservoir rows share the reference's layout, the uint32 seed
    riding as its f32 bit pattern."""
    g = np.random.default_rng(0)
    n = 64
    y = g.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    ref_res = ref_restir.empty_reservoirs(n)
    ref_res["y"] = jnp.asarray(y)
    ref_res["M"] = jnp.asarray(g.integers(0, 30, n).astype(np.int32))
    ref_res["w_sum"] = jnp.asarray(g.uniform(size=n).astype(np.float32))
    want = np.asarray(ref_restir.pack_reservoirs(ref_res))
    res = restir.empty_reservoirs(n, "cpu")
    res["y"] = torch.from_numpy(y.astype(np.int64))
    res["M"] = torch.from_numpy(np.array(ref_res["M"]))
    res["w_sum"] = torch.from_numpy(np.array(ref_res["w_sum"]))
    rows = restir.pack_reservoirs(res)
    assert np.array_equal(rows.numpy().view(np.uint32), want.view(np.uint32))
    back = restir.unpack_reservoirs(rows)
    assert np.array_equal(back["y"].numpy(), y.astype(np.int64))
    assert torch.equal(back["M"], res["M"])


@pytest.fixture(scope="module")
def paths(setup, ):
    """trace_path at 32^2 through both packages from the REFERENCE's
    G-buffer and seeds. The reference's final RNG states are read from its
    bounce loop's carry (a spy on lax.while_loop)."""
    ref, port, cam = setup
    w = h = 32
    n = w * h
    ref_gb = jax.jit(ref_gbuffer.render_gbuffer, static_argnums=(2, 3))(
        ref, ref_renderer.camera_to_device(cam), w, h)
    seeds = ref_rng.pcg_hash(jnp.arange(n, dtype=jnp.uint32) + 12345)
    view_pos = jnp.asarray(cam["view_pos"][:3])

    def run(scene, gb, vp, sd):
        carry = {}
        orig = jax.lax.while_loop

        def spy(cond, body, init):
            carry["out"] = orig(cond, body, init)
            return carry["out"]
        jax.lax.while_loop = spy
        try:
            out = ref_path.trace_path(scene, gb, vp, sd)
        finally:
            jax.lax.while_loop = orig
        return out, carry["out"]["state"]

    want, want_state = jax.jit(run)(ref, ref_gb, view_pos, seeds)
    got = path_trace.trace_path(
        port, {k: torch.from_numpy(np.array(v)) for k, v in ref_gb.items()},
        torch.from_numpy(np.array(view_pos)),
        torch.from_numpy(np.asarray(seeds).astype(np.int64)))
    want = {k: np.asarray(v) for k, v in want.items()}
    return want, np.asarray(want_state).astype(np.int64), got


def test_trace_path_final_rng_states(paths):
    _, want_state, got = paths
    agree = (got["state"].numpy() == want_state).mean()
    assert agree >= STATE_AGREE, agree


def test_trace_path_radiance(paths):
    want, want_state, got = paths
    same = got["state"].numpy() == want_state
    diff = np.abs(got["radiance"].numpy() - want["radiance"]).max(axis=1)
    assert diff[same].max() < RAD_ATOL, diff[same].max()
    assert (got["valid_v1"].numpy() == want["valid_v1"])[same].all()
    v1 = np.abs(got["v1_pos"].numpy() - want["v1_pos"]).max(axis=1)
    assert v1[same].max() < GB_ATOL
    assert got["radiance"].shape == want["radiance"].shape
    assert (got["radiance"].numpy() > 0).any()


def test_trace_path_ray_count(paths):
    want, _, got = paths
    assert abs(float(got["rays"]) - float(want["rays"])) \
        <= 0.01 * float(want["rays"])


def test_progressive_frames_match(setup):
    """render_progressive, the frame before ReSTIR: 2 frames at 32^2."""
    ref, port, _ = setup
    w = h = 32
    cam = camera_mod.CameraController()
    acc_r = ref_renderer.make_accum(w, h)
    acc_p = renderer.make_accum(w, h, "cpu")
    for f in range(2):
        u = cam.uniform(1.0, f, ref.num_lights)
        acc_r, _ = ref_renderer.render_progressive(
            ref, ref_renderer.camera_to_device(u), jnp.uint32(f), acc_r, w, h)
        acc_p, _ = renderer.render_progressive(
            port, renderer.camera_to_device(u, "cpu"), f, acc_p, w, h)
    want = np.clip(np.asarray(acc_r), 0, 1)
    got = np.clip(acc_p.numpy(), 0, 1)
    assert psnr(got, want) >= PROGRESSIVE_PSNR


def test_pair_view_reads_like_concatenation():
    """Frames above PAIR_VIEW_PIXELS read G-buffer + reservoir rows through
    a PairView; it must read exactly what a View of the concatenation
    reads, out-of-image taps included."""
    from tpu_raytracer_torch.parallel import views

    g = np.random.default_rng(0)
    w, h = 9, 7
    a = torch.from_numpy(g.uniform(size=(w * h, 14)).astype(np.float32))
    b = torch.from_numpy(g.uniform(size=(w * h, 12)).astype(np.float32))
    gy = torch.from_numpy(g.integers(-3, h + 3, 200))
    gx = torch.from_numpy(g.integers(-3, w + 3, 200))
    got, got_ok = views.trivial_pair_view(a, b, w, h).read_cols(gy, gx)
    want, want_ok = views.trivial_view(torch.cat([a, b], -1), w, h) \
        .read_cols(gy, gx)
    assert torch.equal(got_ok, want_ok) and len(got) == len(want) == 26
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert not got_ok.all() and got_ok.any()


@pytest.fixture(scope="module")
def textured():
    """A small reference scene whose floor carries every texture channel
    Cornell lacks (normal, occlusion, emissive, metallic-roughness),
    carried across by convert.py: the only way the port meets those
    branches before the glTF loader is ported."""
    from tpu_raytracer.scene.builder import SceneBuilder
    from tpu_raytracer.scene.geometry import create_plane, create_sphere
    from tpu_raytracer.scene.material import Material
    from tpu_raytracer.utils.math3d import rotation_x, scale, translation

    g = np.random.default_rng(11)
    yy, xx = np.meshgrid(np.linspace(0, 1, 1024), np.linspace(0, 1, 1024),
                         indexing="ij")

    def image():
        # smooth: a uv difference of ulps must move a texel by ulps, not
        # jump between unrelated random texels
        f, ph = g.uniform(1, 4, (3, 2)), g.uniform(0, 2 * np.pi, 3)
        return np.stack([127.5 * (1 + np.sin(2 * np.pi * (f[c, 0] * xx
                                                          + f[c, 1] * yy)
                                             + ph[c]))
                         for c in range(3)], -1).astype(np.uint8)

    b = SceneBuilder()
    plane, sphere = b.add_mesh(create_plane()), b.add_mesh(create_sphere(1))
    floor = b.add_material(
        Material((0.7, 0.7, 0.7, 1.0)).roughness(0.6)
        .texture(b.add_color_texture(image()))
        .normal_texture(b.add_data_texture(image()))
        .occlusion_texture(b.add_data_texture(image()))
        .emissive_texture(b.add_color_texture(image()))
        .metallic_roughness_texture(b.add_data_texture(image())))
    ball = b.add_material(Material((0.8, 0.5, 0.3, 1.0)).roughness(0.3))
    b.add_instance(plane, floor, translation([0, -1, 0]) @ scale(3.0))
    b.add_instance(sphere, ball, translation([0, -0.5, 0]) @ scale(0.8))
    b.register_quad_light(
        plane, translation([0, 1.5, 0]) @ rotation_x(np.pi) @ scale(1.0),
        [1.0, 1.0, 1.0], 8.0)
    ref = b.build()
    port = convert.scene_from_reference(
        jax.tree_util.tree_map(np.asarray, ref), "cpu")
    assert port.tex_channels == frozenset(
        {"color", "normal", "occlusion", "emissive", "metallic_roughness"})
    cam = camera_mod.CameraController(
        position=np.array([0.0, 0.5, 3.0], np.float32), pitch=-0.35)
    return ref, port, cam.uniform(1.0, 0, ref.num_lights)


def test_all_texture_channels_match(textured):
    ref, port, cam = textured
    w = h = 24
    want = jax.jit(ref_gbuffer.render_gbuffer, static_argnums=(2, 3))(
        ref, ref_renderer.camera_to_device(cam), w, h)
    got = gbuffer.render_gbuffer(port, renderer.camera_to_device(cam, "cpu"),
                                 w, h)
    assert np.array_equal(got["mat_id"].numpy(), np.asarray(want["mat_id"]))
    assert (got["mat_id"].numpy() == 1).any()        # the textured floor
    for k in ("oct_normal", "albedo"):
        assert np.abs(got[k].numpy() - np.asarray(want[k])).max() \
            < ALBEDO_ATOL, k

    seeds = np.asarray(ref_rng.pcg_hash(jnp.arange(w * h,
                                                   dtype=jnp.uint32)))
    view_pos = jnp.asarray(cam["view_pos"][:3])
    r_out = jax.jit(ref_path.trace_path)(ref, want, view_pos,
                                         jnp.asarray(seeds))
    p_out = path_trace.trace_path(
        port, {k: torch.from_numpy(np.array(v)) for k, v in want.items()},
        torch.from_numpy(np.array(view_pos)),
        torch.from_numpy(seeds.astype(np.int64)))
    diff = np.abs(p_out["radiance"].numpy()
                  - np.asarray(r_out["radiance"])).max(axis=1)
    assert (diff < RAD_ATOL).mean() >= STATE_AGREE, (diff < RAD_ATOL).mean()
