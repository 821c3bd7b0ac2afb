"""Batched spatial-tap visibility (`make_ctx(tap_batch=True)`, the
reference's TPU_RT_TAP_BATCH=1, `tpu_raytracer/ops/restir.py:401-511`)
against the reference and against the port's sequential taps.

The batched taps draw the reservoir-update number where a tap reaches
its visibility test, not after it passes, so their RNG stream leaves the
sequential one wherever a tap is blocked (the reference's own note).
Tolerances, each with its measured value:
  - the port's batched Cornell frames against the reference's batched
    frames (its ctx["tap_batch"] set, its render_band jitted, as
    tests/test_render.py:168-184 runs it): PSNR >= FLOOR_DB on the
    fourth frame (measured 112.35 dB; frames 1-3 106.45-111.21), rays
    within RAYS_RTOL (measured equal);
  - batched against sequential on a scene where nothing blocks a tap:
    EQUAL, every output and state word;
  - batched against sequential on Cornell, 8 frames: mean |LDR
    difference| and the image means' gap below CONVERGE_ATOL, the
    reference test's bound (tests/test_render.py:214-223; measured
    9.3e-5 and 6.4e-5);
  - 4 CPU row bands with tap_batch against the one-device frame: EQUAL.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_raytracer.models import scenes as ref_scenes
from tpu_raytracer.ops import restir as ref_restir
from tpu_raytracer.parallel import views as ref_views
from tpu_raytracer.render import camera as camera_mod
from tpu_raytracer.render import pipeline as ref_pipeline
from tpu_raytracer.render import renderer as ref_renderer
from tpu_raytracer.utils.image import psnr
from tpu_raytracer_torch import convert
from tpu_raytracer_torch.ops import restir
from tpu_raytracer_torch.parallel import tiles
from tpu_raytracer_torch.render import pipeline, renderer
from tpu_raytracer_torch.scene.builder import SceneBuilder
from tpu_raytracer_torch.scene.geometry import create_plane
from tpu_raytracer_torch.scene.material import Material
from tpu_raytracer_torch.utils.math3d import rotation_x, scale, translation

FLOOR_DB = 110.0     # measured 112.35 dB
RAYS_RTOL = 0.01
CONVERGE_ATOL = 1e-3
W = H = 32
FRAMES = 4
CONVERGE_FRAMES = 8    # tests/test_render.py:214-223

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scenes():
    ref = ref_scenes.create_cornell_box()
    port = convert.scene_from_reference(
        jax.tree_util.tree_map(np.asarray, ref), "cpu")
    return ref, port


def _port_frames(scene, w, h, frames, **kw):
    """Each frame's (ldr, hdr, state, rays) of the reference camera's
    sequence through render_frame."""
    cam = camera_mod.CameraController()
    state = pipeline.init_state(w, h, "cpu")
    out = []
    for f in range(frames):
        u = renderer.camera_to_device(
            cam.uniform(w / h, f, scene.num_lights), "cpu")
        ldr, hdr, state, aux = pipeline.render_frame(scene, u, f, state, w,
                                                     h, **kw)
        out.append((ldr, hdr, state, float(aux["rays"])))
    return out


def _ref_batched(scene, w, h, frames):
    """The reference's batched frames: each frame's (ldr, rays)."""
    cam = camera_mod.CameraController()
    state = ref_pipeline.init_state(w, h)
    ctx = ref_restir.make_ctx(w, h)
    ctx["tap_batch"] = True

    def mv(flat):
        return ref_views.trivial_view(flat, w, h)

    step = jax.jit(lambda s, u, fc, st: ref_pipeline.render_band(
        s, u, fc, st, ctx, mv))
    out = []
    for f in range(frames):
        u = ref_renderer.camera_to_device(
            cam.uniform(w / h, f, scene.num_lights))
        ldr, _, state, aux = step(scene, u, jnp.uint32(f), state)
        out.append((np.asarray(ldr, np.float32), float(aux["rays"])))
    return out


@pytest.fixture(scope="module")
def cornell_runs(scenes):
    _, port = scenes
    return (_port_frames(port, W, H, CONVERGE_FRAMES, tap_batch=True),
            _port_frames(port, W, H, CONVERGE_FRAMES))


def _words(frame):
    ldr, hdr, state, rays = frame
    return [ldr, hdr, *state.values(), torch.tensor(rays)]


def _assert_equal(got, want):
    """Every word equal: f32 words as their bits (a reservoir's seed
    rides as the f32 bit pattern of its uint32, NaN patterns included)."""
    for g, w in zip(got, want):
        for a, b in zip(_words(g), _words(w)):
            assert a.dtype == b.dtype
            if a.dtype == torch.float32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            assert torch.equal(a, b)


def test_batched_frames_match_reference(scenes, cornell_runs):
    ref, _ = scenes
    want = _ref_batched(ref, W, H, FRAMES)
    got = cornell_runs[0][:FRAMES]
    for (ldr, _, _, rays), (ref_ldr, ref_rays) in zip(got, want):
        assert abs(rays - ref_rays) <= RAYS_RTOL * ref_rays, (rays, ref_rays)
    p = psnr(got[-1][0].numpy(), want[-1][0])
    assert p >= FLOOR_DB, f"PSNR vs the reference's batched frame {p:.2f} dB"


def test_batched_equals_sequential_when_unoccluded():
    """tests/test_render.py:187-211 on the port: a plane under a quad
    light, where no tap is ever blocked, so both RNG streams agree."""
    b = SceneBuilder()
    plane_id = b.add_mesh(create_plane())
    m_white = b.add_material(Material((0.73, 0.73, 0.73, 1.0)))
    b.add_instance(plane_id, m_white, translation([0, -1, 0]) @ scale(4.0))
    b.register_quad_light(
        plane_id, translation([0, 1.5, 0]) @ rotation_x(np.pi) @ scale(0.5),
        [1.0, 1.0, 1.0], 10.0)
    scene = b.build("cpu")
    _assert_equal(_port_frames(scene, W, H, 3, tap_batch=True),
                  _port_frames(scene, W, H, 3))


def test_batched_converges_with_sequential(cornell_runs):
    """tests/test_render.py:214-223 on the port: on Cornell taps are
    blocked near the box's edges, so the two differ as another unbiased
    noise realisation, on few lanes and with the same image mean."""
    batched, sequential = (run[-1][0].numpy() for run in cornell_runs)
    assert not np.array_equal(batched, sequential)
    assert np.abs(batched - sequential).mean() < CONVERGE_ATOL
    assert abs(float(batched.mean()) - float(sequential.mean())) \
        < CONVERGE_ATOL


def test_gate_keeps_large_bands_sequential():
    """The reference's gate: batched only with tap_batch set and a band
    of at most 4M lanes, so 3840x2160 (8.3M) stays sequential, as does a
    band of 1025 rows of 4096."""
    assert restir.TAP_BATCH_MAX_LANES == 4 * 1024 * 1024
    on = dict(device="cpu", tap_batch=True)
    assert restir.tap_batch_on(restir.make_ctx(2048, 2048, **on))
    assert restir.tap_batch_on(restir.make_ctx(4096, 4096, band_h=1024, **on))
    assert not restir.tap_batch_on(
        restir.make_ctx(4096, 4096, band_h=1025, **on))
    assert not restir.tap_batch_on(restir.make_ctx(3840, 2160, **on))
    assert not restir.tap_batch_on(restir.make_ctx(32, 32, "cpu"))


def test_gate_decides_the_frame(scenes, cornell_runs, monkeypatch):
    """restir_spatial reads the gate: with the lane limit under the
    frame's 32^2 lanes a tap_batch frame makes no tap stream and equals
    the sequential frame word for word."""
    _, port = scenes
    monkeypatch.setattr(restir, "TAP_BATCH_MAX_LANES", W * H - 1)

    def no_stream(*args, **kwargs):
        raise AssertionError("the gate let a band past the limit batch")
    monkeypatch.setattr(restir, "_tap_stream", no_stream)
    _assert_equal(_port_frames(port, W, H, 2, tap_batch=True),
                  cornell_runs[1][:2])


def test_tap_stream_is_pixel_interleaved(scenes, cornell_runs, monkeypatch):
    """The stream one frame traces: 5R rays, pixel p's five taps at
    5p..5p+4, from p's surface point, along unit directions, active
    where the tap reached its visibility test; the any-hit call gets
    exactly this stream, and the frame counts its active rays."""
    _, port = scenes
    seen, calls = [], []
    orig = restir._tap_stream

    def spy(*args, **kwargs):
        out = orig(*args, **kwargs)
        seen.append(out)
        return out
    orig_occ = restir.scene_occluded

    def occ(scene, o, d, t_min, t_max, active=None, reorder="none"):
        calls.append((o, d, t_min, t_max, active))
        return orig_occ(scene, o, d, t_min, t_max, active=active,
                        reorder=reorder)
    monkeypatch.setattr(restir, "_tap_stream", spy)
    monkeypatch.setattr(restir, "scene_occluded", occ)
    frame = _port_frames(port, W, H, 2, tap_batch=True)
    _assert_equal(frame, cornell_runs[0][:2])
    assert len(seen) == 2
    taps, st = seen[-1]
    r = W * H
    assert len(taps) == restir.TAPS == 5
    batched = [c for c in calls if c[0].x.shape[0] == 5 * r]
    assert len(batched) == 2              # one any-hit call a frame
    o, d, t_min, t_max, active = batched[-1]
    assert o is st["o"] and d is st["d"] and t_max is st["t_max"]
    assert active is st["active"] and t_min == 1e-3
    for i, tap in enumerate(taps):
        assert torch.equal(st["active"][i::5], tap["shadow_active"])
        assert torch.equal(st["t_max"][i::5], tap["t_max"])
        for k in range(3):
            assert torch.equal(st["d"][k][i::5], tap["dir"][k])
            assert torch.equal(st["o"][k][i::5], st["o"][k][0::5])
    live = st["active"]
    norm = torch.sqrt(st["d"].x ** 2 + st["d"].y ** 2 + st["d"].z ** 2)
    assert bool(live.any()) and float((norm[live] - 1).abs().max()) < 1e-5


def test_bands_equal_one_device():
    """4 CPU row bands of 32 rows (>= the 16-row halo) with tap_batch,
    each band gated on its own lanes, against the one-device tap_batch
    frame: every output and state word equal."""
    w, h, bands, frames = 16, 128, 4, 2
    scene = convert.scene_from_reference(jax.tree_util.tree_map(
        np.asarray, ref_scenes.create_cornell_box()), "cpu")
    mesh = tiles.make_mesh(["cpu"] * bands)
    render = tiles.make_render_frame_tiled(mesh, w, h, tap_batch=True)
    scene_r = tiles.replicate(scene, mesh)
    state = tiles.shard_state(pipeline.init_state(w, h, "cpu"), mesh)
    cam = camera_mod.CameraController()
    got = []
    for f in range(frames):
        u = renderer.camera_to_device(
            cam.uniform(w / h, f, scene.num_lights), "cpu")
        ldr, hdr, state, aux = render(scene_r, u, f, state)
        got.append((ldr, hdr, tiles.gather_state(state), float(aux["rays"])))
    _assert_equal(got, _port_frames(scene, w, h, frames, tap_batch=True))
