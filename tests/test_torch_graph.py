"""What a frame captured as one CUDA graph needs, on the CPU: the
per-frame scalars as device tensors, a bounce loop with no host read, no
host read anywhere in a frame but the CPU plain traces, and the app's
G-buffer reuse (reference `render/pipeline.py:_gb_for_band`,
TPU_RT_GB_REUSE). `render/graph.py:FrameGraph` itself captures only on a
card (`chip_smoke.py` phase 25 holds its replays to the eager frames bit
for bit); here it must refuse the CPU.

Tolerances, each with its measured value:
  - frame_count as a 0-dim int64 tensor against a Python int: every
    output and state word EQUAL (the same arithmetic);
  - trace_path on a camera where every lane dies before MAX_DEPTH, from
    the reference's G-buffer and seeds: final RNG states equal on every
    lane, rays equal, radiance within RAD_ATOL (measured 3.0e-8; XLA:CPU
    fuses multiply-adds the port computes apart);
  - gb_reuse against compute-always: the reference test's 2e-5
    (tests/test_dedup.py:49-69; measured 0, pack and unpack round-trip
    exactly), rays exactly W * H fewer on every static frame; against
    the reference's TPU_RT_GB_REUSE=1 frames: PSNR >= FLOOR_DB (measured
    106.5-111.2 dB; the floor is the measured value less a wide margin,
    as tests/test_torch_app.py sets APP_DB, since one flipped path costs
    tens of dB) and rays within RAYS_RTOL (measured equal), the app's
    rays too;
  - row bands with gb_reuse against one device: EQUAL.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_raytracer.app import interactive as ref_interactive
from tpu_raytracer.models import scenes as ref_scenes
from tpu_raytracer.ops import gbuffer as ref_gbuffer
from tpu_raytracer.ops import path_trace as ref_path
from tpu_raytracer.render import camera as camera_mod
from tpu_raytracer.render import pipeline as ref_pipeline
from tpu_raytracer.render import renderer as ref_renderer
from tpu_raytracer.scene.builder import SceneBuilder
from tpu_raytracer.scene.geometry import create_cube, create_plane
from tpu_raytracer.scene.material import Material
from tpu_raytracer.utils import rng as ref_rng
from tpu_raytracer.utils.config import parse_args as ref_parse_args
from tpu_raytracer.utils.image import psnr
from tpu_raytracer.utils.math3d import rotation_x, scale, translation
from tpu_raytracer_torch import convert
from tpu_raytracer_torch.app import interactive
from tpu_raytracer_torch.ops import gbuffer, path_trace, restir, trace_api
from tpu_raytracer_torch.parallel import tiles
from tpu_raytracer_torch.render import graph as graph_mod
from tpu_raytracer_torch.render import pipeline, renderer
from tpu_raytracer_torch.utils.config import parse_args

W = H = 32
FRAMES = 3
REUSE_ATOL = 2e-5     # tests/test_dedup.py's bound
RAD_ATOL = 1e-5
FLOOR_DB = 100.0
RAYS_RTOL = 0.01
HOST_READS = ("__bool__", "__int__", "__float__", "__index__", "item",
              "tolist")

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scenes():
    ref = ref_scenes.create_cornell_box()
    port = convert.scene_from_reference(
        jax.tree_util.tree_map(np.asarray, ref), "cpu")
    return ref, port


def _bits(x):
    return np.ascontiguousarray(x.numpy()).view(np.uint8)


def _frames(scene, frame_counts, as_tensor, progressive=False, w=W, h=H,
            static=lambda i: i > 0, gb_reuse=False, render=None):
    """The port's frames at w x h of the default camera for each count in
    `frame_counts`: per frame, the outputs and state as a list of
    tensors, and the rays (None for the progressive frame)."""
    cam = camera_mod.CameraController()
    state = (renderer.make_accum(w, h, "cpu") if progressive
             else pipeline.init_state(w, h, "cpu"))
    out = []
    for i, f in enumerate(frame_counts):
        u = renderer.camera_to_device(cam.uniform(w / h, f, scene.num_lights),
                                      "cpu")
        fc = torch.tensor(f, dtype=torch.int64) if as_tensor else f
        if progressive:
            state, rad = renderer.render_progressive(scene, u, fc, state, w,
                                                     h)
            out.append(([state, rad], None))
        else:
            ldr, hdr, state, aux = (render or pipeline.render_frame)(
                scene, u, fc, state, w, h, static_ok=static(i),
                gb_reuse=gb_reuse)
            out.append(([ldr, hdr, *state.values()], aux["rays"]))
    return out


@pytest.mark.parametrize("progressive", [False, True],
                         ids=["render_frame", "render_progressive"])
def test_frame_count_tensor_matches_int(scenes, progressive):
    """A captured frame reads frame_count from a 0-dim int64 tensor: the
    seeds and the accumulation blends must be the same bits as from a
    Python int (2**32 - 1 checks the uint32 mask and the f32 rounding)."""
    counts = (0, 1, 2 ** 32 - 1)
    got = _frames(scenes[1], counts, True, progressive)
    want = _frames(scenes[1], counts, False, progressive)
    for (g, g_rays), (w, w_rays) in zip(got, want):
        for a, b in zip(g, w):
            assert np.array_equal(_bits(a), _bits(b))
        assert (g_rays is None) == (w_rays is None)
        if g_rays is not None:
            assert float(g_rays) == float(w_rays)


@pytest.fixture(scope="module")
def open_scene():
    """A floor, a cube and a quad light facing down, nothing around them:
    every path escapes or reaches the light within a few bounces."""
    b = SceneBuilder()
    plane, cube = b.add_mesh(create_plane()), b.add_mesh(create_cube())
    white = b.add_material(Material((0.73, 0.73, 0.73, 1.0)))
    b.add_instance(plane, white, translation([0, -1, 0]) @ scale(4.0))
    b.add_instance(cube, white, translation([0.3, -0.7, 0]) @ scale(0.6))
    b.register_quad_light(
        plane, translation([0, 1.5, 0]) @ rotation_x(np.pi) @ scale(0.5),
        [1.0, 1.0, 1.0], 10.0)
    ref = b.build()
    return ref, convert.scene_from_reference(
        jax.tree_util.tree_map(np.asarray, ref), "cpu")


def test_trace_path_lanes_dead_before_max_depth(open_scene):
    """The fixed MAX_DEPTH loop against the reference's while_loop, which
    leaves once every lane is dead: the depths it skips must change no
    RNG state, radiance or ray count. The reference's final carry is read
    through a spy on lax.while_loop."""
    ref, port = open_scene
    cam = camera_mod.CameraController(
        position=np.array([0.0, 1.0, 2.5], np.float32), pitch=-0.5)
    u = cam.uniform(1.0, 0, ref.num_lights)
    n = W * H
    ref_gb = jax.jit(ref_gbuffer.render_gbuffer, static_argnums=(2, 3))(
        ref, ref_renderer.camera_to_device(u), W, H)
    seeds = ref_rng.pcg_hash(jnp.arange(n, dtype=jnp.uint32) + 777)
    view_pos = jnp.asarray(u["view_pos"][:3])

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
        return out, carry["out"]["state"], carry["out"]["depth"]

    want, want_state, depth = jax.jit(run)(ref, ref_gb, view_pos, seeds)
    assert int(depth) < path_trace.MAX_DEPTH, int(depth)
    valid = np.asarray(ref_gb["valid"])
    assert 0.2 < valid.mean() < 0.8         # many rays miss, many bounce
    got = path_trace.trace_path(
        port, {k: torch.from_numpy(np.array(v)) for k, v in ref_gb.items()},
        torch.from_numpy(np.array(view_pos)),
        torch.from_numpy(np.asarray(seeds).astype(np.int64)))
    assert np.array_equal(got["state"].numpy(),
                          np.asarray(want_state).astype(np.int64))
    assert float(got["rays"]) == float(want["rays"])
    rad = np.asarray(want["radiance"])
    assert (rad > 0).any()
    assert np.abs(got["radiance"].numpy() - rad).max() < RAD_ATOL
    assert np.array_equal(got["valid_v1"].numpy(), np.asarray(want["valid_v1"]))


class _NoHostReads:
    """Make every Tensor method that reads a value back to the host raise
    while on; `lifted` wraps a function to run with them restored."""

    def __init__(self):
        self.saved = {n: getattr(torch.Tensor, n) for n in HOST_READS}

    def on(self):
        def forbid(name):
            def f(self, *args, **kwargs):
                raise AssertionError(f"host read inside a frame: "
                                     f"Tensor.{name}")
            return f
        for n in HOST_READS:
            setattr(torch.Tensor, n, forbid(n))

    def off(self):
        for n, f in self.saved.items():
            setattr(torch.Tensor, n, f)

    def lifted(self, fn):
        def wrapper(*args, **kwargs):
            self.off()
            try:
                return fn(*args, **kwargs)
            finally:
                self.on()
        return wrapper


def test_frame_makes_no_host_read(scenes, monkeypatch):
    """Only the CPU plain traces read values back (a card's route
    launches a kernel there): the rest of the ReSTIR frame, static and
    with the G-buffer reused, and of the progressive frame reads none,
    from either kind of frame_count, so the frame can be captured."""
    guard = _NoHostReads()
    for mod, name in ((gbuffer, "scene_trace"), (path_trace, "scene_trace"),
                      (path_trace, "scene_occluded"),
                      (restir, "scene_occluded")):
        monkeypatch.setattr(mod, name, guard.lifted(getattr(mod, name)))
    scene = scenes[1]
    cam = camera_mod.CameraController()
    uniforms = [renderer.camera_to_device(cam.uniform(1.0, f, 2), "cpu")
                for f in range(2)]
    state = pipeline.init_state(W, H, "cpu")
    accum = renderer.make_accum(W, H, "cpu")
    guard.on()
    try:
        for f, u in enumerate(uniforms):
            for fc in (f, torch.tensor(f, dtype=torch.int64)):
                pipeline.render_frame(scene, u, fc, state, W, H,
                                      static_ok=f > 0, gb_reuse=True)
                renderer.render_progressive(scene, u, fc, accum, W, H)
    finally:
        guard.off()


def test_tap_batch_frame_makes_no_host_read(scenes, monkeypatch):
    """The batched spatial taps (`tap_batch`) read nothing back either:
    their stream has the shape of the band, whatever the data, so a
    FrameGraph(tap_batch=True) can capture the frame."""
    guard = _NoHostReads()
    for mod, name in ((gbuffer, "scene_trace"), (path_trace, "scene_trace"),
                      (path_trace, "scene_occluded"),
                      (restir, "scene_occluded")):
        monkeypatch.setattr(mod, name, guard.lifted(getattr(mod, name)))
    cam = camera_mod.CameraController()
    state = pipeline.init_state(W, H, "cpu")
    guard.on()
    try:
        for f in range(2):
            u = renderer.camera_to_device(cam.uniform(1.0, f, 2), "cpu")
            state = pipeline.render_frame(
                scenes[1], u, torch.tensor(f, dtype=torch.int64), state, W,
                H, static_ok=f > 0, gb_reuse=True, tap_batch=True)[2]
    finally:
        guard.off()


def _ref_frames(ref, static):
    cam = camera_mod.CameraController()
    state = ref_pipeline.init_state(W, H)
    ldrs, rays = [], []
    for f in range(FRAMES):
        u = ref_renderer.camera_to_device(cam.uniform(1.0, f, ref.num_lights))
        ldr, _, state, aux = ref_pipeline.render_frame(
            ref, u, jnp.uint32(f), state, W, H, static_ok=static(f))
        ldrs.append(np.asarray(ldr))
        rays.append(float(aux["rays"]))
    return ldrs, rays


def test_gb_reuse_matches_reference(scenes, trace_env):
    """tests/test_dedup.py::test_gb_reuse_matches_compute on the port:
    with gb_reuse the static frames unpack last frame's G-buffer, match
    the compute-always frames and count W * H fewer rays; and they match
    the reference's frames under TPU_RT_GB_REUSE=1."""
    ref, port = scenes
    reuse = _frames(port, range(FRAMES), False, gb_reuse=True)
    base = _frames(port, range(FRAMES), False)
    n_primary = W * H
    assert float(reuse[0][1]) == float(base[0][1])
    for f in range(FRAMES):
        assert np.abs(reuse[f][0][0].numpy()
                      - base[f][0][0].numpy()).max() <= REUSE_ATOL, f
        if f:
            assert float(reuse[f][1]) == float(base[f][1]) - n_primary
    trace_env.setenv("TPU_RT_GB_REUSE", "1")
    ref_ldrs, ref_rays = _ref_frames(ref, lambda f: f > 0)
    for f in range(FRAMES):
        assert psnr(reuse[f][0][0].numpy(), ref_ldrs[f]) >= FLOOR_DB, f
        assert abs(float(reuse[f][1]) - ref_rays[f]) \
            <= RAYS_RTOL * ref_rays[f]


def test_bands_reuse_their_own_rows(scenes):
    """--tiles with gb_reuse: each band unpacks its own G-buffer rows, so
    two CPU bands give the one-device reuse frames and rays."""
    port = scenes[1]
    mesh = tiles.make_mesh(["cpu"] * 2)
    tiled = tiles.make_render_frame_tiled(mesh, W, H)

    def banded(scene, u, fc, state, w, h, static_ok, gb_reuse):
        if not isinstance(state, list):
            state = tiles.shard_state(state, mesh)
        ldr, hdr, state, aux = tiled(scene, u, fc, state, static_ok,
                                     gb_reuse=gb_reuse)
        return ldr, hdr, tiles.gather_state(state), aux

    got = _frames(port, range(FRAMES), False, gb_reuse=True, render=banded)
    want = _frames(port, range(FRAMES), False, gb_reuse=True)
    for (g, g_rays), (w, w_rays) in zip(got, want):
        for a, b in zip(g, w):
            assert np.array_equal(_bits(a), _bits(b))
        assert float(g_rays) == float(w_rays)


def _app_rays(monkeypatch, module, run, argv):
    """interactive.run of one package, with each frame's rays recorded
    from its pipeline.render_frame."""
    rays = []
    orig = module.render_frame

    def spy(*args, **kwargs):
        out = orig(*args, **kwargs)
        rays.append(float(out[3]["rays"]))
        return out
    monkeypatch.setattr(module, "render_frame", spy)
    run(argv)
    monkeypatch.setattr(module, "render_frame", orig)
    return rays


def test_app_reuses_the_gbuffer(tmp_path, monkeypatch, trace_env):
    """`python -m tpu_raytracer_torch --device cpu` reuses the G-buffer as
    `python -m tpu_raytracer` does (TPU_RT_GB_REUSE=1): the static frames
    after the first count W * H fewer rays than the eager frames that
    trace it, and the reference app's frames count the same rays."""
    argv = ["--scene", "cornell_diffuse", f"--scale={W}x{H}",
            "--max-frames", str(FRAMES), "--no-preview", "--out-dir",
            str(tmp_path)]
    got = _app_rays(monkeypatch, pipeline,
                    lambda a: interactive.run(parse_args(a + ["--device",
                                                              "cpu"])), argv)
    scene = interactive.load_scene("cornell_diffuse", "cpu")
    base = [float(r) for _, r in _frames(scene, range(FRAMES), False)]
    assert len(got) == FRAMES and got[0] == base[0]
    assert got[1:] == [b - W * H for b in base[1:]]
    trace_env.setenv("TPU_RT_GB_REUSE", "1")
    want = _app_rays(monkeypatch, ref_pipeline,
                     lambda a: ref_interactive.run(ref_parse_args(a)), argv)
    assert len(want) == FRAMES
    for g, w in zip(got, want):
        assert abs(g - w) <= RAYS_RTOL * w, (got, want)
    assert all(w < b for w, b in zip(want[1:], base[1:]))


def test_frame_graph_refuses_the_cpu(scenes):
    """A FrameGraph captures CUDA graphs only: on the CPU it raises, and
    nothing falls back to an eager frame."""
    with pytest.raises(ValueError, match="not a CUDA device"):
        graph_mod.FrameGraph(scenes[1], W, H, "cpu")
    with pytest.raises(ValueError, match="not a CUDA device"):
        graph_mod.FrameGraph(scenes[1], W, H, "cpu", progressive=True)
    with pytest.raises(ValueError, match="not a CUDA device"):
        graph_mod.FrameGraph(scenes[1], W, H, "cpu", tap_batch=True)


def test_captured_launches_count_on_replay():
    """Launches recorded under capture are kept apart and counted when
    the graph replays, in LAUNCHES and in a band thread's own counts."""
    trace_api.reset_launch_counts()
    with trace_api.captured_launches() as captured:
        trace_api.count_launch("closest_hit")
        trace_api.count_launch("table_gather")
        trace_api.count_launch("table_gather")
    assert not any(trace_api.LAUNCHES.values())
    assert captured["closest_hit"] == 1 and captured["table_gather"] == 2
    with trace_api.thread_launches() as own:
        for _ in range(3):
            trace_api.add_launches(captured)
        trace_api.count_launch("any_hit")
    assert own == trace_api.LAUNCHES
    assert (trace_api.LAUNCHES["closest_hit"],
            trace_api.LAUNCHES["table_gather"],
            trace_api.LAUNCHES["any_hit"]) == (3, 6, 1)
    trace_api.reset_launch_counts()
