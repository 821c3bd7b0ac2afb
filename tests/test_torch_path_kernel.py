"""K9, the path tracer's shading (`csrc/path_trace.cu`), built with g++
under the host emulation `csrc/host/emulation/cuda_runtime.h`, driven
through one `trace_path` call (`path_trace.run_k9`: its 9 launches with
the plain trace between them) and held to `trace_path_plain` on the CPU.

The libm is taken out of the comparison: K9 is built with
-DTPURT_EMU_ROUNDED_LIBM (sinf and cosf rounded from double) and the
plain version runs under torch.sin, torch.cos and torch.sqrt rounded from
double the same way. Every output is then equal word for word, which
holds K9's f32 arithmetic, operation order, constants, RNG draws and zero
terms to the eager version's exactly. On the card K9 meets PyTorch's CUDA
kernels, which round as its own sqrtf, sinf and cosf do; chip_smoke.py
holds it to the eager route there.
"""

import contextlib
from unittest import mock

import numpy as np
import pytest
import torch

from test_torch_kernel_emulation import _build
from tpu_raytracer_torch.models import scenes
from tpu_raytracer_torch.ops import gbuffer, path_trace
from tpu_raytracer_torch.render import camera, renderer
from tpu_raytracer_torch.scene.builder import SceneBuilder
from tpu_raytracer_torch.scene.geometry import create_plane, create_sphere
from tpu_raytracer_torch.scene.material import Material
from tpu_raytracer_torch.utils import rng
from tpu_raytracer_torch.utils.math3d import rotation_x, scale, translation

SIZE = 32               # 32 x 32 lanes a case
LAUNCHES = ["path_prime"] + ["path_bounce"] * 7 + ["path_finish"]
CASES = ("cornell", "textured", "instanced", "no_lights", "masked",
         "glass_primary")

# The tests run in several worker processes at once: one torch thread each
# keeps them from oversubscribing the cores.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return _build(tmp_path_factory.mktemp("k9_rounded"), ("path_trace",),
                  defines=("TPURT_EMU_ROUNDED_LIBM",))


def _rounded(fn):
    return lambda x: fn(x.double()).float()


@contextlib.contextmanager
def _rounded_libm():
    """torch.sin, cos and sqrt rounded from double, as the rounded build's
    sinf, cosf and (IEEE) sqrtf give them."""
    with mock.patch.object(torch, "sin", _rounded(torch.sin)), \
            mock.patch.object(torch, "cos", _rounded(torch.cos)), \
            mock.patch.object(torch, "sqrt", _rounded(torch.sqrt)):
        yield


def _image(g):
    """A smooth 1024^2 uint8 image: a uv difference of ulps moves a texel
    by ulps, not onto an unrelated one."""
    yy, xx = np.meshgrid(np.linspace(0, 1, 1024), np.linspace(0, 1, 1024),
                         indexing="ij")
    f, ph = g.uniform(1, 4, (3, 2)), g.uniform(0, 2 * np.pi, 3)
    return np.stack([127.5 * (1 + np.sin(2 * np.pi * (f[c, 0] * xx
                                                      + f[c, 1] * yy) + ph[c]))
                     for c in range(3)], -1).astype(np.uint8)


def _small_scene(kind):
    """A floor and a ball under a quad light: "textured" puts all five
    texture channels on the floor; "no_lights" too, and drops the light
    (its quad stays as an emissive surface; the floor's emissive texture
    lights the paths); "glass_primary" makes the ball a large glass sphere
    in front of the camera."""
    b = SceneBuilder()
    plane, sphere = b.add_mesh(create_plane()), b.add_mesh(create_sphere(1))
    floor = Material((0.7, 0.7, 0.7, 1.0)).roughness(0.6)
    if kind in ("textured", "no_lights"):
        g = np.random.default_rng(11)
        floor = (floor.texture(b.add_color_texture(_image(g)))
                 .normal_texture(b.add_data_texture(_image(g)))
                 .occlusion_texture(b.add_data_texture(_image(g)))
                 .emissive_texture(b.add_color_texture(_image(g)))
                 .metallic_roughness_texture(b.add_data_texture(_image(g))))
    ball = Material((0.8, 0.5, 0.3, 1.0)).roughness(0.3)
    ball_at = translation([0, -0.5, 0]) @ scale(0.8)
    if kind == "glass_primary":
        ball = Material((0.9, 0.95, 1.0, 1.0)).glass(1.5)
        ball_at = translation([0, 0.2, 1.2]) @ scale(2.0)
    b.add_instance(plane, b.add_material(floor),
                   translation([0, -1, 0]) @ scale(3.0))
    b.add_instance(sphere, b.add_material(ball), ball_at)
    light_at = translation([0, 1.5, 0]) @ rotation_x(np.pi) @ scale(1.0)
    if kind == "no_lights":
        b.add_instance(plane, b.add_material(
            Material((1.0, 1.0, 1.0, 1.0)).emissive([4.0, 4.0, 4.0])),
            light_at)
    else:
        b.register_quad_light(plane, light_at, [1.0, 1.0, 1.0], 8.0)
    return b.build("cpu")


def _case(name):
    """(scene, gb, view_pos, seed, active) of a case, on the CPU."""
    if name in ("cornell", "masked"):
        scene = scenes.create_cornell_box("cpu")
    elif name == "instanced":
        scene = scenes.create_instancing_gallery_scene("cpu", n=9, subdiv=2)
    else:
        scene = _small_scene(name)
    cam = camera.CameraController(
        position=np.array([0.0, 0.5, 3.0], np.float32), pitch=-0.35) \
        if name in ("textured", "no_lights", "instanced") \
        else camera.CameraController()
    uniform = renderer.camera_to_device(
        cam.uniform(1.0, 0, scene.num_lights), "cpu")
    gb = gbuffer.render_gbuffer(scene, uniform, SIZE, SIZE)
    lanes = torch.arange(SIZE * SIZE, dtype=torch.int64)
    seed = rng.pcg_hash(lanes * 7919 + 2 ** 31 + 12345)
    active = None
    if name == "masked":
        active = torch.from_numpy(
            np.random.default_rng(5).uniform(size=SIZE * SIZE) < 0.6)
    return scene, gb, uniform["view_pos"][:3], seed, active


def _check_case(name, scene, gb, active):
    """The case holds what it is there for."""
    mat = scene.mat_table[gb["mat_id"].long()]
    if name == "textured":
        assert scene.tex_channels == frozenset(path_trace.TEX_BITS)
    if name == "instanced":
        assert scene.instanced
    if name == "no_lights":
        assert scene.num_lights == 0
    if name == "masked":
        assert (active & gb["valid"]).any() and (~active & gb["valid"]).any()
    if name == "glass_primary":
        assert (gb["valid"] & (mat[:, 9] > 0.01)).float().mean() > 0.3
    assert gb["valid"].float().mean() > 0.5


def _run(lib, scene, gb, view_pos, seed, active):
    names = []
    got = path_trace.run_k9(lib, None, names.append, scene, gb, view_pos,
                            seed, active, "none")
    assert names == LAUNCHES
    return got


@pytest.mark.parametrize("case", CASES)
def test_k9_against_plain(lib, case):
    scene, gb, view_pos, seed, active = _case(case)
    _check_case(case, scene, gb, active)

    with _rounded_libm():
        want = path_trace.trace_path_plain(scene, gb, view_pos, seed, active)
        got = _run(lib, scene, gb, view_pos, seed, active)
    assert set(got) == set(want)
    for k in want:
        a, b = got[k], want[k]
        if a.dtype == torch.float32:
            assert torch.isfinite(b).all(), (case, k)
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), (case, k, (a != b).sum())
    assert float(want["rays"]) > 0 and want["valid_v1"].any()
