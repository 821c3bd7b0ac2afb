"""The port's instanced scenes against the reference's: build, plain trace,
hit reconstruction, G-buffer and frame (kernel K4's CPU twin and the
gallery path of `models/scenes.py:create_instancing_gallery_scene`).

Tolerances, each with its measured value:
  - the instanced build: every table EXACTLY equal (object tri ids and
    the tie order depend on the padded layout and the unit order);
  - `trace_instanced_plain` against `_trace_instanced_xla`: tri and inst
    equal on every lane, t within T_ULPS = 0 ulps (measured 0: the plain
    version writes the transform's and the test's fused multiply-adds
    explicitly, as XLA:CPU fuses them);
  - instanced against flattened in the port: hit flags equal, t within
    FLAT_T_ATOL (the two differ by the rounding of the world transform);
  - reconstruct_hit, against the reference run op by op: pos, normal,
    ffnormal, uv, tangent and t within HIT_ATOL (measured 0), mat_id and
    front equal;
  - G-buffer, against the jitted reference: valid and mat_id equal, the
    rest within GB_ATOL (measured max 9.5e-7: XLA:CPU fuses products the
    port rounds separately);
  - 3 frames at 32^2: PSNR >= FRAME_DB (measured 148.7 dB for the
    9-sphere gallery; ROADMAP's starting floor was 38 dB, raised to the
    measured value less a wide margin, since one flipped path costs
    tens of dB).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_raytracer.models import scenes as ref_scenes
from tpu_raytracer.ops import gbuffer as ref_gbuffer
from tpu_raytracer.ops import hit as ref_hit
from tpu_raytracer.ops import pallas_trace
from tpu_raytracer.ops import trace_api as ref_trace
from tpu_raytracer.render import camera as camera_mod
from tpu_raytracer.render import pipeline as ref_pipeline
from tpu_raytracer.render import renderer as ref_renderer
from tpu_raytracer.scene import builder as ref_builder
from tpu_raytracer.scene import geometry as ref_geometry
from tpu_raytracer.scene import material as ref_material
from tpu_raytracer.utils import math3d as ref_math3d
from tpu_raytracer.utils import vec3 as ref_vec3
from tpu_raytracer.utils.image import psnr
from tpu_raytracer_torch import convert
from tpu_raytracer_torch.models import scenes
from tpu_raytracer_torch.ops import gbuffer, hit, trace_api, trace_inst
from tpu_raytracer_torch.render import pipeline, renderer
from tpu_raytracer_torch.scene import builder, geometry, material
from tpu_raytracer_torch.utils import math3d
from tpu_raytracer_torch.utils.vec3 import V3

T_ULPS = 0
FLAT_T_ATOL = 1e-4
HIT_ATOL = 1e-5
GB_ATOL = 1e-5
FRAME_DB = 100.0
FRAMES = 3

TABLES = ["tri_planes", "tri_table", "obj_group_aabb", "inst_group_span",
          "inst_table", "inst_aabb", "unit_inst", "unit_group", "mat_table",
          "light_table"]

# The tests run in several worker processes at once: one torch thread each
# keeps them from oversubscribing the cores.
torch.set_num_threads(1)


def _make_builder(sb, geo, mat, m3):
    """tests/test_instancing.py:_make_builder, written once for either
    package's SceneBuilder, geometry, material and math3d modules."""
    b = sb.SceneBuilder()
    plane = b.add_mesh(geo.create_plane())
    cube = b.add_mesh(geo.create_cube())
    sph = b.add_mesh(geo.create_sphere(2))
    mw = b.add_material(mat.Material((0.7, 0.7, 0.7, 1.0)))
    mr = b.add_material(mat.Material((0.6, 0.2, 0.2, 1.0)).roughness(0.4))
    b.add_instance(plane, mw, m3.translation([0, -1, 0]) @ m3.scale(2.0))
    b.add_instance(plane, mw, m3.translation([0, 1, 0])
                   @ m3.rotation_x(np.pi) @ m3.scale(2.0))
    b.add_instance(cube, mr, m3.translation([-0.3, -0.5, 0])
                   @ m3.rotation_y(0.4) @ m3.scale(0.4))
    b.add_instance(cube, mw, m3.translation([0.5, -0.6, 0.2])
                   @ m3.scale(0.3))
    b.add_instance(sph, mr, m3.translation([0, 0, 0.5]) @ m3.scale(0.25))
    b.register_quad_light(
        plane, m3.translation([0, 0.99, 0]) @ m3.rotation_x(np.pi)
        @ m3.scale(0.5), [1.0, 1.0, 1.0], 10.0)
    return b


def _ref_builder():
    return _make_builder(ref_builder, ref_geometry, ref_material,
                         ref_math3d)


def _port_builder():
    return _make_builder(builder, geometry, material, math3d)


def _numpy(scene):
    return jax.tree_util.tree_map(np.asarray, scene)


@pytest.fixture(scope="module")
def small():
    """The reference's and the port's instanced build of the small scene,
    and the port's flattened build."""
    return (_numpy(_ref_builder().build(instancing="on")),
            _port_builder().build("cpu", instancing="on"),
            _port_builder().build("cpu", instancing="off"))


@pytest.fixture(scope="module")
def gallery():
    """The full-width gallery (bench.py config 7) in both packages."""
    return (_numpy(ref_scenes.create_instancing_gallery_scene()),
            scenes.create_instancing_gallery_scene("cpu"))


@pytest.fixture(scope="module")
def mini_gallery():
    """The gallery cut to 9 spheres of subdivision 2, for frames."""
    ref = ref_scenes.create_instancing_gallery_scene(n=9, subdiv=2)
    return ref, convert.scene_from_reference(_numpy(ref), "cpu")


def _v3(a):
    return V3(*torch.from_numpy(np.array(a, np.float32)).unbind(1))


def _ulps(a, b):
    return np.abs(np.asarray(a).view(np.int32).astype(np.int64)
                  - np.asarray(b).view(np.int32).astype(np.int64))


def _rays(n, seed, lo, hi, t_hi):
    """Seeded rays with origins in the box [lo, hi]^3, random t_max and
    30% dead lanes."""
    g = np.random.default_rng(seed)
    o = g.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = g.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = g.uniform(0.01, t_hi, n).astype(np.float32)
    active = g.uniform(size=n) > 0.3
    return o, d, t_max, active


def _reference_trace(ref, o, d, t_max, active):
    want = jax.jit(pallas_trace._trace_instanced_xla)(
        ref.tri_planes, ref.unit_inst, ref.unit_group, ref.inst_affine_inv,
        jnp.asarray(o), jnp.asarray(d), 1e-3, jnp.asarray(t_max),
        active=jnp.asarray(active))
    return {k: np.asarray(v) for k, v in want.items()}


def _port_trace(port, o, d, t_max, active, any_hit=False):
    return trace_api.scene_trace(port, _v3(o), _v3(d), 1e-3,
                                 torch.from_numpy(t_max), any_hit=any_hit,
                                 active=torch.from_numpy(active))


def _assert_same_hits(got, want):
    assert got["tri"].dtype == got["inst"].dtype == torch.int32
    assert np.array_equal(got["tri"].numpy(), want["tri"])
    assert np.array_equal(got["inst"].numpy(), want["inst"])
    assert _ulps(got["t"].numpy(), want["t"]).max() <= T_ULPS


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", TABLES)
@pytest.mark.parametrize("which", ["small", "gallery"])
def test_instanced_table_equals_reference(request, which, name):
    ref, port = request.getfixturevalue(which)[:2]
    want = np.asarray(getattr(ref, name))
    got = getattr(port, name).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


def test_gallery_counts(gallery):
    ref, port = gallery
    assert port.instanced and ref.instanced
    assert port.num_instances == ref.num_instances == 102
    assert port.num_triangles == ref.num_triangles == 512004
    assert port.tri_planes.shape == (4, 3, 5376)           # 21 groups of 256
    assert port.obj_group_aabb.shape == (8, 21)
    assert port.unit_inst.shape == (2002,)
    assert port.num_lights == 1


def test_flattened_scene_has_empty_instanced_fields(small):
    _, _, flat = small
    assert not flat.instanced and flat.num_instances == 6
    assert flat.inst_table.shape == (0, trace_inst.INST_COLS)
    assert flat.obj_group_aabb.shape == (8, 0)
    assert flat.inst_group_span.shape == (2, 0)
    assert flat.unit_inst.numel() == flat.unit_group.numel() == 0


def test_pack_triangles_instanced_matches_reference():
    g = np.random.default_rng(7)
    meshes = [tuple(g.standard_normal((t, 3)).astype(np.float32)
                    for _ in range(3)) for t in (5, 256, 300)]
    want = pallas_trace.pack_triangles_instanced(meshes)
    got = trace_inst.pack_triangles_instanced(meshes)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_instancing_auto_rule():
    """auto instances exactly when flattening passes the swept path's
    cap while the unique meshes fit the instanced cap (the reference's
    rule, builder.py:298-300)."""
    def build(n_inst, mode):
        b = builder.SceneBuilder()
        sph = b.add_mesh(geometry.create_sphere(4))
        mw = b.add_material(material.Material((0.7, 0.7, 0.7, 1.0)))
        for k in range(n_inst):
            b.add_instance(sph, mw, math3d.translation([k * 2.0, 0, 0]))
        return b.build("cpu", instancing=mode)

    n_big = builder.BRUTE_FORCE_MAX_TRIS // 5120 + 2
    assert build(n_big, "auto").instanced
    assert not build(3, "auto").instanced
    assert build(3, "on").instanced
    with pytest.raises(ValueError):
        build(1, "sometimes")


def test_convert_carries_instanced_scene(small):
    ref, port, _ = small
    got = convert.scene_from_reference(ref, "cpu")
    assert got.instanced and got.num_instances == port.num_instances
    for name in TABLES + ["color_tex", "data_tex"]:
        a, b = getattr(got, name), getattr(port, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name


# ---------------------------------------------------------------------------
# trace
# ---------------------------------------------------------------------------

def test_plain_trace_matches_reference_small(small):
    ref, port, _ = small
    o, d, t_max, active = _rays(4000, 1, -0.95, 0.95, 3.0)
    got = _port_trace(port, o, d, t_max, active)
    _assert_same_hits(got, _reference_trace(ref, o, d, t_max, active))
    assert (got["tri"] >= 0).float().mean() > 0.15
    dead = ~torch.from_numpy(active)
    assert (got["tri"][dead] == -1).all() and (got["inst"][dead] == -1).all()
    assert (got["t"][dead] == trace_api.INF).all()


def test_plain_trace_matches_reference_gallery(gallery):
    """One full-width trace: the reference scan costs seconds per call."""
    ref, port = gallery
    o, d, t_max, active = _rays(512, 2, -7.0, 7.0, 20.0)
    o[:, 1] = np.clip(o[:, 1], -1.2, 3.0)
    got = _port_trace(port, o, d, t_max, active)
    _assert_same_hits(got, _reference_trace(ref, o, d, t_max, active))
    assert (got["inst"] >= 2).any()                    # spheres were hit


def test_occlusion_matches_reference(small):
    ref, port, _ = small
    o, d, t_max, active = _rays(4000, 3, -0.95, 0.95, 1.5)
    want = ref_trace.scene_occluded(
        jax.tree_util.tree_map(jnp.asarray, ref), jnp.asarray(o),
        jnp.asarray(d), 1e-3, jnp.asarray(t_max), active=jnp.asarray(active))
    got = trace_api.scene_occluded(port, _v3(o), _v3(d), 1e-3,
                                   torch.from_numpy(t_max),
                                   active=torch.from_numpy(active))
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_instanced_matches_flattened(small):
    """As tests/test_instancing.py:68-90 holds the reference."""
    _, inst, flat = small
    o, d, _, _ = _rays(4000, 4, -0.9, 0.9, 1.0)
    o[:, 1] = 0.8
    live = np.ones(len(o), bool)
    far = np.full(len(o), 3.0e38, np.float32)
    ri = _port_trace(inst, o, d, far, live)
    rf = _port_trace(flat, o, d, far, live)
    hit_i, hit_f = ri["tri"] >= 0, rf["tri"] >= 0
    assert torch.equal(hit_i, hit_f) and hit_f.any()
    assert (ri["t"] - rf["t"])[hit_f].abs().max() < FLAT_T_ATOL
    near = np.full(len(o), 1.5, np.float32)
    assert torch.equal(_port_trace(inst, o, d, near, live, True)["tri"] >= 0,
                       _port_trace(flat, o, d, near, live, True)["tri"] >= 0)


def test_exact_t_tie_goes_to_earlier_instance():
    """Two instances of one mesh at one place: every hit is an exact-t
    tie, which the earlier instance wins, as in the reference's scan."""
    def build(sb, geo, mat, m3, port):
        b = sb.SceneBuilder()
        plane = b.add_mesh(geo.create_plane())
        mw = b.add_material(mat.Material((0.7, 0.7, 0.7, 1.0)))
        for _ in range(2):
            b.add_instance(plane, mw, m3.scale(2.0))
        return (b.build("cpu", instancing="on") if port
                else _numpy(b.build(instancing="on")))

    ref = build(ref_builder, ref_geometry, ref_material, ref_math3d, False)
    port = build(builder, geometry, material, math3d, True)
    o = np.array([[0.1, 1.0, 0.2], [-0.5, 2.0, 0.3], [0.0, 1.0, 0.0]],
                 np.float32)
    d = np.array([[0, -1, 0], [0.1, -1, 0], [0, 1, 0]], np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.full(3, 10.0, np.float32)
    live = np.ones(3, bool)
    got = _port_trace(port, o, d, t_max, live)
    assert got["inst"].tolist() == [0, 0, -1]
    _assert_same_hits(got, _reference_trace(ref, o, d, t_max, live))


def test_cpu_tensors_never_launch_kernels(small):
    _, port, _ = small
    trace_api.reset_launch_counts()
    o, d, t_max, active = _rays(256, 5, -0.9, 0.9, 2.0)
    _port_trace(port, o, d, t_max, active)
    trace_api.scene_occluded(port, _v3(o), _v3(d), 1e-3,
                             torch.from_numpy(t_max))
    assert set(trace_api.LAUNCHES.values()) == {0}


def test_kernel_wrapper_refuses_cpu_tensors(small):
    """K4's wrapper never falls back: a CPU tensor raises before any
    build or launch."""
    _, port, _ = small
    o = torch.zeros((3, 8))
    with pytest.raises(ValueError):
        trace_inst.trace_instanced_kernel(
            port.tri_planes, port.obj_group_aabb, port.inst_table,
            port.inst_aabb, port.inst_group_span, o, o, torch.zeros(8),
            torch.ones(8))


# ---------------------------------------------------------------------------
# hits, G-buffer, frame
# ---------------------------------------------------------------------------

def _flat(val):
    if isinstance(val, (V3, ref_vec3.V3)):
        return np.stack([np.asarray(c) for c in val], -1)
    if isinstance(val, tuple):
        return np.stack([np.asarray(c) for c in val], -1)
    return np.asarray(val)


def test_reconstruct_hit_matches_reference(small):
    ref, port, _ = small
    o, d, _, _ = _rays(3000, 6, -0.9, 0.9, 1.0)
    o[:, 1] = 0.8
    live = np.ones(len(o), bool)
    far = np.full(len(o), 3.0e38, np.float32)
    res = _reference_trace(ref, o, d, far, live)
    want = ref_hit.reconstruct_hit(
        ref, jnp.asarray(res["tri"]), ref_vec3.of(jnp.asarray(o)),
        ref_vec3.of(jnp.asarray(d)), jnp.asarray(res["t"]),
        inst_id=jnp.asarray(res["inst"]))
    got = hit.reconstruct_hit(
        port, torch.from_numpy(res["tri"]), _v3(o), _v3(d),
        torch.from_numpy(res["t"]), inst_id=torch.from_numpy(res["inst"]))
    m = res["tri"] >= 0
    assert m.mean() > 0.3
    for key in ("pos", "normal", "ffnormal", "uv", "tangent", "t"):
        diff = np.abs(_flat(got[key]) - _flat(want[key]))[m]
        assert diff.max() < HIT_ATOL, (key, diff.max())
    for key in ("mat_id", "front"):
        assert np.array_equal(_flat(got[key])[m], _flat(want[key])[m]), key


def _camera(scene):
    return camera_mod.CameraController().uniform(1.0, 0, scene.num_lights)


def test_gbuffer_matches_reference(mini_gallery):
    ref, port = mini_gallery
    cam = _camera(ref)
    want = jax.jit(ref_gbuffer.render_gbuffer, static_argnums=(2, 3))(
        ref, ref_renderer.camera_to_device(cam), 32, 32)
    got = gbuffer.render_gbuffer(port, renderer.camera_to_device(cam, "cpu"),
                                 32, 32)
    assert np.array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    assert np.array_equal(got["mat_id"].numpy(), np.asarray(want["mat_id"]))
    assert len(np.unique(got["mat_id"].numpy())) > 3    # floor + spheres
    for k in ("pos", "oct_normal", "uv", "albedo", "motion"):
        diff = np.abs(got[k].numpy() - np.asarray(want[k])).max()
        assert diff < GB_ATOL, (k, diff)


def test_frames_match_reference(mini_gallery):
    """FRAMES full ReSTIR frames at 32^2 through both packages."""
    ref, port = mini_gallery
    w = h = 32
    cam = camera_mod.CameraController()
    r_state = ref_pipeline.init_state(w, h)
    p_state = pipeline.init_state(w, h, "cpu")
    for f in range(FRAMES):
        u = cam.uniform(1.0, f, ref.num_lights)
        r_ldr, _, r_state, r_aux = ref_pipeline.render_frame(
            ref, ref_renderer.camera_to_device(u), jnp.uint32(f), r_state,
            w, h)
        p_ldr, p_hdr, p_state, p_aux = pipeline.render_frame(
            port, renderer.camera_to_device(u, "cpu"), f, p_state, w, h)
    got = p_ldr.numpy()
    assert got.shape == (w * h, 3) and np.isfinite(got).all()
    assert np.isfinite(p_hdr.numpy()).all()
    assert abs(float(p_aux["rays"]) - float(r_aux["rays"])) \
        <= 0.01 * float(r_aux["rays"])
    p = psnr(got, np.asarray(r_ldr, np.float32))
    assert p >= FRAME_DB, f"PSNR vs reference = {p:.2f} dB"
