"""The port's trace-kernel modes against the reference's: the worklist
prepass, the feature-matmul coefficient tables, each mode's plain trace,
the route table and the Cornell frame under a mode.

The reference runs its Pallas kernels in interpret mode, as its own tests
do (tests/test_mxu_kernel.py, tests/test_golden.py). Tolerances:
  - worklists, coefficient tables, bf16 splits and features: bit-equal
    (against the reference jitted, which fuses the crosses' and dots'
    first products as the port writes them);
  - `vpu`: tri equal on every lane, t bit-equal to the reference's exact
    scan `_trace_brute_xla`; its interpret-mode `_mt_kernel` contracts
    the test's products otherwise and differs in t by up to a few hundred
    ulps on glancing hits (relative error below 1e-4; measured 204 ulps,
    2.4e-5);
  - `mxu3`, `mxu1`, `mxuw[N]`, the in-kernel cull: the reference's own
    tolerance for its bf16 modes (test_mxu_kernel.py:40-52): hit/miss and
    tri agreement > 0.999, median relative t error < 1e-4 (measured:
    every lane agrees; median 0 to 6.5e-8, max 1.1e-5);
  - frames: `vpu` equals the port's default frame bit for bit; `mxu3` and
    the in-kernel cull meet FRAME_DB against the reference's frame under
    the same mode.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_raytracer.models import scenes as ref_scenes
from tpu_raytracer.ops import pallas_trace
from tpu_raytracer.ops import trace_api as ref_trace_api
from tpu_raytracer.render import camera as camera_mod
from tpu_raytracer.render import pipeline as ref_pipeline
from tpu_raytracer.render import renderer as ref_renderer
from tpu_raytracer.utils.image import psnr
from tpu_raytracer_torch import convert
from tpu_raytracer_torch.models import scenes
from tpu_raytracer_torch.ops import (trace_api, trace_mxu, trace_stream,
                                     trace_vpu, worklist)
from tpu_raytracer_torch.render import pipeline, renderer
from tpu_raytracer_torch.scene.builder import SceneBuilder
from tpu_raytracer_torch.scene.geometry import create_cube
from tpu_raytracer_torch.scene.material import Material
from tpu_raytracer_torch.utils.vec3 import V3

FRAME_DB = 45.0
W = H = 32
FRAMES = 2
INF = trace_api.INF

# The tests run in several worker processes at once: one torch thread each
# keeps them from oversubscribing the cores.
torch.set_num_threads(1)


def _soup(seed, t):
    """The random soup of test_mxu_kernel.py:_scene."""
    rng = np.random.default_rng(seed)
    v0 = rng.standard_normal((t, 3)).astype(np.float32) * 2
    e1 = rng.standard_normal((t, 3)).astype(np.float32)
    e2 = rng.standard_normal((t, 3)).astype(np.float32)
    planes, aabb, _ = pallas_trace.pack_triangles(v0, e1, e2)
    return planes, aabb


def _rays(seed, r, t_lo=0.5, t_hi=8.0):
    """[R, 3] origins and unit directions, t_max uniform in (t_lo, t_hi),
    and an active mask with 30% dead lanes."""
    rng = np.random.default_rng(seed)
    ro = (rng.standard_normal((r, 3)) * 3).astype(np.float32)
    rd = rng.standard_normal((r, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    t_max = rng.uniform(t_lo, t_hi, r).astype(np.float32)
    active = rng.uniform(size=r) > 0.3
    return ro, rd, t_max, active


def _port_rays(ro, rd, t_max, active):
    return (V3(*torch.from_numpy(ro.T.copy())),
            V3(*torch.from_numpy(rd.T.copy())),
            torch.full((ro.shape[0],), 1e-3),
            torch.from_numpy(np.where(active, t_max, 0.0).astype(np.float32)))


# ---------------------------------------------------------------------------
# (a) worklists: ops/worklist.py against _block_entry and its sort
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sorted_soup():
    """A soup sorted along x, so its 24 chunk boxes are thin slabs and
    short windows of rays sorted along x reach few of them: the cull has
    work to do."""
    rng = np.random.default_rng(7)
    t = 3000
    v0 = rng.uniform(-6, 6, (t, 3)).astype(np.float32)
    v0 = v0[np.argsort(v0[:, 0])]
    e1 = (rng.standard_normal((t, 3)) * 0.3).astype(np.float32)
    e2 = (rng.standard_normal((t, 3)) * 0.3).astype(np.float32)
    _, aabb, _ = pallas_trace.pack_triangles(v0, e1, e2)
    return aabb


@pytest.mark.parametrize("padded", [False, True], ids=["boxes", "padded"])
@pytest.mark.parametrize("grp,force_union",
                         [(1, False), (2, False), (2, True), (8, False),
                          (8, True)],
                         ids=["grp1", "grp2", "grp2-union", "grp8",
                              "grp8-union"])
@pytest.mark.parametrize("br", [1024, 128])
def test_worklists_match_block_entry(monkeypatch, sorted_soup, br, grp,
                                     force_union, padded):
    """Entries, counts, unit lists and entry lists bit-equal to
    `_block_entry` and the stable argsort (pallas_trace.py:1326-1397,
    1623-1628) on the chunk boxes, and on the padded boxes the port's
    routes use; random t_max, 30% dead lanes, a ragged last block."""
    monkeypatch.setattr(pallas_trace, "BR", br)
    aabb = sorted_soup
    if padded:
        aabb = worklist.pad_boxes(torch.from_numpy(aabb)).numpy()
    nc = aabb.shape[0]
    r = 1300
    ro, rd, t_max, active = _rays(11, r, 0.01, 1.0)
    ro = ro[np.argsort(ro[:, 0])]     # blocks of nearby rays along x
    o, d, t_min, t_max_t = _port_rays(ro, rd, t_max, active)
    nb = -(-r // br)
    rays = np.zeros((8, nb * br), np.float32)
    rays[0:3, :r], rays[3:6, :r] = ro.T, rd.T
    rays[6, :r], rays[7, :r] = 1e-3, t_max_t.numpy()

    want = np.asarray(pallas_trace._block_entry(
        jnp.asarray(rays), jnp.asarray(aabb), nc, nb, grp,
        force_union=force_union))
    got = worklist.block_entry(o, d, t_min, t_max_t, torch.from_numpy(aabb),
                               nc, br, grp, force_union)
    np.testing.assert_array_equal(got.numpy(), want)
    reached = want < INF
    assert 0.05 < reached.mean() < 0.95       # the cull drops and keeps

    counts, unit_list, entry_list = worklist.worklists(got)
    order = np.argsort(want, axis=1, kind="stable")
    np.testing.assert_array_equal(counts.numpy(), reached.sum(axis=1))
    np.testing.assert_array_equal(unit_list.numpy(), order.T)
    np.testing.assert_array_equal(entry_list.numpy(),
                                  np.take_along_axis(want, order, axis=1).T)


# ---------------------------------------------------------------------------
# (b) coefficient tables, bf16 split and features
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def soup12():
    return _soup(3, 1500)          # 12 chunks


@pytest.mark.parametrize("wide,group", [(False, 8), (True, 8), (True, 4),
                                        (True, 5)],
                         ids=["narrow", "wide8", "wide4", "wide5"])
def test_mt_coef_matches_reference(soup12, wide, group):
    planes, _ = soup12
    want = np.asarray(jax.jit(pallas_trace.mt_coef_device,
                              static_argnums=(1, 2))(jnp.asarray(planes),
                                                     wide, group))
    got = trace_mxu.mt_coef(torch.from_numpy(planes), wide, group).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("group", [1, 2, 5])
def test_mt_coef48_matches_reference(soup12, group):
    planes, _ = soup12
    want = np.asarray(jax.jit(pallas_trace.mt_coef48, static_argnums=(1,))(
        jnp.asarray(planes), group)).astype(np.float32)
    got = trace_mxu.mt_coef48(torch.from_numpy(planes), group)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    if group == 1:
        # K6's fragment layout holds exactly mt_coef48's columns
        np.testing.assert_array_equal(
            trace_mxu.table_columns(trace_mxu.kernel_table(
                torch.from_numpy(planes))).float().numpy(), want.T)


def test_split_bf16_matches_reference():
    """Round to nearest even, ties and zeros included, over 80 binades."""
    rng = np.random.default_rng(5)
    x = (rng.standard_normal(20000)
         * np.exp2(rng.integers(-40, 40, 20000))).astype(np.float32)
    x[:3] = [0.0, -0.0, 1.0 + 2.0 ** -8]       # a tie: rounds to even
    hi, lo = pallas_trace._split_bf16(jnp.asarray(x))
    got_hi, got_lo = trace_mxu.split_bf16(torch.from_numpy(x))
    np.testing.assert_array_equal(got_hi.float().numpy(),
                                  np.asarray(hi).astype(np.float32))
    np.testing.assert_array_equal(got_lo.float().numpy(),
                                  np.asarray(lo).astype(np.float32))


def test_feat48_matches_reference():
    ro, rd, _, _ = _rays(9, 1000)
    want = np.asarray(jax.jit(pallas_trace._feat48_from)(
        *(jnp.asarray(c) for c in (*ro.T, *rd.T)))).astype(np.float32)
    got = trace_mxu.feat48(V3(*torch.from_numpy(ro.T.copy())),
                           V3(*torch.from_numpy(rd.T.copy())))
    np.testing.assert_array_equal(got.float().numpy(), want)


# ---------------------------------------------------------------------------
# (c) each mode's plain trace against trace_brute_pallas(kernel=mode)
# ---------------------------------------------------------------------------

MODES = ["vpu", "mxu3", "mxu1", "mxuw", "mxuw4", "incull"]


@pytest.fixture(scope="module", params=[300, 1500], ids=["3chunks",
                                                          "12chunks"])
def soup(request):
    return _soup(3, request.param)


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("mode", MODES)
def test_mode_matches_reference(trace_env, soup, mode, any_hit):
    planes, aabb = soup
    kernel = "mxuf2" if mode == "incull" else mode
    incull = mode == "incull"
    ro, rd, t_max, active = _rays(13, 1000)
    if incull:
        trace_env.setenv("TPU_RT_INCULL", "1")
    ref = pallas_trace.trace_brute_pallas(
        jnp.asarray(planes), jnp.asarray(aabb), jnp.asarray(ro),
        jnp.asarray(rd), 1e-3, jnp.asarray(t_max), any_hit=any_hit,
        active=jnp.asarray(active), kernel=kernel)
    rt, ref_t = np.asarray(ref["tri"]), np.asarray(ref["t"])

    p = torch.from_numpy(planes)
    scene = types.SimpleNamespace(
        instanced=False, kernel=kernel, incull=incull, tri_planes=p,
        chunk_aabb=torch.from_numpy(aabb),
        coef48_t=trace_mxu.mode_table(p, kernel, incull),
        brute_max=trace_api.BRUTE_FORCE_MAX_TRIS)
    o, d, t_min, t_max_t = _port_rays(ro, rd, t_max, active)
    got = trace_api.scene_trace(scene, o, d, t_min, t_max_t, any_hit=any_hit)
    gt, got_t = got["tri"].numpy(), got["t"].numpy()
    assert not (gt[~active] >= 0).any()
    assert 0.1 < (gt >= 0).mean() < 0.9

    if mode == "vpu":
        # the closest-hit sweep serves both queries
        np.testing.assert_array_equal(gt, rt)
        exact = ref_trace_api._trace_brute_xla(
            jnp.asarray(planes), jnp.asarray(ro), jnp.asarray(rd), 1e-3,
            jnp.asarray(t_max), active=jnp.asarray(active))
        np.testing.assert_array_equal(got_t, np.asarray(exact["t"]))
        hit = rt >= 0
        rel = np.abs(got_t[hit] - ref_t[hit]) / ref_t[hit]
        assert rel.max() < 1e-4, rel.max()
        return
    hit_agree = ((rt >= 0) == (gt >= 0)).mean()
    assert hit_agree > 0.999, hit_agree
    if any_hit:
        return
    both = (rt >= 0) & (gt >= 0)
    assert (rt[both] == gt[both]).mean() > 0.999
    same = both & (rt == gt)
    rel = np.abs(got_t[same] - ref_t[same]) / np.maximum(ref_t[same], 1e-6)
    assert np.median(rel) < 1e-4, np.median(rel)


# ---------------------------------------------------------------------------
# (d) the route table
# ---------------------------------------------------------------------------

CT = trace_api.CT
_F, _W, _M = trace_api.MXUF_MAX_TP, trace_api.MXUW_MAX_TP, \
    trace_api.MXU_MAX_TP
ROUTES = [
    # (kernel, incull, tp, any_hit) -> (route, grp, passes)
    (("mxuf2", False, 11 * CT, False), ("swept", 1, 0)),
    (("mxuf2", False, 11 * CT, True), ("swept", 1, 0)),
    (("mxuv4", False, _F, False), ("swept", 1, 0)),
    (("mxuf2", False, _F + CT, False), ("stream", 1, 0)),
    (("mxuf8", False, _F + CT, True), ("stream", 1, 0)),
    (("mxuf2", True, 11 * CT, False), ("incull", 2, 3)),
    (("mxuf2", True, 11 * CT, True), ("incull", 2, 3)),
    (("mxuf", True, 48 * CT, False), ("incull", 2, 3)),
    (("mxuf4", True, 49 * CT, True), ("incull", 4, 3)),
    (("mxuf2", True, 64 * CT, False), ("incull", 4, 3)),
    (("mxuf2", True, 65 * CT, False), ("swept", 1, 0)),
    (("mxuf2", True, _F + CT, True), ("stream", 1, 0)),
    (("mxuv2", True, 11 * CT, False), ("swept", 1, 0)),
    (("mxu3", True, 11 * CT, False), ("mxu", 1, 3)),
    (("mxu3", False, _M, False), ("mxu", 1, 3)),
    (("mxu3", False, _M + CT, False), ("vpu", 1, 0)),
    (("mxu3", False, 11 * CT, True), ("swept", 1, 0)),
    (("mxu3", False, _F + CT, True), ("stream", 1, 0)),
    (("mxu1", False, 11 * CT, False), ("mxu", 1, 1)),
    (("mxu1", False, _M + CT, False), ("vpu", 1, 0)),
    (("mxuw", False, 11 * CT, False), ("mxu", 8, 3)),
    (("mxuw4", False, _W, False), ("mxu", 4, 3)),
    (("mxuw12", False, 11 * CT, False), ("mxu", 12, 3)),
    (("mxuw", False, _W + CT, False), ("vpu", 1, 0)),
    (("mxuw", False, 11 * CT, True), ("swept", 1, 0)),
    (("vpu", False, 11 * CT, False), ("vpu", 1, 0)),
    (("vpu", True, 11 * CT, True), ("vpu", 1, 0)),
    (("vpu", False, 4 * _F, True), ("vpu", 1, 0)),
]


@pytest.mark.parametrize("args,want", ROUTES,
                         ids=["-".join(map(str, a)) for a, _ in ROUTES])
def test_route_table(args, want):
    assert trace_api.trace_route(*args) == want


@pytest.mark.parametrize("tp", [CT, 11 * CT, _F, _F + CT, 4 * _F])
def test_vpu_capacity_follows_route(tp):
    """K5 takes K1's unit capacity where the default query goes to K1, and
    K3's where it goes to K3."""
    route = trace_api.trace_route("mxuf2", False, tp, False)[0]
    want = {"swept": trace_api.SWEPT_MAX_UNITS,
            "stream": trace_stream.MAX_UNITS}[route]
    assert trace_vpu.vpu_max_units(tp) == want


@pytest.mark.parametrize("kernel", ["mxu2", "mxuw0", "any2", "mxus8", "VPU",
                                    "mxuf2 ", ""])
def test_unknown_mode_raises(kernel):
    with pytest.raises(ValueError):
        trace_api.check_mode(kernel)
    b = SceneBuilder()
    b.add_instance(b.add_mesh(create_cube()),
                   b.add_material(Material((0.5, 0.5, 0.5, 1.0))),
                   np.eye(4, dtype=np.float32))
    with pytest.raises(ValueError):
        b.build("cpu", kernel=kernel)


@pytest.mark.parametrize("kernel,incull,has_table",
                         [("mxuf2", False, False), ("mxuf2", True, True),
                          ("mxu3", False, True), ("mxuw", False, True),
                          ("vpu", False, False)])
def test_scene_carries_mode_and_table(kernel, incull, has_table):
    """The builder stores the mode, and K6's table only for modes whose
    routes read it; convert.py builds the same from a reference scene."""
    scene = scenes.create_cornell_box("cpu", kernel=kernel, incull=incull)
    assert (scene.kernel, scene.incull) == (kernel, incull)
    assert (scene.coef48_t is not None) == has_table
    if has_table:
        assert torch.equal(scene.coef48_t,
                           trace_mxu.kernel_table(scene.tri_planes))
    ref = jax.tree_util.tree_map(np.asarray, ref_scenes.create_cornell_box())
    port = convert.scene_from_reference(ref, "cpu", kernel=kernel,
                                        incull=incull)
    assert (port.kernel, port.incull) == (kernel, incull)
    if has_table:
        assert torch.equal(port.coef48_t, scene.coef48_t)


# ---------------------------------------------------------------------------
# (e) the Cornell frame under a mode
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_cornell():
    return ref_scenes.create_cornell_box()


def _port_frame(ref_cornell, kernel="mxuf2", incull=False):
    scene = convert.scene_from_reference(
        jax.tree_util.tree_map(np.asarray, ref_cornell), "cpu",
        kernel=kernel, incull=incull)
    cam = camera_mod.CameraController()
    state = pipeline.init_state(W, H, "cpu")
    for f in range(FRAMES):
        u = renderer.camera_to_device(cam.uniform(1.0, f, scene.num_lights),
                                      "cpu")
        ldr, hdr, state, _ = pipeline.render_frame(scene, u, f, state, W, H)
    assert torch.isfinite(hdr).all()
    return ldr.numpy()


def _ref_frame(ref_cornell):
    cam = camera_mod.CameraController()
    state = ref_pipeline.init_state(W, H)
    for f in range(FRAMES):
        u = ref_renderer.camera_to_device(
            cam.uniform(1.0, f, ref_cornell.num_lights))
        ldr, _, state, _ = ref_pipeline.render_frame(
            ref_cornell, u, jnp.uint32(f), state, W, H)
    return np.asarray(ldr, np.float32)


def test_vpu_frame_equals_default(ref_cornell):
    np.testing.assert_array_equal(_port_frame(ref_cornell, "vpu"),
                                  _port_frame(ref_cornell))


@pytest.mark.parametrize("mode", ["mxu3", "incull"])
def test_mode_frame_meets_reference(trace_env, monkeypatch, ref_cornell,
                                    mode):
    """The reference renders through its Pallas kernels under the mode
    (TPU_RT_FORCE_PALLAS=1 with KERNEL_MODE patched, as
    tests/test_golden.py:96-112 does)."""
    kernel = "mxuf2" if mode == "incull" else mode
    monkeypatch.setattr(pallas_trace, "KERNEL_MODE", kernel)
    if mode == "incull":
        trace_env.setenv("TPU_RT_INCULL", "1")
    trace_env.setenv("TPU_RT_FORCE_PALLAS", "1")     # also clears caches
    want = _ref_frame(ref_cornell)
    got = _port_frame(ref_cornell, kernel, mode == "incull")
    p = psnr(got, want)
    assert p >= FRAME_DB, f"{mode} frame vs reference: {p:.2f} dB"


@pytest.mark.parametrize("kernel,incull", [("vpu", False), ("mxu3", False),
                                           ("mxuw", False), ("mxuf2", True)])
def test_cpu_modes_never_launch_kernels(kernel, incull):
    """On CPU tensors every mode's route takes its plain version, and the
    kernel wrappers refuse CPU tensors before any build or launch."""
    scene = scenes.create_cornell_box("cpu", kernel=kernel, incull=incull)
    ro, rd, t_max, active = _rays(17, 256, 0.5, 3.0)
    o, d, t_min, t_max_t = _port_rays(ro * 0.3, rd, t_max, active)
    trace_api.reset_launch_counts()
    trace_api.scene_trace(scene, o, d, t_min, t_max_t)
    trace_api.scene_occluded(scene, o, d, t_min, t_max_t)
    assert not any(trace_api.LAUNCHES.values()), trace_api.LAUNCHES
    flat = torch.zeros((3, 8))
    with pytest.raises(ValueError):
        trace_vpu.vpu_kernel(scene.tri_planes, scene.chunk_aabb, flat, flat,
                             torch.zeros(8), torch.ones(8))
    with pytest.raises(ValueError):
        trace_mxu.mxu_kernel(trace_mxu.kernel_table(scene.tri_planes),
                             scene.chunk_aabb, flat, flat, torch.zeros(8),
                             torch.ones(8), 1, 3, False, False)
