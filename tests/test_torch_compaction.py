"""The ray-stream permutations (`ops/compaction.py`) and the `reorder`
argument of the port's queries, path traces and ReSTIR ctx against the
reference (`tpu_raytracer/ops/compaction.py`, `trace_api.scene_trace(
reorder=)`, `restir.make_ctx(reorder=)`).

Tolerances, each with its measured value:
  - src, dest and n_live: equal to the reference's, word for word;
  - scene_trace under "none", "live" and "bins": t and tri bit-equal to
    the reference's CPU answer (its exact scan `_trace_brute_xla`) on the
    default route and on `vpu`, and to the port's own "none" answer on
    `mxu3` (the bf16 route; against the reference's interpret-mode kernel
    it keeps test_torch_kernel_modes.py's tolerance);
  - the instanced route (K4) and the walk (K8) take no permutation;
  - 32^2 ReSTIR frames: word-equal across the three modes; against the
    reference's render_band with the same ctx, PSNR >= FLOOR_DB, the
    port's CPU floor (measured 106.45 dB on frame 1, 109.41 on frame 2,
    in each mode: the reference's CPU route takes no permutation).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_raytracer.models import scenes as ref_scenes
from tpu_raytracer.ops import compaction as ref_compaction
from tpu_raytracer.ops import pallas_trace
from tpu_raytracer.ops import restir as ref_restir
from tpu_raytracer.ops import trace_api as ref_trace_api
from tpu_raytracer.parallel import views as ref_views
from tpu_raytracer.render import camera as camera_mod
from tpu_raytracer.render import pipeline as ref_pipeline
from tpu_raytracer.render import renderer as ref_renderer
from tpu_raytracer.utils.image import psnr
from tpu_raytracer_torch import convert
from tpu_raytracer_torch.models import scenes
from tpu_raytracer_torch.ops import compaction, restir, trace_api, trace_mxu
from tpu_raytracer_torch.parallel import views
from tpu_raytracer_torch.render import pipeline, renderer
from tpu_raytracer_torch.utils.vec3 import V3

FLOOR_DB = 49.0
W = H = 32
FRAMES = 2
MODES = ("none", "live", "bins")

torch.set_num_threads(1)


def _i32(x):
    return np.asarray(x).astype(np.int64)


# ---------------------------------------------------------------------------
# the permutations against the reference's
# ---------------------------------------------------------------------------

def _live_masks():
    rng = np.random.default_rng(0)
    yield "513-30pct", rng.random(513) < 0.3     # tests/test_compaction.py
    yield "dead", np.zeros(256, bool)
    yield "live", np.ones(256, bool)
    yield "r1-live", np.ones(1, bool)
    yield "r1-dead", np.zeros(1, bool)
    yield "r300", np.random.default_rng(5).random(300) < 0.5


LIVE = dict(_live_masks())


@pytest.mark.parametrize("case", list(LIVE))
def test_partition_live_matches_reference(case):
    live = LIVE[case]
    want = ref_compaction.partition_live(jnp.asarray(live))
    got = compaction.partition_live(torch.from_numpy(live))
    assert got[2].dim() == 0 and got[2].dtype == torch.int32
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), _i32(w))


def _bin_keys():
    rng = np.random.default_rng(1)
    yield "700-9bins", rng.integers(0, 9, 700)   # tests/test_compaction.py
    yield "one-bin", np.full(200, 4)
    yield "r1", np.array([8])
    yield "r300", np.random.default_rng(6).integers(0, 9, 300)
    yield "sorted", np.repeat(np.arange(9), 40)
    yield "reversed", np.repeat(np.arange(9)[::-1], 40)


KEYS = dict(_bin_keys())


@pytest.mark.parametrize("case", list(KEYS))
def test_partition_bins_matches_reference(case):
    key = KEYS[case].astype(np.int32)
    want = ref_compaction.partition_bins(jnp.asarray(key), 9)
    got = compaction.partition_bins(torch.from_numpy(key), 9)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), _i32(w))


@pytest.mark.parametrize("live_share", [0.0, 0.6, 1.0])
@pytest.mark.parametrize("r", [1, 300, 700])
def test_direction_bins_match_reference(r, live_share):
    rng = np.random.default_rng(r)
    d = rng.standard_normal((r, 3)).astype(np.float32)
    d[rng.random((r, 3)) < 0.05] = 0.0          # an axis exactly at 0
    live = rng.random(r) < live_share
    key, nb = ref_compaction.direction_bins(jnp.asarray(d), jnp.asarray(live))
    got, got_nb = compaction.direction_bins(
        tuple(torch.from_numpy(d.T.copy())), torch.from_numpy(live))
    assert got_nb == nb == 9
    np.testing.assert_array_equal(got.numpy(), _i32(key))
    src, dest = ref_compaction.partition_bins(key, nb)
    g_src, g_dest = compaction.partition_bins(got, got_nb)
    np.testing.assert_array_equal(g_src.numpy(), _i32(src))
    np.testing.assert_array_equal(g_dest.numpy(), _i32(dest))


def test_permutation_round_trips():
    rng = np.random.default_rng(3)
    t_max = torch.from_numpy(np.where(rng.random(513) < 0.4, 2.0, 0.0)
                             .astype(np.float32))
    d = tuple(torch.from_numpy(rng.standard_normal((3, 513))
                               .astype(np.float32)))
    x = torch.arange(513) * 7 + 3
    for mode in ("live", "bins"):
        src, dest = compaction.permutation(mode, d, t_max)
        assert torch.equal(x[src][dest], x)
        live = (t_max > 0)[src]
        n = int(live.sum())
        assert live[:n].all() and not live[n:].any()
    with pytest.raises(ValueError, match="reorder"):
        compaction.permutation("none", d, t_max)


# ---------------------------------------------------------------------------
# scene_trace(reorder=) on the reference test's set-up
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def soup():
    """tests/test_compaction.py:49-75: 300 random triangles, 700 rays,
    60% active, the window (1e-3, 50)."""
    rng = np.random.default_rng(2)
    t = 300
    v0 = rng.standard_normal((t, 3)).astype(np.float32) * 2
    e1 = rng.standard_normal((t, 3)).astype(np.float32)
    e2 = rng.standard_normal((t, 3)).astype(np.float32)
    planes, aabb, _ = pallas_trace.pack_triangles(v0, e1, e2)
    r = 700
    ro = rng.standard_normal((r, 3)).astype(np.float32) * 3
    rd = rng.standard_normal((r, 3)).astype(np.float32)
    rd = np.asarray(jnp.asarray(rd) / jnp.linalg.norm(
        jnp.asarray(rd), axis=-1, keepdims=True))
    active = rng.random(r) < 0.6
    want = ref_trace_api._trace_brute_xla(
        jnp.asarray(planes), jnp.asarray(ro), jnp.asarray(rd), 1e-3, 50.0,
        active=jnp.asarray(active))
    return planes, aabb, ro, rd, active, {k: np.asarray(v)
                                          for k, v in want.items()}


def _scene(planes, aabb, kernel="mxuf2", incull=False):
    p = torch.from_numpy(planes)
    return types.SimpleNamespace(
        instanced=False, kernel=kernel, incull=incull, tri_planes=p,
        chunk_aabb=torch.from_numpy(aabb),
        coef48_t=trace_mxu.mode_table(p, kernel, incull),
        brute_max=trace_api.BRUTE_FORCE_MAX_TRIS)


def _query(scene, soup, reorder, any_hit):
    _, _, ro, rd, active, _ = soup
    o = V3(*torch.from_numpy(ro.T.copy()))
    d = V3(*torch.from_numpy(rd.T.copy()))
    if any_hit:
        blocked = trace_api.scene_occluded(
            scene, o, d, 1e-3, 50.0, active=torch.from_numpy(active),
            reorder=reorder)
        return {"blocked": blocked.numpy()}
    res = trace_api.scene_trace(scene, o, d, 1e-3, 50.0,
                                active=torch.from_numpy(active),
                                reorder=reorder)
    return {k: v.numpy() for k, v in res.items()}


def _assert_bits(got, want):
    assert got.keys() == want.keys()
    for k in want:
        a, b = np.ascontiguousarray(got[k]), np.ascontiguousarray(want[k])
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8),
                                      err_msg=k)


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("kernel", ["mxuf2", "vpu"])
@pytest.mark.parametrize("reorder", MODES)
def test_scene_trace_equals_reference(soup, reorder, kernel, any_hit):
    """The default route (K1/K2's plain version) and vpu (K5's): t and
    tri bit-equal to the reference's exact scan in every mode."""
    planes, aabb, *_, want = soup
    got = _query(_scene(planes, aabb, kernel), soup, reorder, any_hit)
    if any_hit:
        np.testing.assert_array_equal(got["blocked"], want["tri"] >= 0)
        return
    assert 0.1 < (got["tri"] >= 0).mean() < 0.9
    _assert_bits(got, want)


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("reorder", ["live", "bins"])
def test_mxu3_permuted_equals_unpermuted(soup, reorder, any_hit):
    """mxu3 (K6's plain version over each lane's own chunks): every
    permuted answer bit-equal to the answer in order."""
    planes, aabb, *_ = soup
    scene = _scene(planes, aabb, "mxu3")
    assert trace_api.trace_route("mxu3", False, planes.shape[2], False,
                                 permuted=True)[0] == "mxu"
    _assert_bits(_query(scene, soup, reorder, any_hit),
                 _query(scene, soup, "none", any_hit))


def test_mxu3_permuted_meets_reference(soup):
    """mxu3 under "bins" against the reference's interpret-mode kernel
    under "bins", with test_torch_kernel_modes.py's bf16 tolerance."""
    planes, aabb, ro, rd, active, _ = soup
    ref = pallas_trace.trace_brute_pallas(
        jnp.asarray(planes), jnp.asarray(aabb), jnp.asarray(ro),
        jnp.asarray(rd), 1e-3, 50.0, active=jnp.asarray(active),
        reorder="bins", kernel="mxu3")
    rt, ref_t = np.asarray(ref["tri"]), np.asarray(ref["t"])
    got = _query(_scene(planes, aabb, "mxu3"), soup, "bins", False)
    gt, got_t = got["tri"], got["t"]
    assert ((rt >= 0) == (gt >= 0)).mean() > 0.999
    both = (rt >= 0) & (gt >= 0)
    assert (rt[both] == gt[both]).mean() > 0.999
    same = both & (rt == gt)
    rel = np.abs(got_t[same] - ref_t[same]) / np.maximum(ref_t[same], 1e-6)
    assert np.median(rel) < 1e-4, np.median(rel)


@pytest.mark.parametrize("reorder", ["live", "bins"])
def test_incull_not_taken_while_permuted(soup, reorder):
    """A scene built with the in-kernel cull takes the default route while
    a permutation is set, as the reference skips its cull when `dest` is
    set: its answers are the exact scan's, which the cull's bf16 products
    are not."""
    planes, aabb, *_, want = soup
    tp = planes.shape[2]
    assert trace_api.trace_route("mxuf2", True, tp, False)[0] == "incull"
    for any_hit in (False, True):
        assert trace_api.trace_route("mxuf2", True, tp, any_hit,
                                     permuted=True)[0] == "swept"
    scene = _scene(planes, aabb, "mxuf2", incull=True)
    incull = _query(scene, soup, "none", False)
    permuted = _query(scene, soup, reorder, False)
    _assert_bits(permuted, want)
    assert not np.array_equal(incull["t"].view(np.int32),
                              want["t"].view(np.int32))


def test_unknown_reorder_raises(soup):
    planes, aabb, *_ = soup
    with pytest.raises(ValueError, match="reorder"):
        _query(_scene(planes, aabb), soup, "octant", False)
    with pytest.raises(ValueError, match="reorder"):
        restir.make_ctx(W, H, "cpu", reorder="octant")


def test_permutation_makes_no_host_read(soup, monkeypatch):
    """The permutation and its restore read nothing back to the host, so
    a captured frame can hold them (the CPU plain route under it does,
    and runs with the reads allowed)."""
    names = ("__bool__", "__int__", "__float__", "__index__", "item",
             "tolist")
    saved = {n: getattr(torch.Tensor, n) for n in names}

    def forbid(name):
        def f(self, *args, **kwargs):
            raise AssertionError(f"host read: Tensor.{name}")
        return f

    route = trace_api._route

    def lifted(*args, **kwargs):
        for n, f in saved.items():
            setattr(torch.Tensor, n, f)
        try:
            return route(*args, **kwargs)
        finally:
            for n in names:
                setattr(torch.Tensor, n, forbid(n))

    monkeypatch.setattr(trace_api, "_route", lifted)
    planes, aabb, *_, want = soup
    scene = _scene(planes, aabb)
    for n in names:
        setattr(torch.Tensor, n, forbid(n))
    try:
        got = {m: _query(scene, soup, m, False) for m in ("live", "bins")}
    finally:
        for n, f in saved.items():
            setattr(torch.Tensor, n, f)
    for g in got.values():
        _assert_bits(g, want)


# ---------------------------------------------------------------------------
# routes that take no permutation: the instanced kernel (K4), the walk (K8)
# ---------------------------------------------------------------------------

def _no_permutation(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a route the reference leaves in order was "
                             "permuted")
    monkeypatch.setattr(compaction, "permutation", refuse)


def _cornell_rays(n, seed):
    rng = np.random.default_rng(seed)
    o = torch.from_numpy(rng.uniform(-0.9, 0.9, (3, n)).astype(np.float32))
    d = torch.from_numpy(rng.standard_normal((3, n)).astype(np.float32))
    d = d / d.norm(dim=0, keepdim=True)
    active = torch.from_numpy(rng.random(n) < 0.7)
    return V3(*o), V3(*d), active


@pytest.mark.parametrize("what", ["instanced", "walk"])
def test_k4_and_k8_routes_ignore_reorder(monkeypatch, what):
    if what == "instanced":
        scene = scenes.create_instancing_gallery_scene("cpu", n=9, subdiv=1)
    else:
        scene = scenes.create_cornell_box("cpu", brute_max=1)
        assert trace_api.trace_route(scene.kernel, scene.incull,
                                     scene.tri_planes.shape[2], False,
                                     scene.brute_max, permuted=True)[0] \
            == "bvh"
    o, d, active = _cornell_rays(300, 9)
    want = {a: trace_api.scene_trace(scene, o, d, 1e-3, 5.0, any_hit=a,
                                     active=active) for a in (False, True)}
    _no_permutation(monkeypatch)
    for reorder in ("live", "bins"):
        for a in (False, True):
            got = trace_api.scene_trace(scene, o, d, 1e-3, 5.0, any_hit=a,
                                        active=active, reorder=reorder)
            _assert_bits({k: v.numpy() for k, v in got.items()},
                         {k: v.numpy() for k, v in want[a].items()})


# ---------------------------------------------------------------------------
# the ReSTIR frame with make_ctx(reorder=)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cornell():
    ref = ref_scenes.create_cornell_box()
    port = convert.scene_from_reference(
        jax.tree_util.tree_map(np.asarray, ref), "cpu")
    return ref, port


def _port_frames(scene, reorder):
    cam = camera_mod.CameraController()
    ctx = restir.make_ctx(W, H, "cpu", reorder=reorder)
    state = pipeline.init_state(W, H, "cpu")
    out = []
    for f in range(FRAMES):
        u = renderer.camera_to_device(cam.uniform(1.0, f, scene.num_lights),
                                      "cpu")
        ldr, hdr, state, aux = pipeline.render_band(
            scene, u, f, state, ctx,
            lambda flat: views.trivial_view(flat, W, H), static_ok=f > 0)
        out.append([ldr, hdr, *state.values(), aux["rays"]])
    return out


def _ref_frames(scene, reorder):
    cam = camera_mod.CameraController()
    ctx = ref_restir.make_ctx(W, H, reorder=reorder)
    state = ref_pipeline.init_state(W, H)
    step = jax.jit(lambda s, u, fc, st, ok: ref_pipeline.render_band(
        s, u, fc, st, ctx, lambda flat: ref_views.trivial_view(flat, W, H),
        static_ok=ok), static_argnames="ok")
    out = []
    for f in range(FRAMES):
        u = ref_renderer.camera_to_device(cam.uniform(1.0, f,
                                                      scene.num_lights))
        ldr, _, state, _ = step(scene, u, jnp.uint32(f), state, f > 0)
        out.append(np.asarray(ldr, np.float32))
    return out


@pytest.fixture(scope="module")
def frames(cornell):
    return {m: _port_frames(cornell[1], m) for m in MODES}


@pytest.mark.parametrize("reorder", ["live", "bins"])
def test_frames_equal_across_modes(frames, reorder):
    for got, want in zip(frames[reorder], frames["none"]):
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            if a.dtype == torch.float32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            assert torch.equal(a, b)


@pytest.mark.parametrize("reorder", MODES)
def test_frames_meet_reference(cornell, frames, reorder):
    want = _ref_frames(cornell[0], reorder)
    for f, (got, w) in enumerate(zip(frames[reorder], want)):
        db = psnr(got[0].numpy(), w)
        assert db >= FLOOR_DB, (f, db)


def test_ctx_carries_reorder():
    assert restir.make_ctx(W, H, "cpu")["reorder"] == "none"
    assert restir.make_ctx(W, H, "cpu", reorder="bins")["reorder"] == "bins"
