"""The port's trace API against the reference's.

On a CPU tensor `scene_trace` runs the plain version of kernel K1 (the
twin of the reference's `_trace_brute_xla`): triangle ids must be equal
on every lane and t within T_ULPS (measured: 0 - the plain version writes
XLA:CPU's fused multiply-adds explicitly). K1's semantics also meet the
reference's TPU kernel `mxuf2` run in Pallas interpret mode, held to the
thresholds tests/test_mxu_kernel.py holds it to against the exact sweep.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_raytracer.models import scenes as ref_scenes
from tpu_raytracer.ops import gbuffer as ref_gbuffer
from tpu_raytracer.ops import pallas_trace
from tpu_raytracer.ops import trace_api as ref_trace
from tpu_raytracer.render import camera as camera_mod
from tpu_raytracer.render import renderer as ref_renderer
from tpu_raytracer_torch import convert
from tpu_raytracer_torch.ops import intersect, trace_api
from tpu_raytracer_torch.utils.vec3 import V3

T_ULPS = 2

# The tests run in several worker processes at once: one torch thread each
# keeps them from oversubscribing the cores.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scenes():
    ref = ref_scenes.create_cornell_box()
    port = convert.scene_from_reference(
        jax.tree_util.tree_map(np.asarray, ref), "cpu")
    return ref, port


def _v3(a):
    return V3(*torch.from_numpy(np.array(a, np.float32)).unbind(1))


def _ulps(a, b):
    return np.abs(np.asarray(a).view(np.int32).astype(np.int64)
                  - np.asarray(b).view(np.int32).astype(np.int64))


def _compare(ref, port, o, d, t_min, t_max, active=None):
    want = jax.jit(ref_trace._trace_brute_xla)(
        ref.tri_planes, jnp.asarray(o), jnp.asarray(d), t_min,
        jnp.asarray(t_max),
        active=None if active is None else jnp.asarray(active))
    got = trace_api.scene_trace(
        port, _v3(o), _v3(d), t_min,
        torch.from_numpy(np.asarray(t_max, np.float32)),
        active=None if active is None else torch.from_numpy(active))
    assert got["tri"].dtype == torch.int32 and got["t"].dtype == torch.float32
    assert np.array_equal(got["tri"].numpy(), np.asarray(want["tri"]))
    assert _ulps(got["t"].numpy(), want["t"]).max() <= T_ULPS
    return got


def _random_rays(n, seed):
    g = np.random.default_rng(seed)
    o = g.uniform(-0.95, 0.95, (n, 3)).astype(np.float32)
    d = g.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = g.uniform(0.01, 3.0, n).astype(np.float32)
    active = g.uniform(size=n) > 0.3       # 30% dead lanes
    return o, d, t_max, active


def test_primary_rays_64_match(scenes):
    ref, port = scenes
    cam = camera_mod.CameraController().uniform(1.0, 0, ref.num_lights)
    o, d = ref_gbuffer.generate_primary_rays(
        ref_renderer.camera_to_device(cam), 64, 64)
    got = _compare(ref, port, np.asarray(o), np.asarray(d), 1e-3,
                   np.full(64 * 64, 1000.0, np.float32))
    assert (got["tri"] >= 0).float().mean() > 0.95


def test_random_rays_dead_lanes_match(scenes):
    ref, port = scenes
    o, d, t_max, active = _random_rays(6000, 1)
    got = _compare(ref, port, o, d, 1e-3, t_max, active)
    assert not (got["tri"].numpy()[~active] >= 0).any()
    assert (got["tri"].numpy()[~active] == -1).all()
    assert (got["t"].numpy()[~active] == trace_api.INF).all()


def test_occlusion_matches_reference(scenes):
    ref, port = scenes
    o, d, t_max, active = _random_rays(6000, 2)
    want = ref_trace.scene_occluded(ref, jnp.asarray(o), jnp.asarray(d),
                                    1e-3, jnp.asarray(t_max),
                                    active=jnp.asarray(active))
    got = trace_api.scene_occluded(port, _v3(o), _v3(d), 1e-3,
                                   torch.from_numpy(t_max),
                                   active=torch.from_numpy(active))
    assert np.array_equal(got.numpy(), np.asarray(want))
    closest = trace_api.scene_trace(port, _v3(o), _v3(d), 1e-3,
                                    torch.from_numpy(t_max),
                                    active=torch.from_numpy(active))
    assert torch.equal(got, closest["tri"] >= 0)


def _soup(seed, t=300):
    g = np.random.default_rng(seed)
    v0 = g.standard_normal((t, 3)).astype(np.float32) * 2
    e1 = g.standard_normal((t, 3)).astype(np.float32)
    e2 = g.standard_normal((t, 3)).astype(np.float32)
    return v0, e1, e2


def _port_planes(v0, e1, e2):
    planes, aabb = trace_api.pack_triangles(v0, e1, e2)
    return torch.from_numpy(planes), torch.from_numpy(aabb)


def test_meets_tpu_kernel_mxuf2_interpret():
    """As test_mxu_kernel.py:24-52 holds mxuf2 to the exact VPU sweep."""
    g = np.random.default_rng(3)
    v0, e1, e2 = _soup(3)
    planes, aabb, _ = pallas_trace.pack_triangles(v0, e1, e2)
    r = 1500
    o = (g.standard_normal((r, 3)) * 3).astype(np.float32)
    d = g.standard_normal((r, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tpu = pallas_trace.trace_brute_pallas(
        jnp.asarray(planes), jnp.asarray(aabb), jnp.asarray(o),
        jnp.asarray(d), 1e-3, 50.0, kernel="mxuf2")
    p_planes, p_aabb = _port_planes(v0, e1, e2)
    got = trace_api.trace_plain(p_planes, p_aabb, _v3(o), _v3(d),
                                torch.full((r,), 1e-3),
                                torch.full((r,), 50.0))
    ref_tri, out_tri = np.asarray(tpu["tri"]), got["tri"].numpy()
    assert ((ref_tri >= 0) == (out_tri >= 0)).mean() > 0.999
    both = (ref_tri >= 0) & (out_tri >= 0)
    assert (ref_tri[both] == out_tri[both]).mean() > 0.999
    same = both & (ref_tri == out_tri)
    t_ref = np.asarray(tpu["t"])[same]
    rel = np.abs(got["t"].numpy()[same] - t_ref) / np.maximum(t_ref, 1e-6)
    assert np.median(rel) < 1e-4 and rel.max() < 3e-2


def test_random_soup_matches_exact_sweep():
    v0, e1, e2 = _soup(4)
    planes, _, _ = pallas_trace.pack_triangles(v0, e1, e2)
    o, d, t_max, active = _random_rays(3000, 5)
    o = o * 4.0
    want = ref_trace._trace_brute_xla(
        jnp.asarray(planes), jnp.asarray(o), jnp.asarray(d), 1e-3,
        jnp.asarray(t_max * 5), active=jnp.asarray(active))
    p_planes, p_aabb = _port_planes(v0, e1, e2)
    got = trace_api.trace_plain(
        p_planes, p_aabb, _v3(o), _v3(d), torch.full((3000,), 1e-3),
        torch.where(torch.from_numpy(active),
                    torch.from_numpy(t_max * 5), 0.0))
    assert np.array_equal(got["tri"].numpy(), np.asarray(want["tri"]))
    assert _ulps(got["t"].numpy(), want["t"]).max() <= T_ULPS


@pytest.mark.parametrize("second", [7, 200])
def test_exact_t_tie_goes_to_lowest_id(second):
    """Two identical triangles (same chunk, or chunks apart): the lower
    id wins, as in the reference (cf. test_mxu_kernel.py:284)."""
    v0 = np.zeros((256, 3), np.float32) + 50.0       # far-away filler
    e1 = np.zeros((256, 3), np.float32)
    e1[:, 0] = 0.01
    e2 = np.zeros((256, 3), np.float32)
    e2[:, 1] = 0.01
    tri = dict(v0=[-1.0, -1.0, 2.0], e1=[2.0, 0.0, 0.0], e2=[0.0, 2.0, 0.0])
    for i in (5, second):
        v0[i], e1[i], e2[i] = tri["v0"], tri["e1"], tri["e2"]
    planes, aabb = _port_planes(v0, e1, e2)
    o = np.zeros((4, 3), np.float32)
    d = np.array([[0, 0, 1], [-0.1, -0.1, 1], [-0.2, 0.1, 1], [0, 0, -1]],
                 np.float32)
    got = trace_api.trace_plain(planes, aabb, _v3(o), _v3(d),
                                torch.full((4,), 1e-3), torch.full((4,), 10.0))
    assert got["tri"].tolist() == [5, 5, 5, -1]
    want = ref_trace._trace_brute_xla(
        jnp.asarray(planes.numpy()), jnp.asarray(o), jnp.asarray(d), 1e-3,
        10.0)
    assert got["tri"].tolist() == np.asarray(want["tri"]).tolist()


def test_cpu_tensors_never_launch_kernels(scenes):
    _, port = scenes
    trace_api.reset_launch_counts()
    o, d, t_max, active = _random_rays(512, 6)
    trace_api.scene_trace(port, _v3(o), _v3(d), 1e-3,
                          torch.from_numpy(t_max))
    trace_api.scene_occluded(port, _v3(o), _v3(d), 1e-3,
                             torch.from_numpy(t_max),
                             active=torch.from_numpy(active))
    assert set(trace_api.LAUNCHES) >= {"closest_hit", "any_hit",
                                       "inst_closest_hit", "inst_any_hit",
                                       "stream_closest_hit",
                                       "stream_any_hit"}
    assert not any(trace_api.LAUNCHES.values()), trace_api.LAUNCHES


def test_kernel_wrapper_refuses_cpu_tensors(scenes):
    """The kernel wrapper never falls back: a CPU tensor raises before
    any build or launch."""
    _, port = scenes
    o = torch.zeros((3, 8))
    with pytest.raises(ValueError):
        trace_api.trace_kernel(port.tri_planes, port.chunk_aabb, o, o,
                               torch.zeros(8), torch.ones(8))


def _midpoint_cases():
    """(a, b, c) whose f64 sum a*b + c lands exactly on an f32 rounding
    midpoint while the exact sum lies 2^-70 below it, so rounding the f64
    sum to f32 (ties to even) goes the wrong way: c's neighbour above is
    even. Signs mirrored, and scaled by powers of two."""
    a, b, c = 1 + 2.0 ** -23, (1 - 2.0 ** -23) * 2.0 ** -24, 1 + 2.0 ** -23
    rows = []
    for k in (-20, 0, 7):
        for sa, sc in ((1, 1), (-1, -1)):
            rows.append((sa * a * 2.0 ** k, b, sc * c * 2.0 ** k))
    return np.array(rows, np.float32)


def test_fma_rounds_once_like_xla():
    """`fma` against XLA:CPU's contraction of a*b + c (the reference's
    arithmetic): the midpoint cases, where one f64 sum rounded to f32 is
    an ulp off, and random triples, all equal bit for bit."""
    rng = np.random.default_rng(11)
    rand = (rng.standard_normal((4096, 3))
            * 2.0 ** rng.integers(-12, 12, (4096, 3))).astype(np.float32)
    abc = np.concatenate([_midpoint_cases(), rand])
    want = np.asarray(jax.jit(lambda a, b, c: a * b + c)(
        *(jnp.asarray(abc[:, i]) for i in range(3))))
    got = intersect.fma(*(torch.from_numpy(abc[:, i].copy())
                          for i in range(3))).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    mid = _midpoint_cases()
    assert np.array_equal(got[:len(mid)], mid[:, 2])     # c, not c's even
    naive = (mid[:, 0].astype(np.float64) * mid[:, 1]
             + mid[:, 2]).astype(np.float32)
    assert not np.array_equal(naive, mid[:, 2])          # the trap is real
