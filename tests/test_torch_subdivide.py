"""`SceneBuilder.build(subdivide_max_diag=)` against the reference's
(`tpu_raytracer/scene/builder.py:255-265, 300-303, 404-452`): world
triangles larger than a fraction of the scene's diagonal split by
longest-edge bisection before the BVH order is taken.

The reference's catalog builds take no such argument, so its
`SceneBuilder.build` is wrapped here to pass it; nothing in the JAX
package changes. Tolerances, each with its measured value:
  - the subdivided Cornell box's tables: EXACTLY equal to the
    reference's (the BVH-DFS order sets every triangle id), and to
    `convert.scene_from_reference` of the reference's scene;
  - one 32^2 frame of the subdivided box against the reference's:
    PSNR >= FLOOR_DB (measured 107.69 dB; the floor is the measured
    value less a margin, as tests/test_torch_graph.py sets its own,
    since one flipped path costs tens of dB), rays within RAYS_RTOL
    (measured equal). The split box has 2,840 triangles in 2,944 slots
    (23 chunks) against the unsplit 1,320 in 11.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_raytracer.models import scenes as ref_scenes
from tpu_raytracer.render import camera as camera_mod
from tpu_raytracer.render import pipeline as ref_pipeline
from tpu_raytracer.render import renderer as ref_renderer
from tpu_raytracer.scene import builder as ref_builder
from tpu_raytracer.utils.image import psnr
from tpu_raytracer_torch import convert
from tpu_raytracer_torch.models import scenes
from tpu_raytracer_torch.ops import trace_api, trace_mxu
from tpu_raytracer_torch.render import pipeline, renderer

MAX_DIAG = 0.1
FLOOR_DB = 100.0      # measured 107.69 dB
RAYS_RTOL = 0.01
W = H = 32
TABLES = ["tri_planes", "chunk_aabb", "tri_table", "tri_table_local",
          "tri_inst", "tri_prim", "tri_local", "local_v0", "local_e1",
          "local_e2", "bvh_rec", "bvh_skip", "bvh_tri", "bvh_tri_rows",
          "mat_table", "light_table"]

torch.set_num_threads(1)


def _ref_subdivided(monkeypatch, build_scene, **kw):
    """A reference catalog scene built with subdivide_max_diag."""
    orig = ref_builder.SceneBuilder.build
    monkeypatch.setattr(
        ref_builder.SceneBuilder, "build",
        lambda self, *a, **k: orig(self, *a, subdivide_max_diag=MAX_DIAG,
                                   **k))
    try:
        return build_scene(**kw)
    finally:
        monkeypatch.setattr(ref_builder.SceneBuilder, "build", orig)


@pytest.fixture(scope="module")
def built():
    with pytest.MonkeyPatch.context() as mp:
        ref = jax.tree_util.tree_map(
            np.asarray, _ref_subdivided(mp, ref_scenes.create_cornell_box))
    return ref, scenes.create_cornell_box("cpu", subdivide_max_diag=MAX_DIAG)


def test_subdivision_splits_the_box(built):
    """The walls and floor split; every triangle ends inside the limit."""
    ref, port = built
    n = int(port.tri_planes[3, 0].sum())
    assert n == int(np.asarray(ref.tri_planes)[3, 0].sum()) > 1320
    assert port.tri_inst.shape[0] == n
    # each world triangle keeps its own object-space copy (tri_local is
    # arange(n) before the BVH order is taken)
    assert torch.equal(port.tri_local.sort().values,
                       torch.arange(n, dtype=torch.int32))
    assert port.local_v0.shape == (n, 3)
    world = port.tri_table[:n, 26:35].reshape(n, 3, 3)
    p = torch.stack([world[:, 0], world[:, 0] + world[:, 1],
                     world[:, 0] + world[:, 2]], 1)
    lo, hi = p.amin((0, 1)), p.amax((0, 1))
    diag = (p.amax(1) - p.amin(1)).norm(dim=-1)
    assert float(diag.max()) <= MAX_DIAG * float((hi - lo).norm()) * 1.0001


@pytest.mark.parametrize("name", TABLES)
def test_table_equals_reference(built, name):
    ref, port = built
    want = np.asarray(getattr(ref, name))
    got = getattr(port, name).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


def test_convert_carries_the_subdivided_scene(built):
    ref, port = built
    got = convert.scene_from_reference(ref, "cpu")
    for name in TABLES:
        a, b = getattr(got, name), getattr(port, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name


def test_unsplit_build_is_unchanged():
    """Without the argument, and with a limit no triangle reaches, the
    build is the plain one."""
    plain = scenes.create_cornell_box("cpu")
    loose = scenes.create_cornell_box("cpu", subdivide_max_diag=10.0)
    for name in ("tri_planes", "chunk_aabb", "tri_table", "bvh_rec"):
        assert torch.equal(getattr(plain, name), getattr(loose, name)), name
    assert plain.tri_planes.shape == (4, 3, 1408)


def test_instanced_build_refuses(monkeypatch):
    """The reference's refusal (builder.py:300-303): subdivision is a
    flattened-mode culling aid."""
    with pytest.raises(ValueError, match="flattened-mode culling aid"):
        scenes.create_instancing_gallery_scene(
            "cpu", n=2, subdiv=1, subdivide_max_diag=MAX_DIAG)
    with pytest.raises(ValueError, match="flattened-mode culling aid"):
        _ref_subdivided(monkeypatch, ref_scenes.create_instancing_gallery_scene,
                        n=2, subdiv=1)


def test_k6_table_and_cap_see_the_split_slots():
    """K6's coefficient table and the cap read the subdivided scene's
    slots, as any other scene's: under mxu3 the table covers them, and a
    cap at the unsplit box's 1,408 slots walks the split box only."""
    split = scenes.create_cornell_box("cpu", kernel="mxu3",
                                      subdivide_max_diag=MAX_DIAG)
    tp = split.tri_planes.shape[2]
    assert tp > 1408
    assert torch.equal(split.coef48_t,
                       trace_mxu.kernel_table(split.tri_planes))
    plain = scenes.create_cornell_box("cpu", kernel="mxu3", brute_max=1408)
    capped = scenes.create_cornell_box("cpu", kernel="mxu3", brute_max=1408,
                                       subdivide_max_diag=MAX_DIAG)
    assert plain.coef48_t is not None and capped.coef48_t is None
    for s, route in ((plain, "mxu"), (capped, "bvh")):
        assert trace_api.trace_route(s.kernel, s.incull,
                                     s.tri_planes.shape[2], False,
                                     s.brute_max)[0] == route


def test_frame_matches_reference(built, monkeypatch):
    """One 32^2 ReSTIR frame of the subdivided box, port against the
    reference."""
    ref, port = built
    with pytest.MonkeyPatch.context() as mp:
        ref_scene = _ref_subdivided(mp, ref_scenes.create_cornell_box)
    cam = camera_mod.CameraController()
    u = cam.uniform(1.0, 0, port.num_lights)
    want, _, _, want_aux = ref_pipeline.render_frame(
        ref_scene, ref_renderer.camera_to_device(u), jnp.uint32(0),
        ref_pipeline.init_state(W, H), W, H)
    got, _, _, aux = pipeline.render_frame(
        port, renderer.camera_to_device(u, "cpu"), 0,
        pipeline.init_state(W, H, "cpu"), W, H)
    p = psnr(got.numpy(), np.asarray(want, np.float32))
    assert p >= FLOOR_DB, f"PSNR {p:.2f} dB"
    assert abs(float(aux["rays"]) - float(want_aux["rays"])) \
        <= RAYS_RTOL * float(want_aux["rays"])
