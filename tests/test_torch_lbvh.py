"""The port's linear BVH (ops/lbvh.py) against the reference's, and
mirrors of tests/test_lbvh.py.

Every comparison with the reference is EXACT: Morton codes are integer
arithmetic on the same f32 quantization, the sorts are stable on both
sides (so tie-heavy inputs order alike), and the Karras tree and its
boxes are integer searches and min/max.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_raytracer.models import scenes as ref_scenes
from tpu_raytracer.ops import lbvh as ref_lbvh
from tpu_raytracer_torch import convert
from tpu_raytracer_torch.models import scenes
from tpu_raytracer_torch.ops import lbvh, trace_api
from tpu_raytracer_torch.utils.vec3 import V3

torch.set_num_threads(1)


def _tris(n, seed=0, cells=None):
    """n random triangle boxes; with `cells`, centroids snapped to a grid
    of that many cells an axis, so Morton codes tie in bulk."""
    r = np.random.default_rng(seed)
    v0 = (r.random((n, 3), np.float32) - 0.5) * 4
    if cells:
        v0 = np.round(v0 * cells / 4) * 4 / cells
    e1 = r.random((n, 3), np.float32) - 0.5
    e2 = r.random((n, 3), np.float32) - 0.5
    if cells:
        e1, e2 = e1 * 0.0 + 0.01, -e1 * 0.0 - 0.01
    v0 = v0.astype(np.float32)
    v1, v2 = v0 + e1, v0 + e2
    return (np.minimum(np.minimum(v0, v1), v2).astype(np.float32),
            np.maximum(np.maximum(v0, v1), v2).astype(np.float32))


# one size, so the reference's eager ops compile once
CASES = {"random": dict(n=300, seed=5), "ties": dict(n=300, seed=6, cells=3),
         "dense_ties": dict(n=300, seed=7, cells=1)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_morton_codes_and_order_equal_reference(case):
    mn, mx = _tris(**CASES[case])
    c = (mn + mx) * 0.5
    want = np.asarray(ref_lbvh.morton_codes(
        jnp.asarray(c), jnp.asarray(mn.min(0)), jnp.asarray(mx.max(0))))
    got = lbvh.morton_codes(torch.from_numpy(c), torch.from_numpy(mn.min(0)),
                            torch.from_numpy(mx.max(0)))
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    if case != "random":
        assert len(np.unique(want)) < len(want) // 2     # tie-heavy
    assert np.array_equal(torch.argsort(got, stable=True).numpy(),
                          np.asarray(jnp.argsort(jnp.asarray(want))))


@pytest.mark.parametrize("case", sorted(CASES))
def test_build_lbvh_equals_reference(case):
    mn, mx = _tris(**CASES[case])
    want = jax.tree_util.tree_map(np.asarray, ref_lbvh.build_lbvh(
        jnp.asarray(mn), jnp.asarray(mx)))
    got = lbvh.build_lbvh(torch.from_numpy(mn), torch.from_numpy(mx))
    for k in ("order", "left", "right", "node_min", "node_max"):
        assert np.array_equal(got[k].numpy(), want[k]), k
        assert got[k].numpy().dtype == want[k].dtype, k


def test_karras_topology_and_aabbs():
    """Mirror of tests/test_lbvh.py: a binary tree over the sorted leaves
    whose node boxes contain their children."""
    t = 300
    mn, mx = _tris(t, seed=5)
    tree = lbvh.build_lbvh(torch.from_numpy(mn), torch.from_numpy(mx))
    left, right = tree["left"].numpy(), tree["right"].numpy()
    counts = np.bincount(np.concatenate([left, right]), minlength=2 * t - 1)
    assert counts[0] == 0 and (counts[1:] == 1).all()
    nmin, nmax = tree["node_min"].numpy(), tree["node_max"].numpy()
    inner = np.arange(t - 1)
    for child in (left, right):
        assert (nmin[inner] <= nmin[child]).all()
        assert (nmax[inner] >= nmax[child]).all()
    assert np.array_equal(nmin[0], mn.min(axis=0))
    assert np.array_equal(nmax[0], mx.max(axis=0))
    assert np.array_equal(np.sort(tree["order"].numpy()), np.arange(t))


@pytest.fixture(scope="module")
def cornell_diffuse():
    ref = ref_scenes.create_cornell_box_diffuse()
    return ref, scenes.create_cornell_box_diffuse("cpu")


def test_morton_reorder_equals_reference(cornell_diffuse):
    """The permutation and every field that follows it, bit for bit."""
    ref, port = cornell_diffuse
    want = jax.tree_util.tree_map(np.asarray, ref_lbvh.morton_reorder(ref))
    got = lbvh.morton_reorder(port)
    for name in ("tri_planes", "chunk_aabb", "tri_table", "tri_table_local",
                 "tri_inst", "tri_prim", "tri_local", "bvh_tri",
                 "bvh_tri_rows"):
        assert np.array_equal(getattr(got, name).numpy(),
                              np.asarray(getattr(want, name))), name
    assert torch.equal(got.tri_table, port.tri_table[lbvh.morton_order(port)])


def test_morton_reorder_preserves_render(cornell_diffuse):
    """Mirror of tests/test_lbvh.py: the reordered scene traces alike and
    its shading rows follow the reorder."""
    ref, port = cornell_diffuse
    scene = convert.scene_from_reference(
        jax.tree_util.tree_map(np.asarray, ref), "cpu")
    reordered = lbvh.morton_reorder(scene)
    r = np.random.default_rng(1)
    o = ((r.random((256, 3), np.float32) - 0.5) * 3).T.copy()
    d = r.normal(size=(256, 3)).astype(np.float32)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).T.copy()
    o, d = V3(*torch.from_numpy(o)), V3(*torch.from_numpy(d))
    a = trace_api.scene_trace(scene, o, d, 1e-3, 100.0)
    b = trace_api.scene_trace(reordered, o, d, 1e-3, 100.0)
    hit = a["tri"].numpy() >= 0
    assert hit.any() and np.array_equal(b["tri"].numpy() >= 0, hit)
    assert np.array_equal(a["t"].numpy()[hit], b["t"].numpy()[hit])
    ta = scene.tri_table[:, 25].numpy().astype(int)
    tb = reordered.tri_table[:, 25].numpy().astype(int)
    assert (ta[a["tri"].numpy()[hit]] == tb[b["tri"].numpy()[hit]]).all()
