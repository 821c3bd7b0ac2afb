"""The PyTorch port's Cornell build against the JAX reference's, table by
table, and the package's import boundary.

Every table must be EXACTLY equal: the BVH-DFS triangle order sets the
chunk layout and every triangle id, so any difference would shift every
downstream comparison.
"""

import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from tpu_raytracer.models import scenes as ref_scenes
from tpu_raytracer.ops import pallas_trace
from tpu_raytracer_torch import convert
from tpu_raytracer_torch.models import scenes
from tpu_raytracer_torch.ops import trace_api

TABLES = ["tri_planes", "chunk_aabb", "tri_table", "mat_table",
          "light_table", "bvh_rec", "bvh_skip", "bvh_tri"]


@pytest.fixture(scope="module")
def built():
    ref = jax.tree_util.tree_map(np.asarray, ref_scenes.create_cornell_box())
    return ref, scenes.create_cornell_box("cpu")


def _np(x):
    return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()


@pytest.mark.parametrize("name", TABLES)
def test_table_equals_reference(built, name):
    ref, port = built
    want = np.asarray(getattr(ref, name))
    got = getattr(port, name).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("group", ["materials", "lights"])
def test_soa_tables_equal_reference(built, group):
    ref, port = built
    want, got = getattr(ref, group), getattr(port, group)
    assert sorted(want) == sorted(got)
    for k in want:
        assert got[k].numpy().dtype == np.asarray(want[k]).dtype, k
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k


@pytest.mark.parametrize("name", ["color_tex", "data_tex"])
def test_textures_equal_reference_bf16(built, name):
    """The port keeps [L, H, W, 3] bf16 texels; the reference's 12-wide
    quad rows start with the same texel."""
    ref, port = built
    got = getattr(port, name)
    assert got.dtype == torch.bfloat16
    want = np.asarray(getattr(ref, name))[..., :3].astype(np.float32)
    assert np.array_equal(_np(got), want)


def test_cornell_shape_and_metadata(built):
    ref, port = built
    assert port.tri_planes.shape == (4, 3, 1408)       # 11 chunks of 128
    assert int(port.tri_planes[3, 0].sum()) == 1320
    assert port.num_lights == ref.num_lights == 2
    assert port.tex_channels == ref.tex_channels == frozenset({"color"})


def test_pack_triangles_matches_reference():
    rng = np.random.default_rng(7)
    v0, e1, e2 = (rng.standard_normal((300, 3)).astype(np.float32)
                  for _ in range(3))
    want_planes, want_aabb, _ = pallas_trace.pack_triangles(v0, e1, e2)
    got_planes, got_aabb = trace_api.pack_triangles(v0, e1, e2)
    assert np.array_equal(got_planes, want_planes)
    assert np.array_equal(got_aabb, want_aabb)


def test_convert_carries_the_reference_scene(built):
    """convert.py takes the reference's scene (as numpy) to tensors equal
    to the port's own build, field by field."""
    ref, port = built
    got = convert.scene_from_reference(ref, "cpu")
    for name in TABLES + ["color_tex", "data_tex"]:
        a, b = getattr(got, name), getattr(port, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name
    for group in ("materials", "lights"):
        for k, v in getattr(port, group).items():
            assert torch.equal(getattr(got, group)[k], v), (group, k)
    assert got.num_lights == port.num_lights
    assert got.tex_channels == port.tex_channels


def test_state_round_trips_through_convert():
    rng = np.random.default_rng(3)
    state = {"gb": rng.standard_normal((16, 14)).astype(np.float32),
             "res": rng.integers(0, 2 ** 32, (16, 12), dtype=np.uint64)
             .astype(np.uint32).view(np.float32),   # arbitrary bit patterns
             "accum": rng.standard_normal((16, 3)).astype(np.float32)}
    back = convert.state_to_numpy(convert.state_from_reference(state, "cpu"))
    for k in state:
        assert np.array_equal(back[k].view(np.uint32),
                              state[k].view(np.uint32)), k


def test_import_leaves_jax_out():
    code = ("import sys, tpu_raytracer_torch.render.pipeline, "
            "tpu_raytracer_torch.models.scenes, tpu_raytracer_torch.convert, "
            "tpu_raytracer_torch.ops.table_gather, "
            "tpu_raytracer_torch.app.screenshot, "
            "tpu_raytracer_torch.utils.image, "
            "tpu_raytracer_torch.ops.refit, tpu_raytracer_torch.ops.lbvh, "
            "tpu_raytracer_torch.app.interactive, "
            "tpu_raytracer_torch.app.preview, "
            "tpu_raytracer_torch.render.checkpoint, "
            "tpu_raytracer_torch.render.graph, "
            "tpu_raytracer_torch.utils.config, "
            "tpu_raytracer_torch.utils.profiling, "
            "tpu_raytracer_torch.utils.resample, "
            "tpu_raytracer_torch.models.glb_writer, "
            "tpu_raytracer_torch.models.procedural_assets, "
            "tpu_raytracer_torch.ops.intersect, "
            "tpu_raytracer_torch.ops.traversal, "
            "tpu_raytracer_torch.ops.compaction, "
            "tpu_raytracer_torch.utils.jpeg, "
            "tpu_raytracer_torch.parallel.tiles, "
            "tpu_raytracer_torch.parallel.views, "
            "tpu_raytracer_torch.scene.loader, "
            "tpu_raytracer_torch.__main__;"
            " bad = [m for m in sys.modules if m in ('jax', 'PIL') or "
            "m.startswith(('jax.', 'PIL.', 'tpu_raytracer.'))"
            " or m == 'tpu_raytracer'];"
            " assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_environment_read_in_one_place():
    """The package reads the reference app's TPU_RT_* knobs in
    utils/config.py alone (the scene build and the frame take them as
    arguments); besides, only the kernel build reads CUDA_HOME
    (ops/trace_api.py:_nvcc, through load_kernels)."""
    import ast
    import os

    import tpu_raytracer_torch

    root = os.path.dirname(tpu_raytracer_torch.__file__)
    reads = []
    for folder, _, files in os.walk(root):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(folder, name)
            rel = os.path.relpath(path, root)
            with open(path) as f:
                tree = ast.parse(f.read())
            funcs = [n for n in ast.walk(tree)
                     if isinstance(n, (ast.FunctionDef,
                                       ast.AsyncFunctionDef))]
            for node in ast.walk(tree):
                if (isinstance(node, ast.Attribute)
                        and node.attr in ("environ", "getenv", "putenv")) \
                        or (isinstance(node, ast.Name)
                            and node.id in ("environ", "getenv")):
                    owner = [fn.name for fn in funcs
                             if fn.lineno <= node.lineno <= fn.end_lineno]
                    reads.append((rel, owner[-1] if owner else None))
    allowed = {("utils/config.py", "env_knobs"), ("ops/trace_api.py", "_nvcc")}
    assert reads and set(reads) <= allowed, reads
