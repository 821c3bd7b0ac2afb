"""The benchmark's truffle configuration (`rtbench/configs/truffle.json`,
`rtbench/scenes/truffle.py`) against the app's scene, the benchmark
reference's Lanczos resize against Pillow and the port's, SceneBuilder's
set-up record, and a frame of the small truffle against the benchmark's
reference.

Tolerances: none for the scene and the resize (every table word and
every byte equal); the frame is held to the cell's own limits
(`rtbench/limits/truffle.still_720p.json`).
"""

import dataclasses
import json
import os
import time

import numpy as np
import pytest
import torch
from PIL import Image

from rtbench import cells, run, scenes
from rtbench.reference.resample import resize_lanczos
from rtbench.scenes import port, truffle
from rtbench.tests import cpu_frame
from tpu_raytracer_torch.models import scenes as app_scenes
from tpu_raytracer_torch.models.procedural_assets import write_truffle_glb
from tpu_raytracer_torch.scene.loader import load_gltf
from tpu_raytracer_torch.utils import profiling
from tpu_raytracer_torch.utils.resample import resize_u8

NU, TEX = 24, 32          # the small stand-in (the cell's are 96 and 256)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(2)


def _config():
    with open(os.path.join(ROOT, "rtbench", "configs", "truffle.json")) as f:
        config = json.load(f)
    config.update(asset_nu=NU, texture_size=TEX)
    return config


@pytest.fixture(autouse=True)
def _cache(tmp_path, monkeypatch):
    """The benchmark's asset written under tmp_path."""
    monkeypatch.setattr(truffle, "CACHE_DIR", str(tmp_path / "cache"))


def test_config_matches_the_scene_at_full_size():
    """The configuration's stated counts: 23,258 triangles (the floor's
    2, the asset's 7,896 and three 5,120-triangle spheres), 3 lights, 12
    instances, and no key cut."""
    with open(os.path.join(ROOT, "rtbench", "configs", "truffle.json")) as f:
        config = json.load(f)
    ops = scenes.describe(config).ops
    meshes = [op[1] for op in ops if op[0] == "mesh"]
    assert [m["indices"].size // 3 for m in meshes] == [2, 5120]
    asset = [op[1] for op in ops if op[0] == "gltf"][0]
    prims = truffle.truffle_prims(config["asset_nu"])
    assert sum(p["idx"].size // 3 for p in prims) == 7896
    assert 2 + 7896 + 3 * 5120 == config["triangles"] == 23258
    assert sum(op[0] == "sphere_light" for op in ops) == config["lights"]
    assert 1 + len(prims) + 3 == config["instances"]
    assert asset.texture_size == 256 and config["reduced"] == []


def _assert_same(a, b, name):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), name
        for k in a:
            _assert_same(a[k], b[k], f"{name}.{k}")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), name
    else:
        assert a == b, name


def test_scene_equals_the_apps(tmp_path):
    """port.build of the description equals the app's
    create_chocolate_truffle_scene on the same small stand-in in every
    field: tables, textures, lights, BVH. The app applies
    truffle_material_rewrite to the loaded materials, so this ties the
    factors baked into the benchmark's file to the program's rewrite."""
    device = torch.device("cpu")
    got = port.build(scenes.describe(_config()), device, kernel="mxuf2")
    path = write_truffle_glb(str(tmp_path / "app.glb"), nu=NU, tex_size=TEX)
    want = app_scenes.create_chocolate_truffle_scene(device, path=path,
                                                     kernel="mxuf2")
    for f in dataclasses.fields(got):
        _assert_same(getattr(got, f.name), getattr(want, f.name), f.name)
    rough = sorted(set(got.mat_table[:, 7].tolist()))
    assert np.float32(0.02) in rough and np.float32(0.25) in rough


def test_baked_factors_are_the_rewrite(tmp_path):
    """The benchmark's file holds what truffle_material_rewrite makes of
    the generator's materials, field for field; the meshes and images are
    the generator's."""
    asset = [op[1] for op in scenes.describe(_config()).ops
             if op[0] == "gltf"][0]
    baked = load_gltf(asset.ensure())
    raw = load_gltf(write_truffle_glb(str(tmp_path / "raw.glb"), nu=NU,
                                      tex_size=TEX))
    for mat in raw[1]:
        app_scenes.truffle_material_rewrite(mat)
    assert baked[1] == raw[1]
    assert [m.roughness_ for m in baked[1]] == [0.02, 0.25]
    for a, b in zip(baked[0], raw[0]):
        for k in ("positions", "oct_normals", "uvs", "tangents", "indices"):
            assert np.array_equal(getattr(a, k), getattr(b, k)), k
    assert all(np.array_equal(a, b) for a, b in zip(baked[2], raw[2]))
    assert baked[3] == raw[3]


@pytest.mark.parametrize("src", [(256, 256), (37, 23), (300, 170)],
                         ids=lambda s: "x".join(map(str, s)))
def test_reference_resize_equals_pillow_and_port(src):
    img = np.random.default_rng(sum(src)).integers(0, 256, src + (3,),
                                                   np.uint8)
    got = resize_lanczos(img, 1024, 1024)
    want = np.asarray(Image.fromarray(img).resize((1024, 1024),
                                                  Image.LANCZOS))
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.array_equal(got, want)
    assert np.array_equal(got, resize_u8(img, 1024, 1024, "lanczos"))


def test_reference_resize_shrinks_like_pillow():
    """Shrinking widens the window (support times in / out) and one
    channel takes the same path."""
    img = np.random.default_rng(5).integers(0, 256, (90, 61), np.uint8)
    want = np.asarray(Image.fromarray(img).resize((17, 40), Image.LANCZOS))
    assert np.array_equal(resize_lanczos(img, 17, 40), want)


def test_reference_texture_equals_the_builders():
    """The reference's prepared texture (sRGB decode, 8 bits, its own
    resize) equals the port's SceneBuilder's, word for word."""
    from tpu_raytracer_torch.scene.builder import _prep_texture
    img = truffle.truffle_texture(TEX)
    assert np.array_equal(truffle.prepared_texture(img),
                          _prep_texture(img, srgb=True))


def test_setup_record_counts_the_resize():
    """Building the small truffle prepares one texture, which takes the
    Lanczos branch (32^2 is not 1024^2)."""
    before = dict(profiling.SETUP)
    port.build(scenes.describe(_config()), torch.device("cpu"),
               kernel="mxuf2")
    assert profiling.SETUP["texture_resizes"] - before["texture_resizes"] \
        == 1
    assert profiling.SETUP["texture_prep"] > before["texture_prep"]


def test_frame_equals_the_reference():
    """The cell at 32x24 through the program's eager frame, against the
    benchmark's reference within the cell's limits; the frame is lit."""
    cell = cells.load("truffle.still_720p",
                      os.path.join(ROOT, "BENCHMARK.json"))
    cell.traffic.update(width=32, height=24, check_within=3)
    cell.config.update(asset_nu=NU, texture_size=TEX)
    frames = []

    class Frame(cpu_frame.EagerFrame):
        def __call__(self, *args):
            out = super().__call__(*args)
            frames.append(out[1].clone())
            return out

    r = run.measure(cell, 2 ** 33 + 1, 0.2, False, [torch.device("cpu")],
                    time.perf_counter(), frame_factory=Frame,
                    sync=lambda: None, log=lambda *a: None)
    assert r["correct"], r["checked"]
    assert all(v["value"] <= v["limit"] for v in r["checked"].values())
    assert float(frames[0].sum()) > 0.0
