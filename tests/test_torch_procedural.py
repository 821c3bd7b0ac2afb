"""The port's procedural glTF stand-ins (avocado, helmet, figure, truffle)
against the reference's: the lathe geometry, each writer's .glb through
each package's own loader, the four named scenes' tables, the default
asset paths, the truffle's fallback and a 32^2 truffle frame. The sizes
are the reference tests' small ones (tests/test_procedural_assets.py):
32^2 textures, nu 12-32.

Tolerances, each with its measured value:
  - geometry, loaded meshes, materials, images and every scene table:
    EXACTLY equal;
  - 2 ReSTIR frames at 32^2 of the small truffle: PSNR >= FRAME_DB
    against the live reference (measured value beside it; ROADMAP's
    floor is 38 dB, raised to the measured value less a wide margin,
    since one flipped path costs tens of dB).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_raytracer.models import procedural_assets as ref_pa
from tpu_raytracer.models import scenes as ref_scenes
from tpu_raytracer.render import camera as camera_mod
from tpu_raytracer.render import pipeline as ref_pipeline
from tpu_raytracer.render import renderer as ref_renderer
from tpu_raytracer.scene import loader as ref_loader
from tpu_raytracer.scene import material as ref_material
from tpu_raytracer.utils.image import psnr
from tpu_raytracer_torch.models import procedural_assets as pa
from tpu_raytracer_torch.models import scenes
from tpu_raytracer_torch.ops import trace_api
from tpu_raytracer_torch.render import pipeline, renderer
from tpu_raytracer_torch.scene import loader, material

FRAME_DB = 80.0        # measured 138.5 dB (2 frames, 32^2, small truffle)

TABLES = ["tri_planes", "chunk_aabb", "tri_table", "mat_table",
          "light_table", "bvh_rec", "bvh_skip", "bvh_tri"]

# (writer, small keywords, meshes, materials, images), as
# tests/test_procedural_assets.py:52-56 holds the reference's
ASSETS = {
    "avocado": ("write_avocado_glb", dict(nu=24, nv=16, tex_size=32), 2, 2, 3),
    "helmet": ("write_helmet_glb", dict(nu=32, tex_size=32), 3, 3, 4),
    "figure": ("write_figure_glb", dict(nu=12, tex_size=32), 15, 5, 2),
    "truffle": ("write_truffle_glb", dict(nu=24, tex_size=32), 8, 2, 1),
}
# the named scene of each asset, in each package
SCENES = {"avocado": "create_avocado_scene",
          "helmet": "create_damaged_helmet_scene",
          "figure": "create_multi_material_model_scene",
          "truffle": "create_chocolate_truffle_scene"}

torch.set_num_threads(1)


def _numpy(scene):
    return jax.tree_util.tree_map(np.asarray, scene)


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

def _parts(m):
    """The reference's profiles and lathes through module m."""
    return {
        "sphere": m.lathe(m.sphere_profile(2.0, 32), nu=48),
        "cap": m.lathe(m.sphere_profile(0.125, 20,
                                        lat_range=(0.0, np.pi * 0.62)), nu=12),
        "capsule": m.lathe(m.capsule_profile(0.042, 0.52, 10), nu=16),
        "band": m.lathe(np.stack([[0.202, -0.04], [0.206, 0.0],
                                  [0.202, 0.04]], 0), nu=24),
    }


def _assert_prims_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and np.array_equal(a, b), k


@pytest.mark.parametrize("part", ["sphere", "cap", "capsule", "band"])
def test_lathe_equals_reference(part):
    _assert_prims_equal(_parts(pa)[part], _parts(ref_pa)[part])


@pytest.mark.parametrize("rot", ["x", "y", "z", "none"])
def test_place_equals_reference(rot):
    angle = 0.55
    got, want = (
        m.place(_parts(m)["capsule"],
                rot=None if rot == "none" else getattr(m, f"_rot_{rot}")(
                    angle),
                pos=(0.1, -2.0, 0.3), s=1.5, material=3)
        for m in (pa, ref_pa))
    _assert_prims_equal(got, want)


def test_profiles_equal_reference():
    for args in ((1.0, 24), (1.01, 24, 0.0, (np.pi * 0.52, np.pi * 0.78))):
        assert np.array_equal(pa.sphere_profile(*args),
                              ref_pa.sphere_profile(*args))
    assert np.array_equal(pa.capsule_profile(0.035, 0.08, 8),
                          ref_pa.capsule_profile(0.035, 0.08, 8))


# ---------------------------------------------------------------------------
# the writers, through each package's loader
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_assets(tmp_path_factory):
    """{name: (port's path, reference's path)} at the small sizes."""
    folder = tmp_path_factory.mktemp("procedural")
    out = {}
    for name, (writer, kw, *_) in ASSETS.items():
        out[name] = tuple(
            getattr(m, writer)(str(folder / f"{tag}_{name}.glb"), **kw)
            for m, tag in ((pa, "port"), (ref_pa, "ref")))
    return out


@pytest.mark.parametrize("name", list(ASSETS))
def test_writer_loads_equal_to_reference(small_assets, name):
    port_path, ref_path = small_assets[name]
    g_meshes, g_mats, g_images, g_idx = loader.load_gltf(port_path)
    w_meshes, w_mats, w_images, w_idx = ref_loader.load_gltf(ref_path)
    _, _, n_meshes, n_mats, n_images = ASSETS[name]
    assert (len(g_meshes), len(g_mats), len(g_images)) == (
        n_meshes, n_mats, n_images)
    assert g_idx == w_idx and len(g_meshes) == len(w_meshes)
    for gm, wm in zip(g_meshes, w_meshes):
        for k in ("positions", "oct_normals", "uvs", "tangents", "indices"):
            a, b = getattr(gm, k), getattr(wm, k)
            assert a.dtype == b.dtype and np.array_equal(a, b), k
    g_tab = material.pack_materials(g_mats)
    w_tab = ref_material.pack_materials(w_mats)
    assert sorted(g_tab) == sorted(w_tab)
    for k in w_tab:
        assert np.array_equal(g_tab[k], w_tab[k]), k
    assert len(g_images) == len(w_images)
    for a, b in zip(g_images, w_images):
        assert a.shape == b.shape == (32, 32, 4)
        assert a.dtype == b.dtype and np.array_equal(a, b)


# ---------------------------------------------------------------------------
# the named scenes
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def named_scenes(small_assets):
    """{name: (reference's scene, port's scene)}, each built from the
    asset its own package wrote."""
    return {name: (_numpy(getattr(ref_scenes, SCENES[name])(ref_path)),
                   getattr(scenes, SCENES[name])("cpu", port_path))
            for name, (port_path, ref_path) in small_assets.items()}


@pytest.mark.parametrize("table", TABLES + ["color_tex", "data_tex"])
@pytest.mark.parametrize("name", list(ASSETS))
def test_scene_tables_equal_reference(named_scenes, name, table):
    ref, port = named_scenes[name]
    want = np.asarray(getattr(ref, table))
    got = getattr(port, table)
    if table.endswith("_tex"):      # the port keeps 3 channels in bf16
        assert got.dtype == torch.bfloat16
        want = want[..., :3].astype(np.float32)
        got = got.float()
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


def test_scene_counts(named_scenes):
    for name, (ref, port) in named_scenes.items():
        assert port.num_triangles == ref.num_triangles, name
        assert port.num_lights == ref.num_lights, name
        assert port.tex_channels == ref.tex_channels, name
        # K1's route, as the default-size stand-ins take it
        assert port.tri_planes.shape[2] <= trace_api.MXUF_MAX_TP, name
    assert named_scenes["truffle"][1].num_lights == 3


def test_truffle_rewrite_hits_both_branches(named_scenes):
    """scenes.rs:393-411 on the loaded asset: glossy chocolate (roughness
    0.02) and satin ribbon (0.25); the studio's three sphere lights."""
    port = named_scenes["truffle"][1]
    rough = port.mat_table.numpy()[:, 7]
    assert (np.abs(rough - 0.02) < 1e-6).any(), "no glossy chocolate row"
    assert (np.abs(rough - 0.25) < 1e-6).any(), "no satin ribbon row"
    strengths = sorted(port.light_table.numpy()[:, 14].tolist())
    assert strengths == [10.0, 40.0, 80.0]


def test_truffle_material_rewrite_equals_reference():
    for color in ((0.1, 0.1, 0.1, 1.0), (0.9, 0.2, 0.2, 1.0),
                  (0.0, 0.43, 0.0, 1.0), (0.30, 0.19, 0.12, 1.0)):
        got, want = material.Material(color), ref_material.Material(color)
        scenes.truffle_material_rewrite(got)
        ref_scenes.truffle_material_rewrite(want)
        assert (got.roughness_, got.metallic_) == (want.roughness_,
                                                   want.metallic_), color


# ---------------------------------------------------------------------------
# default paths and the truffle's fallback
# ---------------------------------------------------------------------------

@pytest.fixture
def small_defaults(tmp_path, monkeypatch):
    """The port's stand-ins generated at the small sizes into tmp_path,
    through ensure_asset; the reference's ensure_asset gives its own
    small files from there too."""
    monkeypatch.setattr(pa, "MODELS_DIR", str(tmp_path))
    monkeypatch.setattr(pa, "_WRITERS", {
        name: (lambda path, w=getattr(pa, writer), kw=kw: w(path, **kw))
        for name, (writer, kw, *_) in ASSETS.items()})

    def ref_ensure(name):
        writer, kw, *_ = ASSETS[name]
        return getattr(ref_pa, writer)(str(tmp_path / f"ref_{name}.glb"),
                                       **kw)

    monkeypatch.setattr(ref_pa, "ensure_asset", ref_ensure)
    return tmp_path


def test_default_paths_are_the_ports_own(small_defaults, capsys):
    for name in ASSETS:
        path = pa.ensure_asset(name)
        assert os.path.basename(path) == f"torch_procedural_{name}.glb"
        assert os.path.dirname(path) == str(small_defaults)
    scene = scenes.create_chocolate_truffle_scene("cpu")
    assert "using procedural stand-in" in capsys.readouterr().out
    assert scene.num_lights == 3
    written = sorted(os.listdir(small_defaults))
    assert not [f for f in written if f.startswith("procedural_")], written
    assert "torch_procedural_truffle.glb.version" in written


def test_module_default_dir_is_assets_models():
    assert pa.asset_path("helmet") == os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "assets", "models", "torch_procedural_helmet.glb")


def test_ensure_asset_regenerates_stale(small_defaults):
    path = pa.ensure_asset("truffle")
    mtime = os.stat(path).st_mtime_ns
    assert pa.ensure_asset("truffle") == path          # cached
    assert os.stat(path).st_mtime_ns == mtime
    with open(path + ".version", "w") as f:
        f.write(str(pa.ASSET_VERSION - 1))
    os.utime(path, ns=(0, 0))
    pa.ensure_asset("truffle")                         # stale: rewritten
    assert os.stat(path).st_mtime_ns != 0
    with open(path + ".version") as f:
        assert f.read() == str(pa.ASSET_VERSION)


def test_truffle_falls_back_to_avocado(small_defaults, capsys):
    missing = str(small_defaults / "missing.glb")
    port = scenes.create_chocolate_truffle_scene("cpu", missing)
    assert "Failed to load gift chocolate" in capsys.readouterr().out
    ref = _numpy(ref_scenes.create_chocolate_truffle_scene(missing))
    assert port.num_lights == ref.num_lights == 1
    assert port.num_triangles == ref.num_triangles > 500    # the avocado
    for name in TABLES:
        assert np.array_equal(getattr(port, name).numpy(),
                              np.asarray(getattr(ref, name))), name


# ---------------------------------------------------------------------------
# the truffle's frame
# ---------------------------------------------------------------------------

def test_truffle_frames_match_reference(named_scenes):
    """Two full ReSTIR frames at 32^2 through both packages."""
    ref, port = named_scenes["truffle"]
    w = h = 32
    cam = camera_mod.CameraController()
    r_state = ref_pipeline.init_state(w, h)
    p_state = pipeline.init_state(w, h, "cpu")
    for f in range(2):
        u = cam.uniform(1.0, f, ref.num_lights)
        r_ldr, _, r_state, r_aux = ref_pipeline.render_frame(
            ref, ref_renderer.camera_to_device(u), jnp.uint32(f), r_state,
            w, h, static_ok=f > 0)
        p_ldr, p_hdr, p_state, p_aux = pipeline.render_frame(
            port, renderer.camera_to_device(u, "cpu"), f, p_state, w, h,
            static_ok=f > 0)
    got = p_ldr.numpy()
    assert got.shape == (w * h, 3) and np.isfinite(got).all()
    assert np.isfinite(p_hdr.numpy()).all()
    assert got.max() > 0.01, "black frame"
    assert abs(float(p_aux["rays"]) - float(r_aux["rays"])) \
        <= 0.01 * float(r_aux["rays"])
    p = psnr(got, np.asarray(r_ldr, np.float32))
    assert p >= FRAME_DB, f"PSNR vs reference = {p:.2f} dB"


def _jpeg_texture_loads_like_the_reference(tmp_path, capsys, **save):
    from io import BytesIO

    from PIL import Image

    from tpu_raytracer_torch.models.glb_writer import write_glb

    jpeg = BytesIO()
    texels = np.random.default_rng(7).integers(0, 256, (32, 32, 3), np.uint8)
    Image.fromarray(texels).save(jpeg, format="JPEG", **save)
    part = pa.lathe(pa.sphere_profile(0.5, 8), nu=12)
    part["material"] = 0
    path = write_glb(str(tmp_path / "jpeg.glb"), [part], [jpeg.getvalue()],
                     [{"pbrMetallicRoughness": {
                         "baseColorTexture": {"index": 0}}}])
    port = scenes.create_gltf_scene("cpu", path)
    assert "glTF load failed" not in capsys.readouterr().out
    ref = _numpy(ref_scenes.create_gltf_scene(path))
    assert port.num_triangles == ref.num_triangles == 4 + 7 * 12 * 2
    for name in TABLES:
        assert np.array_equal(getattr(port, name).numpy(),
                              np.asarray(getattr(ref, name))), name
    assert np.array_equal(port.color_tex.float().numpy(),
                          np.asarray(ref.color_tex)[..., :3].astype(
                              np.float32))


def test_jpeg_texture_loads_like_the_reference(tmp_path, capsys):
    """A .glb with a JPEG texture: the port decodes it (utils/jpeg.py)
    and builds the reference's scene, tables and textures equal."""
    _jpeg_texture_loads_like_the_reference(tmp_path, capsys)


def test_progressive_jpeg_texture_loads_like_the_reference(tmp_path, capsys):
    """The same with a progressive JPEG texture, the form a downloaded
    glTF most often carries."""
    _jpeg_texture_loads_like_the_reference(tmp_path, capsys,
                                           progressive=True)


def test_asset_path_finds_the_canonical_file_in_the_working_dir(
        tmp_path, monkeypatch, capsys):
    """A downloaded asset at its canonical path relative to the working
    directory loads as it is, as the reference's _asset_path finds it."""
    models = tmp_path / "assets" / "models"
    models.mkdir(parents=True)
    pa.write_avocado_glb(str(models / "Avocado.glb"), nu=12, nv=8,
                         tex_size=32)
    monkeypatch.chdir(tmp_path)
    assert scenes._asset_path("assets/models/Avocado.glb", "avocado") \
        == "assets/models/Avocado.glb"
    port = scenes.create_avocado_scene("cpu")
    assert "stand-in" not in capsys.readouterr().out
    ref = _numpy(ref_scenes.create_avocado_scene())
    assert port.num_triangles == ref.num_triangles
    assert np.array_equal(port.tri_table.numpy(), np.asarray(ref.tri_table))
