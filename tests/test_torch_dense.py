"""The port's dense glTF path (bench.py config 6, the 100,800-triangle
trefoil knot) and the other flattened scenes of its slice against the
reference: PNG decoding, the generated asset, the glTF loader, the
builder's texture and light API, the knot, bunny and restir scene
tables, kernel K3's plain twin (`ops/trace_stream.py`), the G-buffer and
the ReSTIR frame.

Tolerances, each with its measured value:
  - PNG pixels, asset arrays, loader output and every scene table:
    EXACTLY equal (the BVH-DFS order sets every triangle id);
  - `trace_plain` and `trace_stream_plain` against `_trace_brute_xla`:
    tri equal on every lane, t within T_ULPS = 0 ulps (measured 0);
  - `trace_stream_plain` against `trace_plain`: both keys equal;
  - G-buffer on the small knot, against the jitted reference: valid and
    mat_id equal; pos, uv and motion within GB_ATOL, the normal-mapped
    oct normal within NORMAL_ATOL and the textured albedo within
    ALBEDO_ATOL (measured values beside each constant);
  - 2 frames at 32^2 on the small knot: PSNR >= FRAME_DB against the
    live reference (measured value beside it; ROADMAP's floor is 38 dB,
    raised to the measured value less a wide margin, since one flipped
    path costs tens of dB).
"""

import base64
import json
import os
import struct
import subprocess
import sys
import zlib
from io import BytesIO

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tpu_raytracer.models import dense_asset as ref_asset
from tpu_raytracer.models import scenes as ref_scenes
from tpu_raytracer.ops import gbuffer as ref_gbuffer
from tpu_raytracer.ops import trace_api as ref_trace
from tpu_raytracer.render import camera as camera_mod
from tpu_raytracer.render import pipeline as ref_pipeline
from tpu_raytracer.render import renderer as ref_renderer
from tpu_raytracer.scene import builder as ref_builder
from tpu_raytracer.scene import geometry as ref_geometry
from tpu_raytracer.scene import loader as ref_loader
from tpu_raytracer.scene import material as ref_material
from tpu_raytracer.utils import math3d as ref_math3d
from tpu_raytracer.utils.image import psnr
from tpu_raytracer_torch import convert
from tpu_raytracer_torch.models import dense_asset, scenes
from tpu_raytracer_torch.ops import gbuffer, trace_api, trace_stream
from tpu_raytracer_torch.render import pipeline, renderer
from tpu_raytracer_torch.scene import builder, geometry, loader, material
from tpu_raytracer_torch.utils import math3d, png
from tpu_raytracer_torch.utils.vec3 import V3

T_ULPS = 0
# G-buffer tolerances against the jitted reference. XLA:CPU fuses
# products the port rounds separately; the jitted reference differs from
# the same reference run op by op (jax.disable_jit) by as much as from
# the port, and the normal map and the texture lookups amplify a
# rounding of uv.
GB_ATOL = 1e-5         # pos, uv, motion: measured max 2.6e-6
NORMAL_ATOL = 2e-4     # normal-mapped oct normal: measured max 5.9e-5
ALBEDO_ATOL = 5e-4     # base colour x texture: measured max 1.2e-4
FRAME_DB = 80.0        # measured 108.8 dB (2 frames, 32^2, small knot)
SMALL_KNOT = dict(major=84, minor=24)   # 4,032 triangles, 1024^2 textures

TABLES = ["tri_planes", "chunk_aabb", "tri_table", "mat_table",
          "light_table", "bvh_rec", "bvh_skip", "bvh_tri"]

# The tests run in several worker processes at once: one torch thread each
# keeps them from oversubscribing the cores.
torch.set_num_threads(1)


def _numpy(scene):
    return jax.tree_util.tree_map(np.asarray, scene)


def _v3(a):
    return V3(*torch.from_numpy(np.array(a, np.float32)).unbind(1))


def _ulps(a, b):
    return np.abs(np.asarray(a).view(np.int32).astype(np.int64)
                  - np.asarray(b).view(np.int32).astype(np.int64))


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

def _png_chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _row_filters(data):
    """The filter type of every row of an 8-bit PNG."""
    pos, idat = 8, b""
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            w, h, _, ctype = struct.unpack(">IIBB", body[:10])
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    stride = w * {0: 1, 2: 3, 4: 2, 6: 4}[ctype] + 1
    raw = zlib.decompress(idat)
    return {raw[y * stride] for y in range(h)}


def _test_image(mode, seed=0, h=24, w=20):
    """Gradients, noise rows and repeated rows, so an adaptive encoder
    picks every filter type somewhere."""
    c = len(mode)
    g = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([(xx * 7 + yy * 3 + k * 40) % 256 for k in range(c)],
                   -1).astype(np.int64)
    img[::3] += g.integers(0, 255, (len(img[::3]), w, c))
    img[1::5] = (xx[1::5, :, None] * 11) % 256
    img[2::7] = g.integers(0, 255, (len(img[2::7]), w, c))
    return (img % 256).astype(np.uint8)


def _pil_rgba(data):
    return np.asarray(Image.open(BytesIO(data)).convert("RGBA"))


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA"])
def test_png_decode_matches_pil(mode):
    """Images PIL wrote (optimize=True tries all five filters per row),
    decoded by both."""
    img = _test_image(mode)
    bio = BytesIO()
    Image.fromarray(img[..., 0] if mode == "L" else img, mode).save(
        bio, format="PNG", optimize=True)
    data = bio.getvalue()
    assert _row_filters(data) == {0, 1, 2, 3, 4}
    got = png.decode(data)
    assert got.dtype == np.uint8 and got.shape == (24, 20, 4)
    assert np.array_equal(got, _pil_rgba(data))


def _encode_filtered(img, f):
    """PNG bytes of RGBA uint8 `img` with filter type `f` on every row,
    written here so each filter is tested alone."""
    h, w, c = img.shape
    x = img.reshape(h, w * c).astype(np.int64)
    up = np.vstack([np.zeros((1, w * c), np.int64), x[:-1]])
    left = np.hstack([np.zeros((h, c), np.int64), x[:, :-c]])
    up_left = np.hstack([np.zeros((h, c), np.int64), up[:, :-c]])
    p = left + up - up_left
    pa, pb, pc = abs(p - left), abs(p - up), abs(p - up_left)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, up, up_left))
    pred = [0 * x, left, up, (left + up) // 2, paeth][f]
    rows = np.hstack([np.full((h, 1), f, np.int64), (x - pred) % 256])
    return (png.SIGNATURE
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0,
                                              0))
            + _png_chunk(b"IDAT", zlib.compress(rows.astype(np.uint8)
                                                .tobytes()))
            + _png_chunk(b"IEND", b""))


@pytest.mark.parametrize("f", [0, 1, 2, 3, 4],
                         ids=["none", "sub", "up", "avg", "paeth"])
def test_png_decode_each_filter(f):
    img = _test_image("RGBA", seed=f)
    data = _encode_filtered(img, f)
    assert _row_filters(data) == {f}
    assert np.array_equal(_pil_rgba(data), img)
    assert np.array_equal(png.decode(data), img)


def test_png_encode_reads_back_through_pil():
    img = _test_image("RGB", seed=5)
    data = png.encode_rgb(img)
    assert _row_filters(data) == {0}
    assert np.array_equal(_pil_rgba(data)[..., :3], img)
    assert np.array_equal(png.decode(data)[..., :3], img)


@pytest.mark.parametrize("mode", ["I;16", "P"])
def test_png_refuses_other_depths_and_palettes(mode):
    bio = BytesIO()
    Image.new(mode, (4, 4)).save(bio, format="PNG")
    with pytest.raises(ValueError):
        png.decode(bio.getvalue())


# ---------------------------------------------------------------------------
# asset
# ---------------------------------------------------------------------------

def test_knot_mesh_equals_reference():
    for got, want in zip(dense_asset.knot_mesh(), ref_asset.knot_mesh()):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert len(dense_asset.knot_mesh()[4]) == 3 * 100800


def test_texture_pixels_equal_reference():
    """The reference's PNGs (PIL) and the port's (filter 0) hold the same
    pixels."""
    want = [_pil_rgba(b)[..., :3] for b in ref_asset._texture_set(128)]
    for got, w in zip(dense_asset._texture_pixels(128), want):
        assert np.array_equal(got, w)
    for data, w in zip(dense_asset._texture_set(128), want):
        assert np.array_equal(png.decode(data)[..., :3], w)


def test_ensure_dense_asset_takes_a_bare_file_name(tmp_path, monkeypatch):
    """A bare name has no directory part: the version file goes beside
    the asset in the working directory."""
    monkeypatch.chdir(tmp_path)
    assert dense_asset.ensure_dense_asset("knot.glb") == "knot.glb"
    assert (tmp_path / "knot.glb").stat().st_size > 1e6
    assert (tmp_path / "knot.glb.version").read_text() == \
        str(dense_asset.ASSET_VERSION)
    mtime = (tmp_path / "knot.glb").stat().st_mtime_ns
    dense_asset.ensure_dense_asset("knot.glb")        # cached: not rewritten
    assert (tmp_path / "knot.glb").stat().st_mtime_ns == mtime


# ---------------------------------------------------------------------------
# loader
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_glb(tmp_path_factory):
    """The reference's writer at 84 x 24 (4,032 triangles)."""
    path = str(tmp_path_factory.mktemp("knot") / "small.glb")
    return ref_asset.write_knot_glb(path, **SMALL_KNOT)


def _assert_loaded_equal(got, want):
    g_meshes, g_mats, g_images, g_idx = got
    w_meshes, w_mats, w_images, w_idx = want
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
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_loader_matches_reference_glb(small_glb):
    got = loader.load_gltf(small_glb)
    _assert_loaded_equal(got, ref_loader.load_gltf(small_glb))
    assert got[0][0].num_triangles == 4032 and len(got[2]) == 3


def _write_gltf(folder):
    """A .gltf with an external buffer: interleaved positions and normals
    (byte stride 24), normalised u16 uvs, u8 indices, a primitive without
    indices, a data-URI image, and the transmission and ior extensions."""
    g = np.random.default_rng(9)
    pos = g.standard_normal((6, 3)).astype(np.float32)
    nrm = g.standard_normal((6, 3)).astype(np.float32)
    inter = np.concatenate([pos, nrm], axis=1).tobytes()         # 144 B
    uv = g.integers(0, 65535, (6, 2)).astype(np.uint16).tobytes()  # 24 B
    idx = np.array([0, 1, 2, 3, 4, 5, 0, 2, 4], np.uint8).tobytes()
    blob = inter + uv + idx + b"\0" * 3
    (folder / "scene.bin").write_bytes(blob)
    img = BytesIO()
    Image.fromarray(_test_image("RGB", seed=7)).save(img, format="PNG")
    uri = "data:image/png;base64," + base64.b64encode(img.getvalue()).decode()
    gltf = {
        "asset": {"version": "2.0"},
        "buffers": [{"uri": "scene.bin", "byteLength": len(blob)}],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": 144,
             "byteStride": 24},
            {"buffer": 0, "byteOffset": 144, "byteLength": 24},
            {"buffer": 0, "byteOffset": 168, "byteLength": 9}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 6,
             "type": "VEC3"},
            {"bufferView": 0, "byteOffset": 12, "componentType": 5126,
             "count": 6, "type": "VEC3"},
            {"bufferView": 1, "componentType": 5123, "normalized": True,
             "count": 6, "type": "VEC2"},
            {"bufferView": 2, "componentType": 5121, "count": 9,
             "type": "SCALAR"}],
        "images": [{"uri": uri}],
        "textures": [{"source": 0}],
        "materials": [
            {"pbrMetallicRoughness": {"baseColorFactor": [0.5, 0.6, 0.7, 1],
                                      "baseColorTexture": {"index": 0},
                                      "roughnessFactor": 0.3},
             "emissiveFactor": [0.1, 0.2, 0.3],
             "extensions": {"KHR_materials_transmission":
                            {"transmissionFactor": 0.8},
                            "KHR_materials_ior": {"ior": 1.33}}},
            {"occlusionTexture": {"index": 0},
             "emissiveTexture": {"index": 0}}],
        "meshes": [{"primitives": [
            {"attributes": {"POSITION": 0, "NORMAL": 1, "TEXCOORD_0": 2},
             "indices": 3, "material": 1},
            {"attributes": {"POSITION": 0}}]}],
    }
    path = folder / "scene.gltf"
    path.write_text(json.dumps(gltf))
    return str(path)


def test_loader_matches_reference_gltf(tmp_path):
    path = _write_gltf(tmp_path)
    got = loader.load_gltf(path)
    _assert_loaded_equal(got, ref_loader.load_gltf(path))
    meshes, mats, _, idx = got
    assert idx == [1, 0] and len(meshes[1].indices) == 6   # 0..N-1
    assert mats[0].transmission_ == pytest.approx(0.8)
    assert mats[0].ior_ == pytest.approx(1.33)
    assert 0.0 <= meshes[0].uvs.min() and meshes[0].uvs.max() <= 1.0


# ---------------------------------------------------------------------------
# builder
# ---------------------------------------------------------------------------

def _textured_builder(sb, geo, mat, m3, images):
    b = sb.SceneBuilder()
    plane = b.add_mesh(geo.create_plane())
    ids = [b.add_color_texture(images[0]),
           b.add_color_texture(images[1], srgb=False),
           b.add_data_texture(images[2]),
           b.add_data_texture(images[3])]
    m = b.add_material(mat.Material((0.7, 0.7, 0.7, 1.0)).texture(ids[0])
                       .normal_texture(ids[2])
                       .metallic_roughness_texture(ids[3]))
    b.add_instance(plane, m, m3.scale(2.0))
    b.add_quad_light([0, 1, 0], [0.5, 0, 0], [0, 0, 0.5], [1, 1, 1, 5])
    b.add_sphere_light([0.3, 0.5, 0], 0.1, [1, 0.5, 0.2, 3])
    return b


def test_textures_and_lights_equal_reference():
    g = np.random.default_rng(11)
    s = builder.TEXTURE_SIZE
    images = [g.integers(0, 256, (s, s, 4), dtype=np.uint8),
              g.integers(0, 256, (s, s, 3), dtype=np.uint8),
              g.integers(0, 256, (s, s), dtype=np.uint8),
              g.uniform(size=(s, s, 3)).astype(np.float32)]
    ref = _numpy(_textured_builder(ref_builder, ref_geometry, ref_material,
                                   ref_math3d, images).build())
    port = _textured_builder(builder, geometry, material, math3d,
                             images).build("cpu")
    for name in ("color_tex", "data_tex"):
        want = np.asarray(getattr(ref, name))[..., :3].astype(np.float32)
        assert np.array_equal(getattr(port, name).float().numpy(), want)
    for name in ("mat_table", "light_table"):
        assert np.array_equal(getattr(port, name).numpy(),
                              np.asarray(getattr(ref, name)))
    assert port.tex_channels == ref.tex_channels == frozenset(
        {"color", "normal", "metallic_roughness"})


# ---------------------------------------------------------------------------
# scenes: the full-width knot, bunny and restir
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def knot(tmp_path_factory):
    """The full-width knot (100,804 world triangles) built by each package
    from the file each package's generator wrote."""
    folder = tmp_path_factory.mktemp("full_knot")
    ref_path = ref_asset.write_knot_glb(str(folder / "ref.glb"))
    port_path = dense_asset.write_knot_glb(str(folder / "port.glb"))
    return (_numpy(ref_scenes.create_dense_knot_scene(ref_path)),
            scenes.create_dense_knot_scene("cpu", port_path))


@pytest.fixture(scope="module")
def flat_scenes():
    return {"bunny": (_numpy(ref_scenes.create_bunny_scene()),
                      scenes.create_bunny_scene("cpu")),
            "restir": (_numpy(ref_scenes.create_restir_scene()),
                       scenes.create_restir_scene("cpu"))}


@pytest.mark.parametrize("name", TABLES)
@pytest.mark.parametrize("which", ["knot", "bunny", "restir"])
def test_scene_table_equals_reference(knot, flat_scenes, which, name):
    ref, port = knot if which == "knot" else flat_scenes[which]
    want = np.asarray(getattr(ref, name))
    got = getattr(port, name).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("name", ["color_tex", "data_tex"])
def test_knot_texels_equal_reference(knot, name):
    ref, port = knot
    got = getattr(port, name)
    want = np.asarray(getattr(ref, name))[..., :3].astype(np.float32)
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.float().numpy(), want)


def test_knot_counts(knot):
    ref, port = knot
    assert port.num_triangles == 100804
    assert port.tri_planes.shape == (4, 3, 100864)      # 788 chunks
    assert port.tri_planes.shape[2] > trace_api.MXUF_MAX_TP
    assert trace_stream.stream_units(788) == (16, 50)
    assert port.num_lights == ref.num_lights == 1
    assert port.tex_channels == ref.tex_channels == frozenset(
        {"color", "normal", "metallic_roughness"})
    assert port.color_tex.shape[0] == 4 and port.data_tex.shape[0] == 5


def test_flat_scene_counts(flat_scenes):
    """Both stay on K1's route: at or under MXUF_MAX_TP slots."""
    bunny, restir = flat_scenes["bunny"][1], flat_scenes["restir"][1]
    assert bunny.num_triangles == 15372
    assert bunny.tri_planes.shape[2] == 121 * 128
    assert restir.num_triangles == 32016 and restir.num_lights == 100
    for s in (bunny, restir):
        assert s.tri_planes.shape[2] <= trace_api.MXUF_MAX_TP


def test_knot_load_failure_leaves_floor_and_light(tmp_path, capsys):
    missing = str(tmp_path / "missing.glb")
    port = scenes.create_dense_knot_scene("cpu", missing)
    ref = _numpy(ref_scenes.create_dense_knot_scene(missing))
    assert "glTF load failed" in capsys.readouterr().out
    assert port.num_triangles == 4
    for name in TABLES:
        assert np.array_equal(getattr(port, name).numpy(),
                              np.asarray(getattr(ref, name))), name


def test_convert_carries_knot_scene(knot):
    ref, port = knot
    got = convert.scene_from_reference(ref, "cpu")
    for name in TABLES + ["color_tex", "data_tex"]:
        a, b = getattr(got, name), getattr(port, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name
    assert got.tex_channels == port.tex_channels and not got.instanced


@pytest.mark.parametrize("size", [1, 127, 128, 2048, 2049, 10000])
def test_stream_units_rule(size):
    """grp is the smallest power of two with ceil(chunks / grp) <=
    MAX_UNITS."""
    grp, units = trace_stream.stream_units(size)
    assert units == -(-size // grp) <= trace_stream.MAX_UNITS
    assert grp == 1 or -(-size // (grp // 2)) > trace_stream.MAX_UNITS


@pytest.mark.parametrize("which", ["knot", "layered"])
def test_unit_boxes_contain_padded_chunk_boxes(knot, layered, which):
    """Each unit box (K3's first step) holds every padded chunk box of its
    unit, padded as mt.cuh:slab_window pads it, and every vertex of the
    unit's triangles: its slab entry bounds any hit in the unit."""
    planes, aabb = ((knot[1].tri_planes, knot[1].chunk_aabb)
                    if which == "knot" else layered[:2])
    nc = aabb.shape[0]
    grp, units = trace_stream.stream_units(nc)
    ubox = trace_stream.unit_boxes(aabb, grp)
    assert ubox.dtype == np.float32 and ubox.shape == (units, 6)
    box = aabb.numpy()
    real = box[:, 0] <= box[:, 3]
    lo, hi = box[real, 0:3], box[real, 3:6]
    pad = np.float32(1e-5) * (np.abs(lo) + np.abs(hi)) + np.float32(1e-6)
    owner = ubox[np.nonzero(real)[0] // grp]
    assert (owner[:, 0:3] <= lo - pad).all()
    assert (owner[:, 3:6] >= hi + pad).all()
    # the hull is tight: each face is some padded chunk box's face
    for u in range(units):
        mine = np.nonzero(real)[0] // grp == u
        if mine.any():
            assert np.array_equal(ubox[u, 0:3], (lo - pad)[mine].min(0))
            assert np.array_equal(ubox[u, 3:6], (hi + pad)[mine].max(0))
    p = planes.numpy()
    valid = p[3, 0] > 0.5
    tri_unit = np.arange(p.shape[2]) // (128 * grp)
    for vert in (p[0], p[0] + p[1], p[0] + p[2]):
        v = vert.T[valid]
        assert (v >= ubox[tri_unit[valid], 0:3]).all()
        assert (v <= ubox[tri_unit[valid], 3:6]).all()


# ---------------------------------------------------------------------------
# trace: the plain versions at full width, and K3's twin on a layered
# scene where the early exit fires
# ---------------------------------------------------------------------------

def _knot_rays(n, seed):
    """Origins in the knot's box, random directions and t_max, 30% dead."""
    pos = dense_asset.knot_mesh()[0] * 1.1 + np.float32([0, 1.2, 0])
    lo, hi = pos.min(0), pos.max(0)
    g = np.random.default_rng(seed)
    o = (lo + (hi - lo) * g.uniform(size=(n, 3))).astype(np.float32)
    d = g.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = g.uniform(0.01, 4.0, n).astype(np.float32)
    active = g.uniform(size=n) > 0.3
    return o, d, t_max, active


def _primary_rays(scene):
    cam = camera_mod.CameraController().uniform(1.0, 0, scene.num_lights)
    o, d = ref_gbuffer.generate_primary_rays(
        ref_renderer.camera_to_device(cam), 32, 16)
    n = 32 * 16
    return (np.asarray(o), np.asarray(d), np.full(n, 1000.0, np.float32),
            np.ones(n, bool))


@pytest.mark.parametrize("rays", ["primary", "random"])
def test_plain_traces_match_brute_full_width(knot, rays):
    ref, port = knot
    o, d, t_max, active = (_primary_rays(ref) if rays == "primary"
                           else _knot_rays(512, 1))
    want = jax.jit(ref_trace._trace_brute_xla)(
        ref.tri_planes, jnp.asarray(o), jnp.asarray(d), 1e-3,
        jnp.asarray(t_max), active=jnp.asarray(active))
    w_tri, w_t = np.asarray(want["tri"]), np.asarray(want["t"])
    t_hi = torch.from_numpy(np.where(active, t_max, 0.0).astype(np.float32))
    t_lo = torch.full((len(o),), 1e-3)
    flat = trace_api.trace_plain(port.tri_planes, port.chunk_aabb, _v3(o),
                                 _v3(d), t_lo, t_hi)
    stream = trace_stream.trace_stream_plain(
        port.tri_planes, port.chunk_aabb, _v3(o), _v3(d), t_lo, t_hi)
    occ = trace_stream.trace_stream_plain(
        port.tri_planes, port.chunk_aabb, _v3(o), _v3(d), t_lo, t_hi,
        any_hit=True)
    for got in (flat, stream):
        assert np.array_equal(got["tri"].numpy(), w_tri)
        assert _ulps(got["t"].numpy(), w_t).max() <= T_ULPS
    assert np.array_equal(occ["tri"].numpy() >= 0, w_tri >= 0)
    assert torch.equal(occ["t"], t_hi)
    assert (w_tri >= 0).mean() > 0.2
    assert (stream["tri"].numpy()[~active] == -1).all()


def test_scene_trace_on_cpu_takes_plain_and_launches_nothing(knot):
    _, port = knot
    o, d, t_max, active = _knot_rays(256, 2)
    trace_api.reset_launch_counts()
    got = trace_api.scene_trace(port, _v3(o), _v3(d), 1e-3,
                                torch.from_numpy(t_max),
                                active=torch.from_numpy(active))
    occ = trace_api.scene_occluded(port, _v3(o), _v3(d), 1e-3,
                                   torch.from_numpy(t_max),
                                   active=torch.from_numpy(active))
    want = trace_api.trace_plain(
        port.tri_planes, port.chunk_aabb, _v3(o), _v3(d),
        torch.full((256,), 1e-3),
        torch.from_numpy(np.where(active, t_max, 0).astype(np.float32)))
    assert torch.equal(got["tri"], want["tri"])
    assert torch.equal(occ, want["tri"] >= 0)
    assert set(trace_api.LAUNCHES.values()) == {0}


def test_stream_wrapper_refuses_cpu_tensors(knot):
    """K3's wrapper never falls back: a CPU tensor raises before any
    build or launch."""
    _, port = knot
    o = torch.zeros((3, 8))
    with pytest.raises(ValueError):
        trace_stream.trace_stream_kernel(port.tri_planes, port.chunk_aabb, o,
                                         o, torch.zeros(8), torch.ones(8))


TIE_IDS = (3 * 128 + 5, 60 * 128 + 7)   # one triangle, in two units


def layered_scene(rays=512):
    """Four z-slabs of random triangles just past MXUF_MAX_TP slots (as
    tests/test_mxu_kernel.py:197-244 builds for the reference's streamed
    kernel), and coherent rays along +z from z = -1 whose blocks can
    leave after the first slab.

    One triangle at z = 0.5 sits at both TIE_IDS: every ray through it
    meets an exact-t tie across two units. The higher id's chunk also
    holds a small triangle at z = 0.2 out of the rays' way, so its box is
    entered first and the higher id is swept first; the lower id must
    win all the same.

    Returns (tri_planes, chunk_aabb, (o, d, t_min, t_max)): o and d
    [3, rays], 20% dead lanes."""
    g = np.random.default_rng(23)
    per = (trace_api.MXUF_MAX_TP + trace_api.CT) // 4
    v0, e1, e2 = [], [], []
    for z in (1.0, 3.0, 5.0, 7.0):
        v = g.standard_normal((per, 3)).astype(np.float32)
        v[:, 2] = z + 0.1 * v[:, 2]
        a, b = (g.standard_normal((per, 3)).astype(np.float32) * 0.7
                for _ in range(2))
        a[:, 2] *= 0.1
        b[:, 2] *= 0.1
        v0.append(v)
        e1.append(a)
        e2.append(b)
    v0, e1, e2 = (np.concatenate(x) for x in (v0, e1, e2))
    for i in TIE_IDS:
        v0[i], e1[i], e2[i] = [-0.6, -0.6, 0.5], [1.2, 0, 0], [0, 1.2, 0]
    j = TIE_IDS[1] + 2
    v0[j], e1[j], e2[j] = [-2.9, -2.9, 0.2], [0.05, 0, 0], [0, 0.05, 0]
    planes, aabb = trace_api.pack_triangles(v0, e1, e2)

    o = np.zeros((3, rays), np.float32)
    o[0:2] = g.uniform(-1.5, 1.5, (2, rays))
    o[2] = -1.0
    d = np.ones((3, rays), np.float32)
    d[0:2] = g.uniform(-0.2, 0.2, (2, rays))
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    t_max = np.where(g.uniform(size=rays) > 0.2, 50.0, 0.0)
    return (torch.from_numpy(planes), torch.from_numpy(aabb),
            (torch.from_numpy(o), torch.from_numpy(d),
             torch.full((rays,), 1e-3),
             torch.from_numpy(t_max.astype(np.float32))))


@pytest.fixture(scope="module")
def layered():
    return layered_scene()


def test_layered_scene_exact_sweep(layered):
    """The plain scan meets the reference's exact sweep on the layered
    scene, and the tie goes to the lower id."""
    planes, aabb, (o, d, t_min, t_max) = layered
    assert planes.shape[2] > trace_api.MXUF_MAX_TP
    want = jax.jit(ref_trace._trace_brute_xla)(
        jnp.asarray(planes.numpy()), jnp.asarray(o.numpy().T),
        jnp.asarray(d.numpy().T), 1e-3, jnp.asarray(t_max.numpy()))
    got = trace_api.trace_plain(planes, aabb, V3(*o), V3(*d), t_min, t_max)
    assert np.array_equal(got["tri"].numpy(), np.asarray(want["tri"]))
    assert _ulps(got["t"].numpy(), want["t"]).max() <= T_ULPS
    tie = got["tri"] == TIE_IDS[0]
    assert tie.sum() > 10 and not (got["tri"] == TIE_IDS[1]).any()


@pytest.mark.parametrize("max_units", [trace_stream.MAX_UNITS, 16, 8],
                         ids=["grp8", "grp32", "grp64"])
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_streamed_twin_matches_scan_with_early_exit(layered, monkeypatch,
                                                    any_hit, max_units):
    """trace_stream_plain equals trace_plain, while its blocks sweep under
    half of the chunks they reach: the exit fired. The default cap makes
    units of 8 chunks, smaller caps units of 32 and 64, the last of them
    short (257 chunks)."""
    planes, aabb, (o, d, t_min, t_max) = layered
    monkeypatch.setattr(trace_stream, "MAX_UNITS", max_units)
    nc = planes.shape[2] // 128
    grp, units = trace_stream.stream_units(nc)
    assert grp == {64: 8, 16: 32, 8: 64}[max_units]
    assert nc % grp          # the last unit is short
    steps = []

    def counting(boxes, *args):
        steps.append(boxes.shape[0])    # blocks that sweep a chunk
        return chunk_pass(boxes, *args)

    chunk_pass = trace_stream._chunk_pass
    monkeypatch.setattr(trace_stream, "_chunk_pass", counting)
    got = trace_stream.trace_stream_plain(planes, aabb, V3(*o), V3(*d),
                                          t_min, t_max, any_hit=any_hit)
    want = trace_api.trace_plain(planes, aabb, V3(*o), V3(*d), t_min, t_max)
    if any_hit:
        assert torch.equal(got["tri"] >= 0, want["tri"] >= 0)
        assert torch.equal(got["t"], t_max)
    else:
        assert torch.equal(got["tri"], want["tri"])
        assert torch.equal(got["t"], want["t"])
    reached = (o.shape[1] // trace_stream.BLOCK) * (planes.shape[2] // 128)
    assert 0 < sum(steps) < reached / 2


# ---------------------------------------------------------------------------
# G-buffer and frame on the small knot: the first users of the normal and
# metallic-roughness data textures
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_knot(small_glb):
    ref = ref_scenes.create_dense_knot_scene(small_glb)
    return ref, scenes.create_dense_knot_scene("cpu", small_glb)


def test_small_knot_tables_equal_reference(small_knot):
    ref, port = small_knot
    assert port.num_triangles == 4036
    for name in TABLES:
        assert np.array_equal(getattr(port, name).numpy(),
                              np.asarray(getattr(ref, name))), name


def test_gbuffer_matches_reference_small_knot(small_knot):
    ref, port = small_knot
    cam = camera_mod.CameraController().uniform(1.0, 0, ref.num_lights)
    want = jax.jit(ref_gbuffer.render_gbuffer, static_argnums=(2, 3))(
        ref, ref_renderer.camera_to_device(cam), 32, 32)
    got = gbuffer.render_gbuffer(port, renderer.camera_to_device(cam, "cpu"),
                                 32, 32)
    valid = got["valid"].numpy()
    assert np.array_equal(valid, np.asarray(want["valid"]))
    assert np.array_equal(got["mat_id"].numpy(), np.asarray(want["mat_id"]))
    knot_mat = np.asarray(ref.mat_table)[:, 13] >= 0      # normal-mapped
    on_knot = valid & knot_mat[got["mat_id"].numpy()]
    assert on_knot.sum() > 50
    for k, tol in (("pos", GB_ATOL), ("uv", GB_ATOL), ("motion", GB_ATOL),
                   ("oct_normal", NORMAL_ATOL), ("albedo", ALBEDO_ATOL)):
        diff = np.abs(got[k].numpy() - np.asarray(want[k])).max()
        assert diff < tol, (k, diff)


def test_frames_match_reference_small_knot(small_knot):
    """Two full ReSTIR frames at 32^2 through both packages."""
    ref, port = small_knot
    w = h = 32
    cam = camera_mod.CameraController()
    r_state = ref_pipeline.init_state(w, h)
    p_state = pipeline.init_state(w, h, "cpu")
    for f in range(2):
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


def test_new_modules_leave_jax_and_pil_out():
    code = ("import sys, tpu_raytracer_torch.models.scenes, "
            "tpu_raytracer_torch.models.dense_asset, "
            "tpu_raytracer_torch.scene.loader, "
            "tpu_raytracer_torch.ops.trace_stream, "
            "tpu_raytracer_torch.bvh_variants, "
            "tpu_raytracer_torch.bigscene, "
            "tpu_raytracer_torch.utils.png;"
            " bad = [m for m in sys.modules if m in ('jax', 'PIL') or "
            "m.startswith(('jax.', 'PIL.', 'tpu_raytracer.'))"
            " or m == 'tpu_raytracer'];"
            " assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=os.path.dirname(os.path.dirname(__file__)))
