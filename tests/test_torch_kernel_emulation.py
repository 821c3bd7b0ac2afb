"""The CUDA kernels K1-K8, built with g++ under the host emulation
`csrc/host/emulation/cuda_runtime.h`, against their plain versions.

A CUDA kernel cannot run here; this holds the kernels' own source (its
control flow, culling, staging and tie order) to the plain versions on
the CPU, so a logic fault shows before a chip run. It says nothing of
what nvcc accepts or of speed: `chip_smoke.py` checks the real build on
the card. K3 is also built with fewer units (TPURT_MAX_UNITS), so that
its units of 32 and 64 chunks (two 32-chunk segments) run on a small
scene. Tolerance: tri and inst equal on every lane and t bit-equal
(measured: equal; the
emulation's fmaf and -ffp-contract=off round as the kernels' __fmaf_rn
and -fmad=false; its tensor-core product sums the exact bf16 products
in f64 and rounds once, as K6's plain version does). K7, the table
gather, copies words: its output equals the plain version bit for bit.
K8, the BVH walk, equals the plain walk (`traversal.trace_plain`) in
every word of t and tri, closest- and any-hit, on the Cornell box's
stream and on a random-triangle tree, at each of its windows of 1-8
records, with the stream's arrays ending at an unreadable page so that
a read past its last record faults.
"""

import ctypes
import mmap
import os
import re
import shutil
import subprocess
import types

import numpy as np
import pytest
import torch

from test_torch_dense import TIE_IDS, layered_scene
from tpu_raytracer_torch.models import scenes
from tpu_raytracer_torch.ops import (table_gather, trace_api, trace_inst,
                                     trace_mxu, trace_stream, trace_vpu,
                                     traversal, worklist)
from tpu_raytracer_torch.ops.bvh import build_bvh, fill_triangles
from tpu_raytracer_torch.runtime.build import CSRC_DIR
from tpu_raytracer_torch.scene.builder import SceneBuilder
from tpu_raytracer_torch.scene.geometry import create_plane, create_sphere
from tpu_raytracer_torch.scene.material import Material
from tpu_raytracer_torch.utils import profiling
from tpu_raytracer_torch.utils.math3d import scale, translation
from tpu_raytracer_torch.utils.vec3 import V3

RAYS = 1024

# The tests run in several worker processes at once: one torch thread each
# keeps them from oversubscribing the cores.
torch.set_num_threads(1)


def _build(out, names, defines=(), edits=None):
    """g++ build of csrc/<name>.cu for each name, the launches rewritten
    for the emulation, into one library in `out`. edits: name -> (old,
    new), a text that occurs once in that source and its replacement (a
    mutant for a test to catch)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the emulated kernels")
    sources = []
    for name in names:
        with open(os.path.join(CSRC_DIR, f"{name}.cu")) as f:
            src = f.read()
        if edits and name in edits:
            old, new = edits[name]
            assert src.count(old) == 1, (name, old)
            src = src.replace(old, new)
        src, n = re.subn(r"(\w+)<<<([^,]+),\s*(\w+),\s*0,.*?>>>\(",
                         r"emu_launch(\1, \2, \3)(", src, flags=re.S)
        assert n == 1, name
        sources.append(out / f"{name}.cpp")
        sources[-1].write_text(src)
    so = out / "libemulated.so"
    subprocess.run(
        [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
         "-pthread", *(f"-D{x}" for x in defines),
         "-I", os.path.join(CSRC_DIR, "host", "emulation"),
         "-I", CSRC_DIR, "-o", str(so), *map(str, sources)],
        check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    signatures = {
        "tpurt_closest_hit": [ptr] * 6 + [i32] * 2 + [ptr] * 3,
        "tpurt_any_hit": [ptr] * 6 + [i32] * 2 + [ptr] * 3,
        "tpurt_stream_closest_hit": [ptr] * 6 + [i32] * 2 + [ptr] * 3,
        "tpurt_stream_any_hit": [ptr] * 6 + [i32] * 2 + [ptr] * 3,
        "tpurt_inst_closest_hit": [ptr] * 9 + [i32] * 3 + [ptr] * 4,
        "tpurt_inst_any_hit": [ptr] * 9 + [i32] * 3 + [ptr] * 4,
        "tpurt_vpu_closest_hit": [ptr] * 6 + [i32] * 3 + [ptr] * 3,
        "tpurt_mxu_closest_hit": [ptr] * 6 + [i32] * 5 + [ptr] * 3,
        "tpurt_mxu_any_hit": [ptr] * 6 + [i32] * 3 + [ptr] * 3,
        "tpurt_table_gather": [ptr] * 2 + [i32] * 3 + [ptr] * 2,
        "tpurt_bvh_closest_hit": [ptr] * 7 + [i32] * 2 + [ptr] * 3,
        "tpurt_bvh_any_hit": [ptr] * 7 + [i32] * 2 + [ptr] * 3,
        "tpurt_mark": [i32, ptr, i32, ptr],
        "tpurt_path_prime": [ptr] * 2,
        "tpurt_path_bounce": [ptr, i32, ptr],
        "tpurt_path_finish": [ptr] * 2,
        "tpurt_post": [ptr] * 2,
        "tpurt_spatial_tap": [ptr, i32, ptr],
        "tpurt_spatial_close": [ptr] * 2,
        "tpurt_spatial_finish": [ptr] * 2,
    }
    for name, argtypes in signatures.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.restype = i32
            fn.argtypes = argtypes
    return lib


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return _build(tmp_path_factory.mktemp("emulated"),
                  ("trace", "trace_stream", "trace_inst", "trace_vpu",
                   "trace_mxu", "gather", "trace_bvh", "marks"))


def _rays(seed, lo, hi, t_far):
    g = np.random.default_rng(seed)
    o = g.uniform(lo, hi, (3, RAYS)).astype(np.float32)
    d = g.standard_normal((3, RAYS)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    t_max = g.uniform(0.01, t_far, RAYS).astype(np.float32)
    t_max[g.uniform(size=RAYS) < 0.3] = 0.0          # dead lanes
    return (torch.from_numpy(o), torch.from_numpy(d),
            torch.full((RAYS,), 1e-3), torch.from_numpy(t_max))


def _check(got, want, t_max, any_hit):
    if any_hit:
        assert torch.equal(got["tri"] >= 0, want["tri"] >= 0)
        assert torch.equal(got["t"], t_max)
        if "inst" in got:
            assert torch.equal(got["inst"] >= 0, want["tri"] >= 0)
        return
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert (want["tri"] >= 0).any()


SMALL_SWEPT = 8     # K1/K2's capacity in the small build (units of 2, 32)


@pytest.fixture(scope="module")
def swept_small(tmp_path_factory):
    """K1/K2 built with 8 units (TPURT_SWEPT_MAX_UNITS): Cornell's 11
    chunks then make units of 2, the last one short, and the 256-chunk
    table units of 32, a full segment each (the default, 32 units,
    sweeps Cornell chunk by chunk and the 256-chunk table in units of
    8)."""
    return _build(tmp_path_factory.mktemp("emulated_swept_units"),
                  ("trace",), (f"TPURT_SWEPT_MAX_UNITS={SMALL_SWEPT}",))


def _swept_table(name, layered):
    """(planes, aabb, rays) of a table on K1/K2's route: the diffuse
    Cornell box (1 chunk), the Cornell box (11 chunks), or the layered
    scene's first MXUF_MAX_TP slots (256 chunks, the route's cap; both
    TIE_IDS in range)."""
    if name == "max":
        planes, aabb, _ = layered
        nc = trace_api.MXUF_MAX_TP // trace_api.CT
        return (planes[:, :, :trace_api.MXUF_MAX_TP].contiguous(),
                aabb[:nc].contiguous(), _layered_rays(layered, "random"))
    scene = (scenes.create_cornell_box_diffuse("cpu") if name == "diffuse"
             else scenes.create_cornell_box("cpu"))
    return scene.tri_planes, scene.chunk_aabb, _rays(0, -0.95, 0.95, 3.0)


@pytest.mark.parametrize("any_hit", [False, True], ids=["K1", "K2"])
@pytest.mark.parametrize("build", ["default", "units8"])
@pytest.mark.parametrize("table,chunks", [("diffuse", 1), ("cornell", 11),
                                          ("max", 256)])
def test_flattened_kernels_match_plain(request, layered, table, chunks,
                                       build, any_hit):
    """K1/K2 equal the plain chunk scan on every lane, on tables of 1, 11
    and 256 chunks, at the default unit capacity and at 8 units."""
    planes, aabb, (o, d, t_min, t_max) = _swept_table(table, layered)
    assert aabb.shape[0] == chunks
    lib = request.getfixturevalue("lib" if build == "default"
                                  else "swept_small")
    want = trace_api.trace_plain(planes, aabb, V3(*o), V3(*d), t_min, t_max)
    fn = lib.tpurt_any_hit if any_hit else lib.tpurt_closest_hit
    got = _run_flat(fn, planes, aabb, o, d, t_min, t_max)
    _check(got, want, t_max, any_hit)


@pytest.fixture(scope="module")
def layered():
    return layered_scene()


def _run_flat(fn, planes, aabb, o, d, t_min, t_max):
    n = o.shape[1]
    t = torch.empty(n)
    tri = torch.empty(n, dtype=torch.int32)
    err = fn(o.data_ptr(), d.data_ptr(), t_min.data_ptr(), t_max.data_ptr(),
             planes.data_ptr(), aabb.data_ptr(), n, planes.shape[2],
             t.data_ptr(), tri.data_ptr(), None)
    assert err == 0
    return {"t": t, "tri": tri}


def _layered_rays(layered, rays):
    planes, aabb, coherent = layered
    if rays == "random":
        o, d, t_min, t_max = _rays(2, -3.0, 3.0, 12.0)
        o[2] -= 2.0
        return o, d, t_min, t_max
    return coherent


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("rays", ["random", "coherent"])
def test_streamed_kernel_matches_plain(lib, layered, rays, any_hit):
    """K3 on the layered scene past MXUF_MAX_TP slots: random rays, and
    the coherent rays whose blocks leave early and hit the exact-t tie
    across two units (tests/test_torch_dense.py:layered_scene)."""
    planes, aabb, _ = layered
    o, d, t_min, t_max = _layered_rays(layered, rays)
    want = trace_stream.trace_stream_plain(planes, aabb, V3(*o), V3(*d),
                                           t_min, t_max, any_hit=any_hit)
    fn = (lib.tpurt_stream_any_hit if any_hit
          else lib.tpurt_stream_closest_hit)
    got = _run_flat(fn, planes, aabb, o, d, t_min, t_max)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert (want["tri"] >= 0).any()


@pytest.fixture(scope="module", params=[16, 8], ids=["grp32", "grp64"])
def small_worklist(request, tmp_path_factory):
    """K3 built with 16 or 8 units: the layered scene's 257 chunks then
    make units of 32 or 64 chunks, the last one short (the default, 64
    units, makes units of 8)."""
    out = tmp_path_factory.mktemp(f"emulated_units{request.param}")
    return request.param, _build(out, ("trace_stream",),
                                 (f"TPURT_MAX_UNITS={request.param}",))


def _last_chunk_rays(planes, seed, n=128):
    """n rays down from z = 9.5, above the layered scene, each at the
    centroid of one triangle of the last chunk: they hit the top slab in
    that chunk or beside it."""
    g = np.random.default_rng(seed)
    tris = planes[:, :, -trace_api.CT:]
    target = tris[0][:, :n] + (tris[1][:, :n] + tris[2][:, :n]) / 3
    o = target.clone()
    o[0:2] += torch.from_numpy(
        g.uniform(-0.3, 0.3, (2, n)).astype(np.float32))
    o[2] = 9.5
    d = target - o
    d /= d.norm(dim=0, keepdim=True)
    return o, d, torch.full((n,), 1e-3), torch.full((n,), 12.0)


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("rays", ["random", "coherent"])
def test_streamed_kernel_multi_chunk_units(small_worklist, layered,
                                           monkeypatch, rays, any_hit):
    """K3 with units of several chunks equals its twin under the same cap
    and the chunk scan. The random rays are one block of random rays and
    one aimed at the short last unit, which some of them hit."""
    max_units, slib = small_worklist
    monkeypatch.setattr(trace_stream, "MAX_UNITS", max_units)
    planes, aabb, _ = layered
    nc = planes.shape[2] // trace_api.CT
    grp, units = trace_stream.stream_units(nc)
    assert grp == {16: 32, 8: 64}[max_units] and nc % grp
    o, d, t_min, t_max = _layered_rays(layered, rays)
    if rays == "random":
        o, d, t_min, t_max = (
            torch.cat([a[..., :128], b], dim=-1).contiguous()
            for a, b in zip((o, d, t_min, t_max),
                            _last_chunk_rays(planes, 3)))
    want = trace_stream.trace_stream_plain(planes, aabb, V3(*o), V3(*d),
                                           t_min, t_max, any_hit=any_hit)
    scan = trace_api.trace_plain(planes, aabb, V3(*o), V3(*d), t_min, t_max)
    fn = (slib.tpurt_stream_any_hit if any_hit
          else slib.tpurt_stream_closest_hit)
    got = _run_flat(fn, planes, aabb, o, d, t_min, t_max)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    _check(got, scan, t_max, any_hit)
    if rays == "random":      # hits in the last, short unit's chunk
        assert (scan["tri"] >= (units - 1) * grp * trace_api.CT).any()


IN_CHUNK_TIE = TIE_IDS[0] + 35      # a copy of the tie triangle, same chunk


def _stream_case(layered, case):
    """(planes, aabb, rays) of one edge case on the layered scene (K3's)
    or on its first 256 chunks (K1's)."""
    planes, aabb, coherent = layered
    if case == "tie_in_chunk":
        # two copies of one triangle in one chunk: two threads race on
        # each lane's key and the lower id must win
        planes = planes.clone()
        planes[:, :, IN_CHUNK_TIE] = planes[:, :, TIE_IDS[0]]
        return planes, aabb, coherent
    if case == "coherent":          # the exact-t tie across two units
        return planes, aabb, coherent
    if case == "one_lane":          # exactly one lane wants each chunk
        o, d, t_min, t_max = _last_chunk_rays(planes, 4)
        t_max = torch.where(torch.arange(o.shape[1]) == 7, t_max, 0.0)
        return planes, aabb, (o, d, t_min, t_max)
    o, d, t_min, t_max = _layered_rays(layered, "random")
    n = 300 if case == "ragged" else 0       # R % 128 != 0, and R = 0
    return planes, aabb, tuple(x[..., :n].contiguous()
                               for x in (o, d, t_min, t_max))


def _entry_tie_table():
    """Two chunks that hold one triangle (z = 0, under x + y <= 0 in
    [-1, 1]^2): chunk 0 in all its 128 slots, chunk 1 in slot 128, beside
    a triangle at z = 2 out of the rays' way that stretches chunk 1's box
    toward them, so the block enters chunk 1 first. _tie_rays (straight
    down from z = 64), moved under the triangle so that every lane hits
    it, enter chunk 0's flat box exactly at the hit, t = 64 (its padding
    is below the rounding of 64 - 1e-6): an exit that is not strict, or a
    test window narrowed to the best t, gives the tie to slot 128; the
    plain scan gives it to slot 0."""
    tri = ([-1, -1, 0], [2, 0, 0], [0, 2, 0])
    side = ([3, 3, 2], [1, 0, 0], [0, 1, 0])
    v0, e1, e2 = (np.float32(x) for x in zip(*([tri] * 129 + [side])))
    planes, aabb = trace_api.pack_triangles(v0, e1, e2)
    o, d, t_min, t_max = _tie_rays()
    above = o[0] + o[1] > 0
    o[0:2, above] = -o[0:2, above].flip(0)      # (x, y) -> (-y, -x)
    return (torch.from_numpy(planes), torch.from_numpy(aabb),
            (o, d, t_min, t_max))


@pytest.mark.parametrize("any_hit", [False, True], ids=["K1", "K2"])
@pytest.mark.parametrize("case", ["tie_in_chunk", "tie_across_chunks",
                                  "tie_at_entry", "one_lane", "ragged",
                                  "empty"])
def test_swept_kernel_edge_cases(lib, layered, case, any_hit):
    """K1/K2 equal the plain chunk scan on every lane, on the 256-chunk
    table (units of 8 chunks): an exact-t tie inside one chunk, an
    exact-t tie across two chunks whose units the block enters higher id
    first, a block with one live lane, a ragged last block, and R = 0 (no
    launch, nothing written); and an exact-t tie across two chunks where
    the lower id's chunk is entered last, exactly at the hit."""
    planes, aabb, _ = _swept_table("max", layered)
    if case == "tie_at_entry":
        planes, aabb, (o, d, t_min, t_max) = _entry_tie_table()
    else:
        planes, aabb, (o, d, t_min, t_max) = _stream_case(
            (planes, aabb, layered[2]),
            "coherent" if case == "tie_across_chunks" else case)
    fn = lib.tpurt_any_hit if any_hit else lib.tpurt_closest_hit
    if case == "empty":
        _check_empty(fn, planes, aabb, o, d, t_min, t_max)
        return
    want = trace_api.trace_plain(planes, aabb, V3(*o), V3(*d), t_min, t_max)
    got = _run_flat(fn, planes, aabb, o, d, t_min, t_max)
    _check(got, want, t_max, any_hit)
    if case in ("tie_in_chunk", "tie_across_chunks"):
        assert (want["tri"] == TIE_IDS[0]).sum() > 10
        assert not (want["tri"] == {"tie_in_chunk": IN_CHUNK_TIE,
                                    "tie_across_chunks": TIE_IDS[1]}[case]
                    ).any()
    if case == "tie_across_chunks":
        # the block enters the higher id's unit first
        grp, _ = trace_stream.stream_units(aabb.shape[0],
                                           trace_api.SWEPT_MAX_UNITS)
        boxes = trace_stream.unit_boxes(aabb, grp)
        live = t_max > 0
        e0, e1 = (float(trace_stream._unit_entry(
            boxes[i // trace_api.CT // grp], V3(*o), trace_api.safe_inv_dir(
                V3(*d)), t_min, t_max)[live].min()) for i in TIE_IDS)
        assert grp == 8 and e1 < e0
    if case == "tie_at_entry":
        hit = want["tri"] >= 0
        assert bool(hit.all()) and bool((want["tri"] == 0).all())
        assert bool((want["t"][hit] == 64.0).all())
    if case == "one_lane":
        assert int((t_max > 0).sum()) == 1 and bool(want["tri"][7] >= 0)


def _check_empty(fn, planes, aabb, o, d, t_min, t_max):
    """R = 0: the call returns 0 and writes nothing."""
    t = torch.full((1,), 7.0)
    tri = torch.full((1,), 7, dtype=torch.int32)
    assert fn(o.data_ptr(), d.data_ptr(), t_min.data_ptr(), t_max.data_ptr(),
              planes.data_ptr(), aabb.data_ptr(), 0, planes.shape[2],
              t.data_ptr(), tri.data_ptr(), None) == 0
    assert t.item() == 7.0 and tri.item() == 7


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("case", ["tie_in_chunk", "one_lane", "ragged",
                                  "empty"])
def test_streamed_kernel_edge_cases(lib, layered, case, any_hit):
    """K3 equals its twin and the chunk scan on every lane: an exact-t tie
    inside one chunk, a block with one live lane, a ragged last block, and
    R = 0 (no launch, nothing written)."""
    planes, aabb, (o, d, t_min, t_max) = _stream_case(layered, case)
    fn = (lib.tpurt_stream_any_hit if any_hit
          else lib.tpurt_stream_closest_hit)
    if case == "empty":
        _check_empty(fn, planes, aabb, o, d, t_min, t_max)
        return
    want = trace_stream.trace_stream_plain(planes, aabb, V3(*o), V3(*d),
                                           t_min, t_max, any_hit=any_hit)
    scan = trace_api.trace_plain(planes, aabb, V3(*o), V3(*d), t_min, t_max)
    got = _run_flat(fn, planes, aabb, o, d, t_min, t_max)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    _check(got, scan, t_max, any_hit)
    if case == "tie_in_chunk":
        assert (scan["tri"] == TIE_IDS[0]).sum() > 10
        assert not (scan["tri"] == IN_CHUNK_TIE).any()
    if case == "one_lane":
        assert int((t_max > 0).sum()) == 1 and bool(scan["tri"][7] >= 0)


@pytest.fixture(scope="module")
def galleries():
    return {"mini": scenes.create_instancing_gallery_scene("cpu", n=9,
                                                           subdiv=2),
            "full": scenes.create_instancing_gallery_scene("cpu")}


FOLDED_UNITS = 4        # the mini gallery's 11 instances: units of 4, 4, 3


@pytest.fixture(scope="module")
def folded_lib(tmp_path_factory):
    """K4 built with 4 units (TPURT_INST_MAX_UNITS), so that its units
    hold several instances (the default, 128, holds the gallery's 102
    one by one)."""
    return _build(tmp_path_factory.mktemp("emulated_inst_units"),
                  ("trace_inst",), (f"TPURT_INST_MAX_UNITS={FOLDED_UNITS}",))


@pytest.fixture(scope="module")
def sphere5():
    """A floor and three instances of create_sphere(5): 80 groups of 256
    triangles a sphere, so its groups fill three mask segments of 32."""
    b = SceneBuilder()
    plane_id = b.add_mesh(create_plane())
    sphere_id = b.add_mesh(create_sphere(5))
    mat = b.add_material(Material((0.7, 0.7, 0.7, 1.0)))
    b.add_instance(plane_id, mat, translation([0, -1, 0]) @ scale(8.0))
    for k in range(3):
        b.add_instance(sphere_id, mat,
                       translation([1.5 * (k - 1), -0.4, 0.3 * k])
                       @ scale(0.6))
    return b.build("cpu", instancing="on")


def _tie_scene():
    """Two instances of two meshes, both holding one triangle (z = 0,
    under x + y <= 0 in [-1, 1]^2) at the same world place. Mesh 1 also
    holds a triangle at z = 2, beside the rays, that stretches its box
    toward them: instance 1 sorts before instance 0. Rays straight down
    from z = 64 enter instance 0's box exactly at the hit, t = 64 (the
    box's padding is below the rounding of 64 - 1e-6), so an exit that
    is not strict, or a fold that prefers the higher key, gives the tie
    to instance 1; the reference gives it to instance 0."""
    tri = (np.float32([[-1, -1, 0]]), np.float32([[2, 0, 0]]),
           np.float32([[0, 2, 0]]))
    side = (np.float32([[3, 3, 2]]), np.float32([[1, 0, 0]]),
            np.float32([[0, 1, 0]]))
    meshes = [tri, tuple(np.concatenate([a, b]) for a, b in zip(tri, side))]
    planes, gaabb, spans = trace_inst.pack_triangles_instanced(meshes)
    table = np.zeros((2, trace_inst.INST_COLS), np.float32)
    table[:, 0:9] = np.eye(3, dtype=np.float32).reshape(-1)   # identity
    boxes = np.float32([[-1, -1, 0, 1, 1, 0, 0, 0],
                        [-1, -1, 0, 4, 4, 2, 0, 0]])
    t = torch.from_numpy
    return types.SimpleNamespace(
        tri_planes=t(planes), obj_group_aabb=t(gaabb), inst_table=t(table),
        inst_aabb=t(boxes), inst_group_span=t(spans.copy()),
        unit_inst=t(np.int32([0, 1])), unit_group=t(np.int32([0, 1])))


def _tie_rays(n=256):
    g = np.random.default_rng(5)
    o = np.zeros((3, n), np.float32)
    o[0:2] = g.uniform(-0.9, 0.9, (2, n))
    o[2] = 64.0
    d = np.zeros((3, n), np.float32)
    d[2] = -1.0
    return (torch.from_numpy(o), torch.from_numpy(d),
            torch.full((n,), 1e-3), torch.full((n,), 100.0))


def _inst_case(request, galleries, which):
    """(scene, rays, library) of one K4 case."""
    o, d, t_min, t_max = _rays(1, -7.0, 7.0, 20.0)
    o[1] = o[1].clamp(-0.9, 3.0)
    lib = request.getfixturevalue("lib")
    if which in ("mini", "full"):
        return galleries[which], (o, d, t_min, t_max), lib
    g = galleries["mini"]
    if which == "folded":
        return g, (o, d, t_min, t_max), request.getfixturevalue("folded_lib")
    if which == "sphere5":
        o, d, t_min, t_max = _rays(6, -3.0, 3.0, 8.0)
        o[1] = o[1].clamp(-0.9, 2.0)
        return request.getfixturevalue("sphere5"), (o, d, t_min, t_max), lib
    if which == "tie":
        return _tie_scene(), _tie_rays(), lib
    if which == "one_lane":     # one live lane in a block: one that hits
        want = trace_inst.trace_instanced_plain(
            g.tri_planes, g.obj_group_aabb, g.inst_table, g.inst_aabb,
            g.unit_inst, g.unit_group, V3(*o), V3(*d), t_min, t_max)
        h = int(torch.nonzero(want["tri"] >= 0)[0])
        lanes = torch.full((128,), h)
        t_max = torch.where(torch.arange(128) == 7, t_max[h], 0.0)
        return g, (o[:, lanes].contiguous(), d[:, lanes].contiguous(),
                   t_min[:128].contiguous(), t_max), lib
    n = 300 if which == "ragged" else 0     # R % 128 != 0, and R = 0
    return g, tuple(x[..., :n].contiguous() for x in (o, d, t_min, t_max)), \
        lib


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("which", ["mini", "full", "folded", "sphere5",
                                   "ragged", "one_lane", "empty", "tie"])
def test_instanced_kernel_matches_plain(request, galleries, which, any_hit):
    """K4 equals the plain instanced scan on every lane: the mini and full
    galleries, units of several instances, a mesh of 80 groups, a ragged
    last block with dead lanes, a block with one live lane, R = 0 (no
    launch, nothing written), and an exact-t tie across instances that
    the front-to-back order visits in reverse."""
    g, (o, d, t_min, t_max), lib = _inst_case(request, galleries, which)
    if which == "folded":
        monkeypatch = request.getfixturevalue("monkeypatch")
        monkeypatch.setattr(trace_inst, "MAX_UNITS", FOLDED_UNITS)
        assert trace_inst.inst_units(g.inst_table.shape[0]) == (4, 3)
    n = o.shape[1]
    t = torch.full((max(n, 1),), 7.0)
    tri = torch.full((max(n, 1),), 7, dtype=torch.int32)
    inst = torch.full((max(n, 1),), 7, dtype=torch.int32)
    fn = lib.tpurt_inst_any_hit if any_hit else lib.tpurt_inst_closest_hit
    err = fn(o.data_ptr(), d.data_ptr(), t_min.data_ptr(), t_max.data_ptr(),
             g.tri_planes.data_ptr(), g.obj_group_aabb.data_ptr(),
             g.inst_table.data_ptr(), g.inst_aabb.data_ptr(),
             g.inst_group_span.data_ptr(), n, g.inst_table.shape[0],
             g.obj_group_aabb.shape[1], t.data_ptr(), tri.data_ptr(),
             inst.data_ptr(), None)
    assert err == 0
    if n == 0:
        assert t.item() == 7.0 and tri.item() == 7 and inst.item() == 7
        return
    want = trace_inst.trace_instanced_plain(
        g.tri_planes, g.obj_group_aabb, g.inst_table, g.inst_aabb,
        g.unit_inst, g.unit_group, V3(*o), V3(*d), t_min, t_max)
    _check({"t": t, "tri": tri, "inst": inst}, want, t_max, any_hit)
    if which == "tie":
        hit = want["tri"] >= 0
        assert hit.sum() > 50 and bool((want["inst"][hit] == 0).all())
        assert bool((want["t"][hit] == 64.0).all())
    if which == "one_lane":
        assert int((t_max > 0).sum()) == 1 and bool(want["tri"][7] >= 0)
    if which == "sphere5":
        spans = g.inst_group_span[1]
        assert int(spans.max()) == 80
        assert bool((want["inst"] >= 1).any())


@pytest.fixture(scope="module")
def cornell():
    return scenes.create_cornell_box("cpu")


# (table, rays) of K5's cases: random rays on Cornell's 11 chunks and on
# the 256-chunk table, that table's edge cases, and the two-chunk exact-t
# tie entered at the tie's t
VPU_CASES = [("cornell", "random"), ("max", "random"), ("max", "one_lane"),
             ("max", "ragged"), ("max", "empty"), ("entry_tie", "tie")]


@pytest.mark.parametrize("max_units", [32, 64], ids=["units32", "units64"])
@pytest.mark.parametrize("table,case", VPU_CASES,
                         ids=[f"{t}-{c}" for t, c in VPU_CASES])
def test_vpu_kernel_matches_plain(lib, layered, cornell, table, case,
                                  max_units):
    """K5, the sweep of csrc/sweep.cuh at each unit capacity it takes,
    equals its plain version (the worklists of `trace_vpu.vpu_worklists`)
    and K1's plain scan on every lane: tri equal, t bit-equal; R = 0
    launches nothing and writes nothing, and a capacity it has no
    instance for is refused."""
    if table == "entry_tie":
        planes, aabb, (o, d, t_min, t_max) = _entry_tie_table()
    elif table == "cornell":
        planes, aabb = cornell.tri_planes, cornell.chunk_aabb
        o, d, t_min, t_max = _rays(0, -0.95, 0.95, 3.0)
    else:
        planes, aabb, rays = _swept_table("max", layered)
        planes, aabb, (o, d, t_min, t_max) = _stream_case(
            (planes, aabb, rays), case)
        if case == "random":
            o, d, t_min, t_max = rays
    def k5(*args, units=max_units):
        return lib.tpurt_vpu_closest_hit(*args[:8], units, *args[8:])

    if case == "empty":
        _check_empty(k5, planes, aabb, o, d, t_min, t_max)
        assert k5(o.data_ptr(), d.data_ptr(), t_min.data_ptr(),
                  t_max.data_ptr(), planes.data_ptr(), aabb.data_ptr(), 0,
                  planes.shape[2], None, None, None, units=16) != 0
        return
    counts, chunk_list = trace_vpu.vpu_worklists(aabb, V3(*o), V3(*d),
                                                 t_min, t_max)
    want = trace_vpu.trace_vpu_plain(planes, counts, chunk_list, V3(*o),
                                     V3(*d), t_min, t_max)
    got = _run_flat(k5, planes, aabb, o, d, t_min, t_max)
    _check(got, want, t_max, False)
    _check(want, trace_api.trace_plain(planes, aabb, V3(*o), V3(*d), t_min,
                                       t_max), t_max, False)
    if case == "tie":
        assert bool((want["tri"] == 0).all())
    if case == "one_lane":
        assert int((t_max > 0).sum()) == 1 and bool(want["tri"][7] >= 0)


# (mode, grp, passes, incull, any_hit): every K6 variant a route takes, on
# Cornell's 11 chunks (mxuw's hulls of 8 and incull's groups of 2 end short)
K6_VARIANTS = [("mxu3", 1, 3, False, False), ("mxu1", 1, 1, False, False),
               ("mxuw", 8, 3, False, False), ("incull", 2, 3, True, False),
               ("incull_any", 2, 3, True, True)]


def _k6_rays(case, scene):
    """Cornell rays of one K6 case: RAYS random rays ("random"), a block whose second warp is live but misses every
    box ("idle_warp"), one live lane that hits ("one_lane"), R = 300
    ("ragged") and R = 0 ("empty")."""
    o, d, t_min, t_max = _rays(0, -0.95, 0.95, 3.0)
    if case == "idle_warp":
        o, d, t_min, t_max = (x[..., :128].clone() for x in (o, d, t_min,
                                                           t_max))
        o[:, 32:64] = torch.tensor([[0.0], [0.0], [50.0]])
        d[:, 32:64] = torch.tensor([[0.0], [0.0], [1.0]])
        t_max[32:64] = 3.0
    elif case == "one_lane":
        t_max = torch.full_like(t_max, 3.0)
        hit = trace_api.trace_plain(scene.tri_planes, scene.chunk_aabb,
                                    V3(*o), V3(*d), t_min, t_max)["tri"]
        lanes = torch.full((128,), int(torch.nonzero(hit >= 0)[0]))
        o, d = o[:, lanes].contiguous(), d[:, lanes].contiguous()
        t_min = t_min[:128].contiguous()
        t_max = torch.where(torch.arange(128) == 7, 3.0, 0.0)
    elif case != "random":
        n = 300 if case == "ragged" else 0
        o, d, t_min, t_max = (x[..., :n].contiguous()
                              for x in (o, d, t_min, t_max))
    return o, d, t_min, t_max


@pytest.mark.parametrize("case", ["random", "idle_warp", "one_lane",
                                  "ragged", "empty"])
@pytest.mark.parametrize("mode,grp,passes,incull,any_hit", K6_VARIANTS,
                         ids=[v[0] for v in K6_VARIANTS])
def test_mxu_kernel_matches_plain(lib, cornell, mode, grp, passes, incull,
                                  any_hit, case):
    """K6 under the emulation's mma (exact products summed in f64, one
    rounding, as the plain version sums them) equals its plain version
    over the kernel's own (lane, chunk) set, `trace_mxu.lane_chunks`, bit
    for bit: the table's fragment layout, the units built in the kernel,
    the compacted row tiles, the division after the test, the folds and
    the any-hit exit all match. Also a block whose second warp wants no
    unit, one live lane, R = 300 and R = 0 (no launch, nothing
    written)."""
    o, d, t_min, t_max = _k6_rays(case, cornell)
    table = trace_mxu.kernel_table(cornell.tri_planes)
    nc = cornell.chunk_aabb.shape[0]
    n = o.shape[1]
    t = torch.full((max(n, 1),), 7.0)
    tri = torch.full((max(n, 1),), 7, dtype=torch.int32)
    common = (o.data_ptr(), d.data_ptr(), t_min.data_ptr(), t_max.data_ptr(),
              table.data_ptr(), cornell.chunk_aabb.data_ptr(), n, nc, grp)
    if any_hit:
        err = lib.tpurt_mxu_any_hit(*common, t.data_ptr(), tri.data_ptr(),
                                    None)
    else:
        err = lib.tpurt_mxu_closest_hit(*common, passes, int(incull),
                                        t.data_ptr(), tri.data_ptr(), None)
    assert err == 0
    if n == 0:
        assert t.item() == 7.0 and tri.item() == 7
        return
    chunks = trace_mxu.lane_chunks(cornell.chunk_aabb, grp, incull, V3(*o),
                                   V3(*d), t_min, t_max)
    want = trace_mxu.trace_mxu_plain(table, chunks, V3(*o), V3(*d), t_min,
                                     t_max, passes, any_hit)
    got = {"t": t, "tri": tri}
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert (want["tri"] >= 0).any()
    if case == "idle_warp":
        assert not chunks[32:64].any() and chunks[:32].any()
    if case == "one_lane":
        assert int(chunks.any(dim=1).sum()) == 1


@pytest.mark.parametrize("grp,passes", [(1, 3), (1, 1), (4, 3)],
                         ids=["mxu3", "mxu1", "mxuw4"])
def test_mxu_kernel_hulls(lib, layered, grp, passes):
    """K6 on the 256-chunk table, whose chunks it tests through hulls of
    8 chunks first (at most 32 hulls; mxuw4's units of 4 grow to 8):
    equal to its plain version bit for bit on random rays, so a hull
    never drops a chunk that a lane's window passes."""
    planes, aabb, (o, d, t_min, t_max) = _swept_table("max", layered)
    o, d, t_min, t_max = (x[..., :128].contiguous()
                          for x in (o, d, t_min, t_max))
    table = trace_mxu.kernel_table(planes)
    n = o.shape[1]
    t = torch.empty(n)
    tri = torch.empty(n, dtype=torch.int32)
    assert lib.tpurt_mxu_closest_hit(
        o.data_ptr(), d.data_ptr(), t_min.data_ptr(), t_max.data_ptr(),
        table.data_ptr(), aabb.data_ptr(), n, aabb.shape[0], grp, passes, 0,
        t.data_ptr(), tri.data_ptr(), None) == 0
    chunks = trace_mxu.lane_chunks(aabb, grp, False, V3(*o), V3(*d), t_min,
                                   t_max)
    want = trace_mxu.trace_mxu_plain(table, chunks, V3(*o), V3(*d), t_min,
                                     t_max, passes)
    assert torch.equal(t, want["t"]) and torch.equal(tri, want["tri"])
    assert (want["tri"] >= 0).any() and chunks.shape[1] > 32


@pytest.mark.parametrize("c,r", [(15, 1000), (23, 513), (35, 300), (35, 0)])
def test_table_gather_kernel_matches_plain(lib, c, r):
    """K7 on a table of integer bit patterns and floats of every exponent
    (NaN patterns included): bit-equal to the plain version, with the
    last block of 256 rays ragged, negative and too-large indices
    clamped, and nothing written for R = 0."""
    g = np.random.default_rng(c)
    m = 700
    bits = g.integers(0, 2 ** 32, (m, c), dtype=np.uint64).astype(np.uint32)
    table = torch.from_numpy(bits.view(np.float32))
    idx = torch.from_numpy(g.integers(-40, m + 40, r).astype(np.int32))
    want = table_gather.table_gather_plain(table, idx)
    got = torch.full((c, r), 7.0)
    err = lib.tpurt_table_gather(table.data_ptr(), idx.data_ptr(), m, c, r,
                                 got.data_ptr(), None)
    assert err == 0
    assert np.array_equal(got.numpy().view(np.uint32),
                          want.numpy().view(np.uint32))


def test_mark_kernels_write_their_stamps(lib):
    """The stage marks (csrc/marks.cu), one a stage in
    `profiling.STAGES`' order: each writes the global timer into its
    slot of the stamp row, so a frame's stamps come out in slot order
    and non-decreasing; none writes through a null row; an unknown stage
    launches nothing and returns cudaErrorInvalidValue (1)."""
    with open(os.path.join(CSRC_DIR, "marks.cu")) as f:
        src = f.read()
    table = re.search(r"MARKS\[\] = \{(.*?)\};", src, re.S).group(1)
    assert re.findall(r"tpurt_mark_(\w+)", table) == list(profiling.STAGES)
    n = len(profiling.STAGES)
    stamps = torch.zeros(n + 2, dtype=torch.int64)
    for slot in range(n):
        assert lib.tpurt_mark(slot, stamps.data_ptr(), slot, None) == 0
        assert lib.tpurt_mark(slot, None, slot, None) == 0
    t = stamps[:n]
    assert (t > 0).all() and (t[1:] >= t[:-1]).all()
    assert not stamps[n:].any()
    before = stamps.clone()
    for stage in (-1, n):
        assert lib.tpurt_mark(stage, stamps.data_ptr(), n, None) == 1
    assert torch.equal(stamps, before)


def _bvh_stream(table):
    """(bvh_rec, bvh_skip, bvh_tri, rays) of the Cornell box built to walk
    (brute_max=1), or of a tree over 300 random triangles."""
    if table == "cornell":
        scene = scenes.create_cornell_box("cpu", brute_max=1)
        return (scene.bvh_rec, scene.bvh_skip, scene.bvh_tri,
                _rays(4, -0.95, 0.95, 3.0))
    g = np.random.default_rng(2)
    v0 = ((g.random((300, 3), np.float32) - 0.5) * 4.0).astype(np.float32)
    e1, e2 = ((g.random((300, 3), np.float32) - 0.5).astype(np.float32)
              for _ in range(2))
    v1, v2 = v0 + e1, v0 + e2
    tree = build_bvh(np.minimum(np.minimum(v0, v1), v2),
                     np.maximum(np.maximum(v0, v1), v2))
    fill_triangles(tree, v0, e1, e2)
    return (torch.from_numpy(tree.rec), torch.from_numpy(tree.skip),
            torch.from_numpy(tree.tri_id), _rays(5, -2.0, 2.0, 12.0))


PAGE = mmap.PAGESIZE
_LIBC = ctypes.CDLL(None, use_errno=True)
_LIBC.mprotect.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int]


def _guarded(x):
    """A copy of tensor x that ends where an unreadable page begins, so a
    read past its last element faults; the mapping lives as long as the
    returned tensor."""
    a = np.ascontiguousarray(x.numpy())
    size = -(-a.nbytes // PAGE) * PAGE
    mm = mmap.mmap(-1, size + PAGE)
    addr = ctypes.addressof(ctypes.c_char.from_buffer(mm))
    assert _LIBC.mprotect(addr + size, PAGE, 0) == 0    # PROT_NONE
    view = np.frombuffer(mm, a.dtype, a.size, size - a.nbytes)
    view[...] = a.reshape(-1)
    out = torch.from_numpy(view.reshape(a.shape))
    out._guard = mm
    return out


def _run_bvh(fn, rec, skip, tri, o, d, t_min, t_max):
    """K8 on these rays, its stream's three arrays each ending at an
    unreadable page (a read past record S - 1 faults)."""
    rec, skip, tri = map(_guarded, (rec, skip, tri))
    n = o.shape[1]
    t = torch.full((n,), 7.0)
    out = torch.full((n,), 7, dtype=torch.int32)
    err = fn(o.data_ptr(), d.data_ptr(), t_min.data_ptr(), t_max.data_ptr(),
             rec.data_ptr(), skip.data_ptr(), tri.data_ptr(), n,
             rec.shape[0], t.data_ptr(), out.data_ptr(), None)
    assert err == 0
    return {"t": t, "tri": out}


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("case", ["all", "r300", "one-live", "r0"])
@pytest.mark.parametrize("table", ["cornell", "random"])
def test_bvh_kernel_matches_plain(lib, table, case, any_hit):
    """K8 (the default build) against the plain walk: every word of t and
    tri equal, on all the rays (30% dead), on 300 (a ragged last block),
    with one live lane, and with none (R = 0, nothing written)."""
    rec, skip, tri, (o, d, t_min, t_max) = _bvh_stream(table)
    if case == "r300":
        o, d, t_min, t_max = (x[..., :300].contiguous()
                              for x in (o, d, t_min, t_max))
    elif case == "one-live":
        t_max = torch.where(torch.arange(t_max.numel()) == 77, 3.0, 0.0)
    elif case == "r0":
        o, d, t_min, t_max = (x[..., :0].contiguous()
                              for x in (o, d, t_min, t_max))
    want = traversal.trace_plain(rec, skip, tri, V3(*o), V3(*d), t_min,
                                 t_max, any_hit=any_hit)
    fn = lib.tpurt_bvh_any_hit if any_hit else lib.tpurt_bvh_closest_hit
    got = _run_bvh(fn, rec, skip, tri, o, d, t_min, t_max)
    assert np.array_equal(got["t"].numpy().view(np.int32),
                          want["t"].numpy().view(np.int32))
    assert torch.equal(got["tri"], want["tri"])
    if case in ("all", "r300"):
        assert 0.05 < float((want["tri"] >= 0).float().mean()) < 0.95


# K8's windows (TPURT_BVH_WINDOW), bvh_variants.py's builds
BVH_WINDOWS = (1, 2, 3, 4, 8)


@pytest.fixture(scope="module")
def bvh_build(tmp_path_factory):
    """window -> K8's library built with it, each built once."""
    built = {}

    def get(w):
        if w not in built:
            built[w] = _build(tmp_path_factory.mktemp(f"bvh-w{w}"),
                              ("trace_bvh",), (f"TPURT_BVH_WINDOW={w}",))
        return built[w]
    return get


def _check_bvh(lib, any_hit, rec, skip, tri, o, d, t_min, t_max):
    want = traversal.trace_plain(rec, skip, tri, V3(*o), V3(*d), t_min,
                                 t_max, any_hit=any_hit)
    fn = lib.tpurt_bvh_any_hit if any_hit else lib.tpurt_bvh_closest_hit
    got = _run_bvh(fn, rec, skip, tri, o, d, t_min, t_max)
    assert np.array_equal(got["t"].numpy().view(np.int32),
                          want["t"].numpy().view(np.int32))
    assert torch.equal(got["tri"], want["tri"])
    return want


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("table", ["cornell", "random"])
@pytest.mark.parametrize("w", BVH_WINDOWS)
def test_bvh_builds_match_plain(bvh_build, w, table, any_hit):
    """K8 at every window against the plain walk on all 1,024 rays (30%
    dead), every word of t and tri."""
    rec, skip, tri, rays = _bvh_stream(table)
    _check_bvh(bvh_build(w), any_hit, rec, skip, tri, *rays)


def _windows(path, w, s):
    """The windows a lane of window w loads along one ray's walk (path:
    test_torch_traversal.walk_path's): [(base, records in it, the steps
    taken inside it)]."""
    out = []
    for step in path:
        ptr = step[0]
        if not out or not out[-1][0] <= ptr < out[-1][0] + out[-1][1]:
            out.append((ptr, min(w, s - ptr), []))
        out[-1][2].append(step)
    return out


@pytest.fixture(scope="module")
def bvh_paths():
    """{(case, any_hit): (rec, skip, tri, rays, each live ray's walk
    taken a record at a time)}, made once: "stream-end" aims 48 rays at
    the centroids of the stream's last leaf's triangles, the other cases
    take the first 48 of the random tree's rays."""
    from test_torch_traversal import walk_path

    rec, skip, tri, (o, d, t_min, t_max) = _bvh_stream("random")
    s = rec.shape[0]
    last = [i for i in range(s - 1, -1, -1) if int(skip[i]) >= 0][0]
    v0 = rec[last + 1:, 0:3]
    centroid = v0 + (rec[last + 1:, 3:6] + rec[last + 1:, 6:9]) / 3.0
    g = np.random.default_rng(6)
    n = 48
    ao = torch.from_numpy(g.uniform(-2.0, 2.0, (3, n)).astype(np.float32))
    aim = centroid[torch.arange(n) % centroid.shape[0]].T
    ad = aim - ao
    ad = (ad / torch.linalg.vector_norm(ad, dim=0)).contiguous()
    rays = {"stream-end": (ao, ad, torch.full((n,), 1e-3),
                           torch.full((n,), 12.0)),
            "random": tuple(x[..., :n].contiguous()
                            for x in (o, d, t_min, t_max))}
    out = {}
    for name, (ro, rd, rt_min, rt_max) in rays.items():
        for any_hit in (False, True):
            paths = [walk_path(rec.numpy(), skip.numpy(), ro[:, i].numpy(),
                               rd[:, i].numpy(), float(rt_min[i]),
                               float(rt_max[i]), any_hit)
                     for i in range(n)]
            out[(name, any_hit)] = (rec, skip, tri,
                                    (ro, rd, rt_min, rt_max), paths)
    return out


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("case", ["stream-end", "skips", "mid-window"])
@pytest.mark.parametrize("w", [2, 3, 8])
def test_bvh_window_cases(bvh_build, bvh_paths, w, case, any_hit):
    """What the windows must get right, each shown to occur in the build's
    windows along the rays' own walks (taken a record at a time) and K8
    equal to the plain walk there: walks that load a window clamped at
    the stream's end (the arrays end at an unreadable page); skips that
    land inside the window (past a window of 2) and outside it; a hit
    with records left in its window (any-hit stops there, closest-hit
    goes on)."""
    lib = bvh_build(w)
    rays_of = "stream-end" if case == "stream-end" else "random"
    rec, skip, tri, rays, paths = bvh_paths[(rays_of, any_hit)]
    s = rec.shape[0]
    windows = [x for p in paths for x in _windows(p, w, s)]
    if case == "stream-end":
        assert any(n < w for _, n, _ in windows)
    elif case == "skips":
        jumps = [(base, n, nxt) for base, n, steps in windows
                 for ptr, nxt, _ in steps if nxt != ptr + 1 and nxt < s]
        # a box's skip passes at least its first child: a window of 2
        # holds no skip's target
        assert any(base <= nxt < base + n
                   for base, n, nxt in jumps) == (w > 2)
        assert any(not base <= nxt < base + n for base, n, nxt in jumps)
    else:
        assert any(hit and int(skip[ptr]) < 0 and ptr < base + n - 1
                   for base, n, steps in windows
                   for ptr, _, hit in steps)
    _check_bvh(lib, any_hit, rec, skip, tri, *rays)
