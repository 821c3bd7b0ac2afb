"""The CUDA kernels K1, K2 and K4, built with g++ under the host emulation
`csrc/host/emulation/cuda_runtime.h`, against their plain versions.

A CUDA kernel cannot run here; this holds the kernels' own source (its
control flow, culling, staging and tie order) to the plain versions on
the CPU, so a logic fault shows before a chip run. It says nothing of
what nvcc accepts or of speed: `chip_smoke.py` checks the real build on
the card. Tolerance: tri and inst equal on every lane and t bit-equal
(measured: equal; the emulation's fmaf and -ffp-contract=off round as
the kernels' __fmaf_rn and -fmad=false).
"""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from tpu_raytracer_torch.models import scenes
from tpu_raytracer_torch.ops import trace_api, trace_inst
from tpu_raytracer_torch.runtime.build import CSRC_DIR
from tpu_raytracer_torch.utils.vec3 import V3

RAYS = 1024

# The tests run in several worker processes at once: one torch thread each
# keeps them from oversubscribing the cores.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the emulated kernels")
    out = tmp_path_factory.mktemp("emulated")
    sources = []
    for name in ("trace", "trace_inst"):
        with open(os.path.join(CSRC_DIR, f"{name}.cu")) as f:
            src = f.read()
        src, n = re.subn(r"(\w+)<<<([^,]+),\s*(\w+),\s*0,.*?>>>\(",
                         r"emu_launch(\1, \2, \3)(", src, flags=re.S)
        assert n == 1, name
        sources.append(out / f"{name}.cpp")
        sources[-1].write_text(src)
    so = out / "libemulated.so"
    subprocess.run(
        [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
         "-pthread", "-I", os.path.join(CSRC_DIR, "host", "emulation"),
         "-I", CSRC_DIR, "-o", str(so), *map(str, sources)],
        check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.tpurt_closest_hit, lib.tpurt_any_hit):
        fn.restype = i32
        fn.argtypes = [ptr] * 6 + [i32] * 2 + [ptr] * 3
    for fn in (lib.tpurt_inst_closest_hit, lib.tpurt_inst_any_hit):
        fn.restype = i32
        fn.argtypes = [ptr] * 9 + [i32] * 3 + [ptr] * 4
    return lib


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


@pytest.mark.parametrize("any_hit", [False, True], ids=["K1", "K2"])
def test_flattened_kernels_match_plain(lib, any_hit):
    scene = scenes.create_cornell_box("cpu")
    o, d, t_min, t_max = _rays(0, -0.95, 0.95, 3.0)
    want = trace_api.trace_plain(scene.tri_planes, scene.chunk_aabb, V3(*o),
                                 V3(*d), t_min, t_max)
    t = torch.empty(RAYS)
    tri = torch.empty(RAYS, dtype=torch.int32)
    fn = lib.tpurt_any_hit if any_hit else lib.tpurt_closest_hit
    err = fn(o.data_ptr(), d.data_ptr(), t_min.data_ptr(), t_max.data_ptr(),
             scene.tri_planes.data_ptr(), scene.chunk_aabb.data_ptr(), RAYS,
             scene.tri_planes.shape[2], t.data_ptr(), tri.data_ptr(), None)
    assert err == 0
    _check({"t": t, "tri": tri}, want, t_max, any_hit)


@pytest.fixture(scope="module")
def galleries():
    return {"mini": scenes.create_instancing_gallery_scene("cpu", n=9,
                                                           subdiv=2),
            "full": scenes.create_instancing_gallery_scene("cpu")}


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("which", ["mini", "full"])
def test_instanced_kernel_matches_plain(lib, galleries, which, any_hit):
    g = galleries[which]
    o, d, t_min, t_max = _rays(1, -7.0, 7.0, 20.0)
    o[1] = o[1].clamp(-0.9, 3.0)
    want = trace_inst.trace_instanced_plain(
        g.tri_planes, g.obj_group_aabb, g.inst_table, g.inst_aabb,
        g.unit_inst, g.unit_group, V3(*o), V3(*d), t_min, t_max)
    t = torch.empty(RAYS)
    tri = torch.empty(RAYS, dtype=torch.int32)
    inst = torch.empty(RAYS, dtype=torch.int32)
    fn = lib.tpurt_inst_any_hit if any_hit else lib.tpurt_inst_closest_hit
    err = fn(o.data_ptr(), d.data_ptr(), t_min.data_ptr(), t_max.data_ptr(),
             g.tri_planes.data_ptr(), g.obj_group_aabb.data_ptr(),
             g.inst_table.data_ptr(), g.inst_aabb.data_ptr(),
             g.inst_group_span.data_ptr(), RAYS, g.inst_table.shape[0],
             g.obj_group_aabb.shape[1], t.data_ptr(), tri.data_ptr(),
             inst.data_ptr(), None)
    assert err == 0
    _check({"t": t, "tri": tri, "inst": inst}, want, t_max, any_hit)
