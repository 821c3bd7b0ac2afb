"""Build-time variants of kernel K3 (`csrc/trace_stream.cu`) timed side by
side on the card, on the dense knot (bench.py config 6).

    python -m tpu_raytracer_torch.stream_variants
    python -m tpu_raytracer_torch.stream_variants --baseline OTHER/csrc

Builds `trace_stream.cu` once for each unit capacity in MAX_UNITS
(TPURT_MAX_UNITS), every nvcc started at once, and, with `--baseline`,
the `trace_stream.cu` of another checkout's csrc directory (the same C
signatures). Each build's
closest- and any-hit entries run on the knot's 512^2 primary rays and on
RANDOM_RAYS random rays in the knot's box (chip_smoke.py's phase-9 rays),
are checked against K1/K2 on every lane (tri equal, t bit-equal,
occlusion equal) and are timed with CUDA events over REPS launches, twice
in mirrored order (the builds, then the builds reversed), K1 and K2
beside them once. Prints ptxas's registers and shared memory for each
build and one JSON line of the times. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import time

import numpy as np
import torch

from .models import dense_asset, scenes
from .ops import gbuffer, trace_api
from .render import camera, renderer
from .runtime.build import BUILD_DIR, CSRC_DIR

MAX_UNITS = (32, 64, 128)     # knot: units of 32, 16 and 8 chunks
RANDOM_RAYS = 524288
SIZE = 512
REPS = 10


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def _build_all(source, variants, entries, argtypes, allow_fail=False):
    """Start one nvcc per (name, csrc dir, defines) at once, each building
    <csrc dir>/<source>; bind each library's `entries` with `argtypes`.
    Returns {name: (ctypes library, ptxas lines)}. A build that fails
    raises, or with `allow_fail` gives (None, the compiler's last lines)."""
    out_dir = os.path.join(BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    stem = os.path.splitext(source)[0]
    procs = {}
    for name, csrc, defines in variants:
        so = os.path.join(out_dir, f"{stem}_{name}.so")
        cmd = [trace_api._nvcc(), *trace_api.NVCC_FLAGS,
               *(f"-D{x}" for x in defines), "-o", so,
               os.path.join(csrc, source)]
        procs[name] = (so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate(timeout=600)[0]
        if proc.returncode != 0 and allow_fail:
            libs[name] = (None, log.strip().splitlines()[-12:])
            continue
        if proc.returncode != 0:
            raise RuntimeError(f"building {name} failed:\n{log}")
        lib = ctypes.CDLL(so)
        for entry in entries:
            fn = getattr(lib, entry)
            fn.restype = ctypes.c_int
            fn.argtypes = argtypes
        libs[name] = (lib, [ln.strip() for ln in log.splitlines()
                            if "registers" in ln or "Compiling entry" in ln])
    return libs


def _knot_rays(dev):
    """chip_smoke.py's phase-9 rays: RANDOM_RAYS random rays in the knot's
    box (seed 2, random t_max, 30% dead) and the 512^2 primary rays."""
    pos = dense_asset.knot_mesh()[0] * 1.1 + np.float32([0.0, 1.2, 0.0])
    lo, hi = pos.min(0)[:, None], pos.max(0)[:, None]
    g = np.random.default_rng(2)
    o = g.uniform(lo, hi, (3, RANDOM_RAYS)).astype(np.float32)
    d = g.standard_normal((3, RANDOM_RAYS)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    t_max = g.uniform(0.01, float(np.linalg.norm(hi - lo)),
                      RANDOM_RAYS).astype(np.float32)
    t_max[g.uniform(size=RANDOM_RAYS) < 0.3] = 0.0
    rand = [torch.from_numpy(x).to(dev) for x in (o, d)]
    rand += [torch.full((RANDOM_RAYS,), 1e-3, device=dev),
             torch.from_numpy(t_max).to(dev)]
    cam = camera.CameraController()
    u = renderer.camera_to_device(cam.uniform(1.0, 0, 1), dev)
    po, pd = gbuffer.generate_primary_rays(u, SIZE, SIZE)
    n = SIZE * SIZE
    prim = [torch.stack(list(po)).contiguous(),
            torch.stack(list(pd)).contiguous(),
            torch.full((n,), 1e-3, device=dev),
            torch.full((n,), 1000.0, device=dev)]
    return {"primary": prim, "random": rand}


def _time_ms(fn):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--baseline", help="another checkout's csrc directory "
                   "whose trace_stream.cu is timed beside these builds")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("stream_variants: no CUDA device")
    card = _card()
    dev = torch.device("cuda:0")
    variants = [(f"units{m}", CSRC_DIR, (f"TPURT_MAX_UNITS={m}",))
                for m in MAX_UNITS]
    if args.baseline:
        variants.insert(0, ("baseline", os.path.abspath(args.baseline), ()))
    t0 = time.time()
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    libs = _build_all("trace_stream.cu", variants,
                      ("tpurt_stream_closest_hit", "tpurt_stream_any_hit"),
                      [ptr] * 6 + [i32] * 2 + [ptr] * 3)
    print(f"built {len(libs)} variants of trace_stream.cu in "
          f"{time.time() - t0:.2f} s [{card}]", flush=True)
    for name, (_, ptxas) in libs.items():
        print(f"ptxas {name}: {' | '.join(ptxas)}", flush=True)

    knot = scenes.create_dense_knot_scene(dev)
    planes, aabb = knot.tri_planes, knot.chunk_aabb
    tp = planes.shape[2]
    order = list(libs) + list(libs)[::-1]
    results = {"card": card, "device": torch.cuda.get_device_name(0),
               "reps": REPS, "order": order, "ms": {}}
    for rays_name, (o, d, t_min, t_max) in _knot_rays(dev).items():
        r = o.shape[1]
        k1 = trace_api.trace_kernel(planes, aabb, o, d, t_min, t_max)
        occ = trace_api.trace_kernel(planes, aabb, o, d, t_min, t_max,
                                     any_hit=True)["tri"] >= 0
        t_out = torch.empty((r,), dtype=torch.float32, device=dev)
        tri_out = torch.empty((r,), dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        row = {"K1": [_time_ms(lambda: trace_api.trace_kernel(
                   planes, aabb, o, d, t_min, t_max))],
               "K2": [_time_ms(lambda: trace_api.trace_kernel(
                   planes, aabb, o, d, t_min, t_max, any_hit=True))]}
        calls = {}
        for name, (lib, _) in libs.items():
            for entry, fn in (("closest", lib.tpurt_stream_closest_hit),
                              ("any", lib.tpurt_stream_any_hit)):
                def call(fn=fn, name=name, entry=entry):
                    err = fn(o.data_ptr(), d.data_ptr(), t_min.data_ptr(),
                             t_max.data_ptr(), planes.data_ptr(),
                             aabb.data_ptr(), r, tp, t_out.data_ptr(),
                             tri_out.data_ptr(), stream)
                    if err:
                        raise RuntimeError(f"{name} {entry}: CUDA error "
                                           f"{err}")
                call()
                torch.cuda.synchronize()
                if entry == "closest":
                    ok = (torch.equal(tri_out, k1["tri"])
                          and torch.equal(t_out, k1["t"]))
                else:
                    ok = (torch.equal(tri_out >= 0, occ)
                          and torch.equal(t_out, t_max))
                if not ok:
                    raise AssertionError(f"{name} {entry} on the {rays_name} "
                                         f"rays differs from K1/K2")
                calls[(name, entry)] = call
                row[f"{name} {entry}"] = []
        for name in order:
            for entry in ("closest", "any"):
                row[f"{name} {entry}"].append(_time_ms(calls[(name, entry)]))
        results["ms"][rays_name] = row
        print(f"{rays_name} knot rays ({r}), equal to K1/K2 on every lane; "
              f"ms (two turns): " + ", ".join(
                  f"{k} {' / '.join(f'{x:.4f}' for x in v)}"
                  for k, v in row.items()) + f" [{card}]", flush=True)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
