"""Build-time variants of kernels K1/K2 (`csrc/trace.cu`) timed side by
side on the card, on the three scenes of their route: the Cornell box
(11 chunks), the bunny scene (bench.py config 3, 121 chunks) and the
restir scene (251 chunks).

    python -m tpu_raytracer_torch.swept_variants
    python -m tpu_raytracer_torch.swept_variants --baseline OTHER/csrc

Builds `trace.cu` (with the headers it includes) once for each unit
capacity in MAX_UNITS (TPURT_SWEPT_MAX_UNITS), every nvcc started at
once, and, with `--baseline`, the
`trace.cu` of another checkout's csrc directory (the same C signatures).
Each build's closest- and any-hit entries run on each scene's 512^2
primary rays and on RANDOM_RAYS random rays (30% dead, random t_max:
chip_smoke.py's Cornell and bunny rays, and rays over the restir scene's
floor) and must equal the reference build (the baseline if given, else
the default capacity) and K3 (`csrc/trace_stream.cu`, the package's
build) on every lane: tri equal and t bit-equal; any-hit occlusion
equal and t = t_max. Times are CUDA events over REPS launches, taken
twice in mirrored order (baseline, variants, K3, K3, variants reversed,
baseline). Prints ptxas's registers and shared memory for each build and
one JSON line of the times. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import threading
import time

import numpy as np
import torch

from .models import scenes
from .ops import gbuffer, trace_api, trace_stream
from .render import camera, renderer
from .runtime.build import CSRC_DIR
from .stream_variants import REPS, _build_all, _card, _time_ms

# bunny: units of 8, 4, 2 and 1 chunks; restir: 16, 8, 4 and 2
MAX_UNITS = (16, 32, 64, 128)
DEFAULT = f"units{trace_api.SWEPT_MAX_UNITS}"
RANDOM_RAYS = 524288
SIZE = 512
# scene -> (builder in models/scenes.py, random rays: seed, origin box
# (lo, hi, y range or None), t_far)
SCENES = {"cornell": ("create_cornell_box", (0, -0.95, 0.95, None, 3.0)),
          "bunny": ("create_bunny_scene", (3, -0.95, 0.95, None, 3.0)),
          "restir": ("create_restir_scene", (4, -5.0, 5.0, (-0.9, 3.0),
                                             20.0))}


def _rays(scene, dev, seed, lo, hi, y, t_far):
    """{"primary": the 512^2 primary rays (t in (1e-3, 1000)), "random":
    RANDOM_RAYS rays with origins uniform in [lo, hi]^3 (y in `y` if
    given), t_max uniform in (0.01, t_far), 30% dead}: each [o, d, t_min,
    t_max] on `dev`."""
    g = np.random.default_rng(seed)
    n = RANDOM_RAYS
    o = g.uniform(lo, hi, (3, n)).astype(np.float32)
    if y is not None:
        o[1] = g.uniform(*y, n)
    d = g.standard_normal((3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    t_max = g.uniform(0.01, t_far, n).astype(np.float32)
    t_max[g.uniform(size=n) < 0.3] = 0.0
    rand = [torch.from_numpy(x).to(dev) for x in (o, d)]
    rand += [torch.full((n,), 1e-3, device=dev),
             torch.from_numpy(t_max).to(dev)]
    cam = camera.CameraController()
    u = renderer.camera_to_device(cam.uniform(1.0, 0, scene.num_lights),
                                  dev)
    po, pd = gbuffer.generate_primary_rays(u, SIZE, SIZE)
    m = SIZE * SIZE
    prim = [torch.stack(list(po)).contiguous(),
            torch.stack(list(pd)).contiguous(),
            torch.full((m,), 1e-3, device=dev),
            torch.full((m,), 1000.0, device=dev)]
    return {"primary": prim, "random": rand}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--baseline", help="another checkout's csrc directory "
                   "whose trace.cu is timed beside these builds")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("swept_variants: no CUDA device")
    card = _card()
    dev = torch.device("cuda:0")
    variants = [(f"units{m}", CSRC_DIR, (f"TPURT_SWEPT_MAX_UNITS={m}",))
                for m in MAX_UNITS]
    if args.baseline:
        variants.insert(0, ("baseline", os.path.abspath(args.baseline), ()))
    ref = "baseline" if args.baseline else DEFAULT
    t0 = time.time()
    # K3, from the package's own build, built while the variants build
    package = threading.Thread(target=trace_api.load_kernels)
    package.start()
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    libs = _build_all("trace.cu", variants,
                      ("tpurt_closest_hit", "tpurt_any_hit"),
                      [ptr] * 6 + [i32] * 2 + [ptr] * 3)
    package.join()
    trace_api.load_kernels()        # raises here if that build failed
    print(f"built {len(libs)} variants of trace.cu and the package's "
          f"kernels in {time.time() - t0:.2f} s [{card}]", flush=True)
    for name, (_, ptxas) in libs.items():
        print(f"ptxas {name}: {' | '.join(ptxas)}", flush=True)

    names = list(libs) + ["K3"]
    order = names + names[::-1]
    results = {"card": card, "device": torch.cuda.get_device_name(0),
               "reps": REPS, "order": order, "ms": {}}
    for sname, (builder, ray_args) in SCENES.items():
        scene = getattr(scenes, builder)(dev)
        planes, aabb = scene.tri_planes, scene.chunk_aabb
        tp = planes.shape[2]
        nc = tp // trace_api.CT
        for rays_name, (o, d, t_min, t_max) in _rays(scene, dev,
                                                     *ray_args).items():
            r = o.shape[1]
            stream = torch.cuda.current_stream(dev).cuda_stream
            calls, outs = {}, {}
            for name in names:
                for entry in ("closest", "any"):
                    out = [torch.empty((r,), dtype=torch.float32,
                                       device=dev),
                           torch.empty((r,), dtype=torch.int32, device=dev)]
                    if name == "K3":
                        def call(out=out, any_hit=entry == "any"):
                            res = trace_stream.trace_stream_kernel(
                                planes, aabb, o, d, t_min, t_max,
                                any_hit=any_hit)
                            out[0], out[1] = res["t"], res["tri"]
                    else:
                        fn = getattr(libs[name][0], f"tpurt_{entry}_hit")

                        def call(fn=fn, out=out, name=name, entry=entry):
                            err = fn(o.data_ptr(), d.data_ptr(),
                                     t_min.data_ptr(), t_max.data_ptr(),
                                     planes.data_ptr(), aabb.data_ptr(), r,
                                     tp, out[0].data_ptr(),
                                     out[1].data_ptr(), stream)
                            if err:
                                raise RuntimeError(f"{name} {entry}: CUDA "
                                                   f"error {err}")
                    call()
                    calls[(name, entry)], outs[(name, entry)] = call, out
            torch.cuda.synchronize()
            for (name, entry), (t, tri) in outs.items():
                want_t, want_tri = outs[(ref, entry)]
                if entry == "closest":
                    ok = torch.equal(tri, want_tri) and torch.equal(t, want_t)
                else:
                    ok = (torch.equal(tri >= 0, want_tri >= 0)
                          and torch.equal(t, t_max))
                if not ok:
                    raise AssertionError(f"{name} {entry} on the {sname} "
                                         f"{rays_name} rays differs from "
                                         f"{ref}")
            row = {f"{name} {entry}": [] for name in names
                   for entry in ("closest", "any")}
            for name in order:
                for entry in ("closest", "any"):
                    row[f"{name} {entry}"].append(
                        _time_ms(calls[(name, entry)]))
            results["ms"][f"{sname} {rays_name}"] = row
            hit = float((outs[(ref, "closest")][1] >= 0).float().mean())
            print(f"{sname} ({nc} chunks) {rays_name} rays ({r}, {hit:.3f} "
                  f"hit), every build and K3 equal to {ref} on every lane; "
                  f"ms (two turns): "
                  + ", ".join(f"{k} {v[0]:.4f} / {v[1]:.4f}"
                              for k, v in row.items()) + f" [{card}]",
                  flush=True)
        del scene, planes, aabb
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
