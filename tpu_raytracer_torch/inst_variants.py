"""Build-time variants of kernel K4 (`csrc/trace_inst.cu`) timed side by
side on the card, on the instanced gallery (bench.py config 7).

    python -m tpu_raytracer_torch.inst_variants
    python -m tpu_raytracer_torch.inst_variants --baseline OTHER/csrc

Builds `trace_inst.cu` once for each unit capacity in MAX_UNITS
(TPURT_INST_MAX_UNITS: the gallery's 102 instances in units of 4, 2 and
1), every nvcc started at once, and, with `--baseline`, the
`trace_inst.cu` of another checkout's csrc directory (the same C
signatures). Each build's closest- and any-hit entries run on the
gallery's 512^2 primary rays and on RANDOM_RAYS random rays inside it
(chip_smoke.py's phase-7 rays) and must equal the reference build on
every lane (the baseline if given, else the default capacity): tri and
inst equal and t bit-equal; any-hit occlusion equal, t = t_max and inst
set exactly on occluded lanes. Times are CUDA events over REPS launches,
taken twice in mirrored order (baseline, variants, variants reversed,
baseline). Prints ptxas's registers and shared memory for each build and
one JSON line of the times. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import time

import numpy as np
import torch

from .models import scenes
from .ops import gbuffer
from .render import camera, renderer
from .runtime.build import CSRC_DIR
from .stream_variants import REPS, _build_all, _card, _time_ms

MAX_UNITS = (32, 64, 128)     # gallery: units of 4, 2 and 1 instances
DEFAULT = "units128"          # ops/trace_inst.py:MAX_UNITS
RANDOM_RAYS = 524288
SIZE = 512


def _gallery_rays(scene, dev):
    """chip_smoke.py's phase-7 rays: the 512^2 primary rays (t in (1e-3,
    1000)) and RANDOM_RAYS random rays (seed 1, origins in [-7, 7]^3 with
    y in [-0.9, 3], t_max in (0.01, 20), 30% dead)."""
    g = np.random.default_rng(1)
    n = RANDOM_RAYS
    o = g.uniform(-7.0, 7.0, (3, n)).astype(np.float32)
    o[1] = g.uniform(-0.9, 3.0, n)
    d = g.standard_normal((3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    t_max = g.uniform(0.01, 20.0, n).astype(np.float32)
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
                   "whose trace_inst.cu is timed beside these builds")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("inst_variants: no CUDA device")
    card = _card()
    dev = torch.device("cuda:0")
    variants = [(f"units{m}", CSRC_DIR, (f"TPURT_INST_MAX_UNITS={m}",))
                for m in MAX_UNITS]
    if args.baseline:
        variants.insert(0, ("baseline", os.path.abspath(args.baseline), ()))
    ref = "baseline" if args.baseline else DEFAULT
    t0 = time.time()
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    libs = _build_all("trace_inst.cu", variants,
                      ("tpurt_inst_closest_hit", "tpurt_inst_any_hit"),
                      [ptr] * 9 + [i32] * 3 + [ptr] * 4)
    print(f"built {len(libs)} variants of trace_inst.cu in "
          f"{time.time() - t0:.2f} s [{card}]", flush=True)
    for name, (_, ptxas) in libs.items():
        print(f"ptxas {name}: {' | '.join(ptxas)}", flush=True)

    gal = scenes.create_instancing_gallery_scene(dev)
    tables = (gal.tri_planes, gal.obj_group_aabb, gal.inst_table,
              gal.inst_aabb, gal.inst_group_span)
    n_inst, ngo = gal.inst_table.shape[0], gal.obj_group_aabb.shape[1]
    order = list(libs) + list(libs)[::-1]
    results = {"card": card, "device": torch.cuda.get_device_name(0),
               "reps": REPS, "order": order, "ms": {}}
    for rays_name, (o, d, t_min, t_max) in _gallery_rays(gal, dev).items():
        r = o.shape[1]
        stream = torch.cuda.current_stream(dev).cuda_stream
        calls, outs = {}, {}
        for name, (lib, _) in libs.items():
            for entry, fn in (("closest", lib.tpurt_inst_closest_hit),
                              ("any", lib.tpurt_inst_any_hit)):
                out = [torch.empty((r,), dtype=torch.float32, device=dev),
                       torch.empty((r,), dtype=torch.int32, device=dev),
                       torch.empty((r,), dtype=torch.int32, device=dev)]

                def call(fn=fn, out=out, name=name, entry=entry):
                    err = fn(o.data_ptr(), d.data_ptr(), t_min.data_ptr(),
                             t_max.data_ptr(),
                             *(x.data_ptr() for x in tables), r, n_inst,
                             ngo, *(x.data_ptr() for x in out), stream)
                    if err:
                        raise RuntimeError(f"{name} {entry}: CUDA error "
                                           f"{err}")
                call()
                calls[(name, entry)], outs[(name, entry)] = call, out
        torch.cuda.synchronize()
        for (name, entry), (t, tri, inst) in outs.items():
            want_t, want_tri, want_inst = outs[(ref, entry)]
            if entry == "closest":
                ok = (torch.equal(tri, want_tri) and torch.equal(inst,
                                                                 want_inst)
                      and torch.equal(t, want_t))
            else:
                occ = want_tri >= 0
                ok = (torch.equal(tri >= 0, occ) and torch.equal(t, t_max)
                      and torch.equal(inst >= 0, occ))
            if not ok:
                raise AssertionError(f"{name} {entry} on the {rays_name} "
                                     f"rays differs from {ref}")
        row = {f"{name} {entry}": [] for name in libs
               for entry in ("closest", "any")}
        for name in order:
            for entry in ("closest", "any"):
                row[f"{name} {entry}"].append(
                    _time_ms(calls[(name, entry)]))
        results["ms"][rays_name] = row
        hit = float((outs[(ref, "closest")][1] >= 0).float().mean())
        print(f"{rays_name} gallery rays ({r}, {hit:.3f} hit), equal to "
              f"{ref} on every lane; ms (two turns): "
              + ", ".join(f"{k} {v[0]:.4f} / {v[1]:.4f}"
                          for k, v in row.items()) + f" [{card}]",
              flush=True)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
