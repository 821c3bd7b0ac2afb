"""Kernels K6 (`csrc/trace_mxu.cu`) and K5 (`csrc/trace_vpu.cu`) timed side
by side on the card, beside another checkout's, on the Cornell box (11
chunks), the bunny scene (bench.py config 3, 121 chunks) and the restir
scene (251 chunks).

    python -m tpu_raytracer_torch.mxu_variants
    python -m tpu_raytracer_torch.mxu_variants --baseline OTHER/csrc

Builds this checkout's `trace_mxu.cu` and `trace_vpu.cu` and, with
`--baseline`, those of another checkout's csrc directory (every nvcc
started at once, the package's kernels beside them). The baseline must
have this checkout's C signatures: K6's chunk boxes in place of
worklists, K5's unit capacity as an argument. A build that does not
compile is reported with the compiler's last lines and left out.

Each K6 variant (mxu3, mxu1, mxuw8, and on Cornell the in-kernel cull's
closest- and any-hit) runs on each scene's 512^2 primary rays and
RANDOM_RAYS random rays (swept_variants.py's). Every build must equal the
plain version over the kernel's own (lane, chunk) set within
chip_smoke's limits (PLAIN_DIFF lanes in hit/miss and in tri, max
relative t PLAIN_REL). K5 runs at both unit capacities (32, K1's, and
64, K3's) and must equal K1 on every lane, t bit for bit. A build that
fails a check is reported and left out of the timing, and the exit code
is 1. Times are CUDA events over REPS launches, taken twice in mirrored
order (the builds, then the builds reversed). Prints ptxas's registers
and shared memory for each build and one JSON line of the times. Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import threading
import time

import torch

from .models import scenes
from .ops import trace_api, trace_mxu
from .runtime.build import CSRC_DIR
from .stream_variants import REPS, _build_all, _card, _time_ms
from .swept_variants import SCENES, _rays
from .utils.vec3 import V3

# (name, grp (None: the cull's 2 or 4), passes, in-kernel cull, any-hit)
VARIANTS = (("mxu3", 1, 3, False, False), ("mxu1", 1, 1, False, False),
            ("mxuw8", 8, 3, False, False), ("incull", None, 3, True, False),
            ("incull_any", None, 3, True, True))
PLAIN_DIFF, PLAIN_REL = 8, 1e-4      # chip_smoke.py's limits
K5_UNITS = (32, 64)


def _compare(got, want, any_hit):
    """(lanes differing in hit/miss, in tri where both hit, max relative t
    error where tri agrees)."""
    g_hit, w_hit = got["tri"] >= 0, want["tri"] >= 0
    hit_diff = int((g_hit != w_hit).sum())
    if any_hit:
        return hit_diff, 0, 0.0
    both = g_hit & w_hit
    same = both & (got["tri"] == want["tri"])
    rel = ((got["t"].double() - want["t"].double()).abs()
           / want["t"].double().abs().clamp_min(1e-6))
    return (hit_diff, int((both & ~same).sum()),
            float(rel[same].max()) if bool(same.any()) else 0.0)


def _mirrored(calls):
    """{name: [ms, ms]}: each call timed, then again in reverse order."""
    names = list(calls)
    times = {n: [] for n in names}
    for n in names + names[::-1]:
        times[n].append(_time_ms(calls[n]))
    return times


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--baseline", help="another checkout's csrc directory "
                   "whose trace_mxu.cu and trace_vpu.cu are timed beside "
                   "these builds")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("mxu_variants: no CUDA device")
    card = _card()
    dev = torch.device("cuda:0")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    signatures = {
        "trace_mxu.cu": {
            "tpurt_mxu_closest_hit": [ptr] * 6 + [i32] * 5 + [ptr] * 3,
            "tpurt_mxu_any_hit": [ptr] * 6 + [i32] * 3 + [ptr] * 3},
        "trace_vpu.cu": {
            "tpurt_vpu_closest_hit": [ptr] * 6 + [i32] * 3 + [ptr] * 3}}
    builds = [("default", CSRC_DIR, ())]
    if args.baseline:
        builds.insert(0, ("baseline", os.path.abspath(args.baseline), ()))
    t0 = time.time()
    built = {}

    def build(source):
        built[source] = _build_all(source, builds, (), [], allow_fail=True)

    threads = [threading.Thread(target=build, args=(src,))
               for src in signatures]
    threads.append(threading.Thread(target=trace_api.load_kernels))
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    trace_api.load_kernels()        # raises here if that build failed
    libs = {}
    for src, by_name in built.items():
        for name, (lib, lines) in by_name.items():
            if lib is not None:
                for entry, argtypes in signatures[src].items():
                    fn = getattr(lib, entry)
                    fn.restype, fn.argtypes = i32, argtypes
                libs[(src, name)] = lib
            state = "ptxas" if lib is not None else "BUILD FAILED"
            print(f"{state} {src} {name}: {' | '.join(lines)}", flush=True)
    print(f"built {sum(map(len, built.values()))} libraries and the "
          f"package's kernels in {time.time() - t0:.2f} s [{card}]",
          flush=True)
    failed = len(libs) < sum(map(len, built.values()))
    mxu = {n: lib for (s, n), lib in libs.items() if s == "trace_mxu.cu"}
    vpu = {n: lib for (s, n), lib in libs.items() if s == "trace_vpu.cu"}

    results = {"card": card, "device": torch.cuda.get_device_name(0),
               "reps": REPS, "ms": {}, "wrong": []}

    def wrong(what):
        results["wrong"].append(what)
        print(f"{what} WRONG: left out", flush=True)

    for sname, (builder, ray_args) in SCENES.items():
        scene = getattr(scenes, builder)(dev)
        planes, aabb = scene.tri_planes, scene.chunk_aabb
        nc, tp = aabb.shape[0], planes.shape[2]
        table = trace_mxu.kernel_table(planes)
        for rays_name, (o, d, t_min, t_max) in _rays(scene, dev,
                                                     *ray_args).items():
            r = o.shape[1]
            ov, dv = V3(*o), V3(*d)
            stream = torch.cuda.current_stream(dev).cuda_stream
            rays = (o.data_ptr(), d.data_ptr(), t_min.data_ptr(),
                    t_max.data_ptr())
            k1 = trace_api.trace_kernel(planes, aabb, o, d, t_min, t_max)
            row = {}
            for vname, grp, passes, incull, any_hit in VARIANTS:
                if incull and nc > trace_api.INCULL_MAX_CHUNKS:
                    continue            # no route takes the cull there
                g = grp or (2 if nc <= 48 else 4)
                chunks = trace_mxu.lane_chunks(aabb, g, incull, ov, dv,
                                               t_min, t_max)
                want = trace_mxu.trace_mxu_plain(table, chunks, ov, dv, t_min,
                                                 t_max, passes, any_hit)
                calls = {}
                for name, lib in mxu.items():
                    out = [torch.empty((r,), device=dev),
                           torch.empty((r,), dtype=torch.int32, device=dev)]
                    head = (*rays, table.data_ptr(), aabb.data_ptr(), r, nc,
                            g)
                    tail = (out[0].data_ptr(), out[1].data_ptr(), stream)

                    def call(lib=lib, head=head, tail=tail, name=name):
                        err = (lib.tpurt_mxu_any_hit(*head, *tail) if any_hit
                               else lib.tpurt_mxu_closest_hit(
                                   *head, passes, int(incull), *tail))
                        if err:
                            raise RuntimeError(f"{name} {vname}: CUDA error "
                                               f"{err}")
                    call()
                    torch.cuda.synchronize()
                    hd, td, rel = _compare({"t": out[0], "tri": out[1]},
                                           want, any_hit)
                    ok = (hd <= PLAIN_DIFF and td <= PLAIN_DIFF
                          and rel < PLAIN_REL
                          and (not any_hit or torch.equal(out[0], t_max)))
                    print(f"{sname} {rays_name} {vname} {name}: vs plain {hd} "
                          f"hit/miss lanes, {td} tri lanes, max rel t "
                          f"{rel:.3g}", flush=True)
                    if ok:
                        calls[name] = call
                    else:
                        wrong(f"{sname} {rays_name} {vname} {name}")
                row[vname] = times = _mirrored(calls)
                print(f"{sname} ({nc} chunks) {rays_name} rays ({r}) "
                      f"{vname} ms (two turns): "
                      + ", ".join(f"{k} {v[0]:.4f} / {v[1]:.4f}"
                                  for k, v in times.items())
                      + f" [{card}]", flush=True)
            # K5 at each unit capacity beside K1, equal to it on every lane
            calls = {"K1": lambda: trace_api.trace_kernel(
                planes, aabb, o, d, t_min, t_max)}
            for name, lib in vpu.items():
                for units in K5_UNITS:
                    out = [torch.empty((r,), device=dev),
                           torch.empty((r,), dtype=torch.int32, device=dev)]

                    def call(lib=lib, out=out, units=units, name=name):
                        err = lib.tpurt_vpu_closest_hit(
                            *rays, planes.data_ptr(), aabb.data_ptr(), r,
                            tp, units, out[0].data_ptr(), out[1].data_ptr(),
                            stream)
                        if err:
                            raise RuntimeError(f"{name} K5: CUDA error {err}")
                    call()
                    torch.cuda.synchronize()
                    key = f"{name} K5 units{units}"
                    if (torch.equal(out[1], k1["tri"])
                            and torch.equal(out[0], k1["t"])):
                        calls[key] = call
                    else:
                        wrong(f"{sname} {rays_name} {key} vs K1")
            row["vpu"] = times = _mirrored(calls)
            print(f"{sname} ({nc} chunks) {rays_name} rays ({r}) vpu ms "
                  f"(two turns; K5 equal to K1 on every lane): "
                  + ", ".join(f"{k} {v[0]:.4f} / {v[1]:.4f}"
                              for k, v in times.items()) + f" [{card}]",
                  flush=True)
            results["ms"][f"{sname} {rays_name}"] = row
        del scene, planes, aabb, table
    print(json.dumps(results))
    return 1 if failed or results["wrong"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
