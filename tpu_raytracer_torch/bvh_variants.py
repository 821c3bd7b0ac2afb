"""Build-time variants of kernel K8, the BVH walk (`csrc/trace_bvh.cu`),
timed side by side on the card, on the scenes of its route.

    python -m tpu_raytracer_torch.bvh_variants
    python -m tpu_raytracer_torch.bvh_variants --baseline OTHER/csrc

Builds `trace_bvh.cu` (with `mt.cuh`) once for each window in VARIANTS
(TPURT_BVH_WINDOW, records a load), every nvcc started at once, and,
with `--baseline`, the `trace_bvh.cu` of another checkout's csrc
directory (the same C entries). Each build's closest- and any-hit
entries run on:
  - the big scene (`bigscene.big_scene(dev, 8, (-0.3, 0.3))`: 2,621,444
    triangles, past the walk's cap) on scripts/ucb_bigscene.py's 262,144
    incoherent and 262,144 coherent rays (`bigscene.walk_rays`), and on
    each set doubled to 524,288 lanes (more than the card holds at once);
  - ucb_bigscene.py's own 983,044-triangle scene forced through the
    walk (`big_scene(dev, 7, (-0.6, 0.0, 0.6), brute_max=1)`) on the
    same two sets;
  - the Cornell box built with brute_max=1, on its 512^2 primary rays and
    262,144 random rays (seed 3, 30% dead, chip_smoke.py's).
Each must equal the plain walk (`ops/traversal.py:trace_plain`, run on
the card with its step counts) on every lane: tri equal and t bit-equal.
Times are CUDA events over REPS launches, taken in PAIRS mirrored pairs
of turns (the builds, then the builds reversed). A diagnostic of where
the time goes: every build on the big scene's incoherent rays with the
longest 1% of them (by the plain walk's steps for the query) made dead,
t_max = 0, and with only those live. Prints the step statistics of each
ray set, ptxas's registers (and any stack) for each build, and for the
big scene's incoherent rays and for walked Cornell each build's score,
closest- and any-hit weighed by their launches a frame (15 and 7), over
every turn: the fastest build by its median turn, and the builds whose
turns overlap the fastest's (a tie). Ends with one JSON line. Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import threading
import time

import numpy as np
import torch

from .bigscene import big_scene, stats_text, step_stats, walk_rays
from .ops import gbuffer, trace_api, traversal
from .render import camera, renderer
from .runtime.build import BUILD_DIR, CSRC_DIR
from .utils.vec3 import V3

# name -> TPURT_BVH_WINDOW
VARIANTS = {"w1": 1, "w2": 2, "w3": 3, "w4": 4, "w8": 8}
PAIRS = 3         # mirrored pairs of turns
WALK_RAYS = 262144
CORNELL_SIZE = 512
# launches a frame of a walked scene (PERF.md §6): closest- and any-hit
WEIGHTS = {"closest": 15, "any": 7}
TAIL = 0.01       # the diagnostic's share of rays made dead
REPS = 10         # launches a timed turn


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def _build_all(source, variants, entries, argtypes):
    """Start one nvcc per (name, csrc dir, defines) at once, each building
    <csrc dir>/<source>; bind each library's `entries` with `argtypes`.
    Returns {name: (ctypes library, ptxas lines)}; a build that fails
    raises."""
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


def _time_ms(fn):
    """fn's time on the card: CUDA events over REPS launches, after one
    launch unrecorded."""
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


def _cornell_rays(scene, dev):
    """The walked Cornell box's 512^2 primary rays and 262,144 random rays
    (chip_smoke.py's: seed 3, origins in [-0.95, 0.95]^3, t_max in (0.01,
    3), 30% dead)."""
    u = renderer.camera_to_device(camera.CameraController().uniform(
        1.0, 0, scene.num_lights), dev)
    po, pd = gbuffer.generate_primary_rays(u, CORNELL_SIZE, CORNELL_SIZE)
    m = po.x.shape[0]
    prim = (torch.stack(list(po)).contiguous(),
            torch.stack(list(pd)).contiguous(),
            torch.full((m,), gbuffer.T_MIN, device=dev),
            torch.full((m,), gbuffer.T_MAX, device=dev))
    g = np.random.default_rng(3)
    n = WALK_RAYS
    o = g.uniform(-0.95, 0.95, (3, n)).astype(np.float32)
    d = g.standard_normal((3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    t_max = g.uniform(0.01, 3.0, n).astype(np.float32)
    t_max[g.uniform(size=n) < 0.3] = 0.0
    rnd = (torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev),
           torch.full((n,), 1e-3, device=dev),
           torch.from_numpy(t_max).to(dev))
    return {"primary": prim, "random": rnd}


def _plain(scene, rays):
    """{query: trace_plain(count=True)'s result} on these rays."""
    bvh = (scene.bvh_rec, scene.bvh_skip, scene.bvh_tri)
    o, d, t_min, t_max = rays
    return {q: traversal.trace_plain(*bvh, V3(*o), V3(*d), t_min, t_max,
                                     any_hit=q == "any", count=True)
            for q in ("closest", "any")}


def _calls(libs, scene, rays, dev):
    """{(build, query): (call, [t, tri] outputs)} of every build's entry
    on these rays."""
    o, d, t_min, t_max = rays
    r, s = o.shape[1], scene.bvh_rec.shape[0]
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = {}
    for name, lib in libs.items():
        for q in ("closest", "any"):
            fn = getattr(lib, f"tpurt_bvh_{q}_hit")
            res = [torch.empty((r,), dtype=torch.float32, device=dev),
                   torch.empty((r,), dtype=torch.int32, device=dev)]
            args = (o.data_ptr(), d.data_ptr(), t_min.data_ptr(),
                    t_max.data_ptr(), scene.bvh_rec.data_ptr(),
                    scene.bvh_skip.data_ptr(), scene.bvh_tri.data_ptr(), r,
                    s, res[0].data_ptr(), res[1].data_ptr(), stream)

            def call(fn=fn, args=args, name=name, q=q):
                err = fn(*args)
                if err:
                    raise RuntimeError(f"{name} {q}: CUDA error {err}")
            out[(name, q)] = (call, res)
    return out


def _run_set(label, scene, rays, want, libs, dev, card, results):
    """Check every build against the plain results `want` on these rays,
    time them in PAIRS mirrored pairs of turns, print and record the
    times."""
    calls = _calls(libs, scene, rays, dev)
    for call, _ in calls.values():
        call()
    torch.cuda.synchronize()
    for (name, q), (_, (t, tri)) in calls.items():
        bad_tri = int((tri != want[q]["tri"]).sum())
        bad_t = int((t.view(torch.int32)
                     != want[q]["t"].view(torch.int32)).sum())
        if bad_tri or bad_t:
            raise AssertionError(f"{name} {q} on {label}: tri differs on "
                                 f"{bad_tri} lanes, t on {bad_t}")
    names = list(libs)
    order = (names + names[::-1]) * PAIRS
    row = {f"{n} {q}": [] for n in names for q in ("closest", "any")}
    for name in order:
        for q in ("closest", "any"):
            row[f"{name} {q}"].append(_time_ms(calls[(name, q)][0]))
    results["ms"][label] = row
    print(f"{label} ({rays[0].shape[1]} rays): every build equal to the "
          f"plain walk (tri on every lane, t bit-equal); ms, median "
          f"[min-max] of {len(order) // len(names)} turns: "
          + ", ".join(f"{k} {statistics.median(v):.4f} [{min(v):.4f}-"
                      f"{max(v):.4f}]" for k, v in row.items())
          + f" [{card}]", flush=True)


def _score(row, names):
    """{build: its weighted ms in each turn (15 x closest + 7 x any)}."""
    return {n: [sum(w * row[f"{n} {q}"][i] for q, w in WEIGHTS.items())
                for i in range(len(row[f"{n} closest"]))] for n in names}


def _verdict(label, row, names, card):
    """The fastest build on this set by its median weighted turn, and the
    builds whose turns overlap its own (tied with it)."""
    turns = _score(row, names)
    med = {n: statistics.median(v) for n, v in turns.items()}
    best = min(med, key=med.get)
    tied = [n for n in names if n != best
            and min(turns[n]) <= max(turns[best])]
    print(f"{label}, 15 x closest + 7 x any, median [min-max] of the "
          f"turns: fastest {best} {med[best]:.4f}; tied with it (turns "
          f"overlap): {', '.join(tied) or 'none'}; "
          + ", ".join(f"{n} {med[n]:.4f} [{min(v):.4f}-{max(v):.4f}]"
                      for n, v in turns.items()) + f" [{card}]", flush=True)
    return {"weighted_ms": turns, "median": med, "fastest": best,
            "tied": tied}


def _doubled(rays, want):
    rays2 = tuple(torch.cat([x, x], dim=-1).contiguous() for x in rays)
    want2 = {q: {k: torch.cat([v[k], v[k]]) for k in ("t", "tri")}
             for q, v in want.items()}
    return rays2, want2


def _tail_diagnostic(scene, rays, want, libs, dev, card, results):
    """Every build on these rays with the longest TAIL of them (by the
    plain walk's steps for the query) made dead (t_max = 0), and with
    only those live: how much of the time the long rays' chains set."""
    o, d, t_min, t_max = rays
    out = {}
    for q in ("closest", "any"):
        steps = want[q]["box_steps"] + want[q]["tri_steps"]
        cut = torch.topk(steps, int(TAIL * steps.numel())).indices
        long_ = torch.zeros_like(t_max, dtype=torch.bool)
        long_[cut] = True
        for part, dead in (("without_tail", long_), ("tail_only", ~long_)):
            cut_rays = (o, d, t_min, torch.where(dead, 0.0, t_max))
            calls = _calls(libs, scene, cut_rays, dev)
            for name in libs:
                out.setdefault(name, {}).setdefault(q, {})[part] = \
                    _time_ms(calls[(name, q)][0])
        for name in libs:
            out[name][q]["all"] = statistics.median(
                results["ms"]["big incoherent"][f"{name} {q}"])
        print(f"diagnostic, big scene incoherent {q}: the longest "
              f"{TAIL:.0%} ({cut.numel()} rays of >= "
              f"{int(steps[cut].min())} steps, up to {int(steps.max())}); "
              f"ms all (median) / without them / them alone: "
              + ", ".join(f"{n} {v[q]['all']:.4f} / "
                          f"{v[q]['without_tail']:.4f} / "
                          f"{v[q]['tail_only']:.4f}"
                          for n, v in out.items()) + f" [{card}]",
              flush=True)
    results["tail_diagnostic"] = out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--baseline", help="another checkout's csrc directory "
                   "whose trace_bvh.cu is timed beside these builds")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bvh_variants: no CUDA device")
    card = _card()
    dev = torch.device("cuda:0")
    variants = [(name, CSRC_DIR, (f"TPURT_BVH_WINDOW={w}",))
                for name, w in VARIANTS.items()]
    if args.baseline:
        variants.insert(0, ("baseline", os.path.abspath(args.baseline), ()))
    t0 = time.time()
    scenes_built = {}

    def build_scenes():
        from .models import scenes
        scenes_built["big"] = big_scene(dev, 8, (-0.3, 0.3))
        scenes_built["ucb"] = big_scene(dev, 7, (-0.6, 0.0, 0.6),
                                        brute_max=1)
        scenes_built["cornell"] = scenes.create_cornell_box(dev,
                                                            brute_max=1)
    # the scenes build on the host while nvcc runs
    builder = threading.Thread(target=build_scenes)
    builder.start()
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    built = _build_all("trace_bvh.cu", variants,
                       ("tpurt_bvh_closest_hit", "tpurt_bvh_any_hit"),
                       [ptr] * 7 + [i32] * 2 + [ptr] * 3)
    builder.join()
    if set(scenes_built) != {"big", "ucb", "cornell"}:
        raise RuntimeError("bvh_variants: building the scenes failed")
    libs = {name: lib for name, (lib, _) in built.items()}
    print(f"built {len(libs)} builds of trace_bvh.cu and the scenes in "
          f"{time.time() - t0:.2f} s [{card}]", flush=True)
    for name, (_, ptxas) in built.items():
        print(f"ptxas {name}: {' | '.join(ptxas)}", flush=True)

    results = {"card": card, "device": torch.cuda.get_device_name(0),
               "reps": REPS, "order": (list(libs) + list(libs)[::-1]) * PAIRS,
               "windows": VARIANTS,
               "ptxas": {k: v[1] for k, v in built.items()},
               "steps": {}, "ms": {}}
    big, ucb, cornell = (scenes_built[k] for k in ("big", "ucb", "cornell"))
    rays = walk_rays(dev, WALK_RAYS)
    for name, r in rays.items():
        want = _plain(big, r)
        for q in ("closest", "any"):
            st = step_stats(want[q])
            results["steps"][f"big {name} {q}"] = st
            print(f"big scene {name} {q}: {stats_text(st)}", flush=True)
        _run_set(f"big {name}", big, r, want, libs, dev, card, results)
        r2, want2 = _doubled(r, want)
        _run_set(f"big {name} x2", big, r2, want2, libs, dev, card,
                 results)
        if name == "incoherent":
            _tail_diagnostic(big, r, want, libs, dev, card, results)
        del want, r2, want2
    del big
    for name, r in rays.items():
        want = _plain(ucb, r)
        _run_set(f"ucb {name}", ucb, r, want, libs, dev, card, results)
    del ucb
    for name, r in _cornell_rays(cornell, dev).items():
        want = _plain(cornell, r)
        for q in ("closest", "any"):
            results["steps"][f"cornell {name} {q}"] = step_stats(want[q])
        _run_set(f"cornell {name}", cornell, r, want, libs, dev, card,
                 results)

    results["verdict"] = {
        label: _verdict(label, results["ms"][label], list(libs), card)
        for label in ("big incoherent", "cornell random",
                      "cornell primary")}
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
