#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: build, check, time.

    python3 chip_smoke.py

Phases (each prints one line; any failed check raises, so the exit code
is non-zero):
  1. device   - a CUDA device is required; prints its name and power
                limit as nvidia-smi reports them.
  2. build    - builds kernels K1 (closest-hit) and K2 (any-hit) from
                tpu_raytracer_torch/csrc/trace.cu with nvcc for sm_90a.
  3. K1       - against its plain PyTorch version on the card: Cornell
                512^2 primary rays and 524,288 random rays (random t_max,
                30% dead lanes). tri equal on every lane, t within T_ULPS.
  4. K2       - against plain closest-hit `tri >= 0` on the random rays.
  5. frame    - the Cornell ReSTIR frame at 512^2 through render_frame:
                2 warm-up + 8 timed frames (static_ok from the second
                frame on), launch counts of both kernels, fps, Mrays/s,
                and K1/K2 against plain at 262,144 and 524,288 rays.
  6. golden   - 8 frames of the 64^2 Cornell box against
                tests/golden/cornell_64_f8_ldr.npy, PSNR >= GOLDEN_DB.
Then one JSON line of per-kernel results, and last the device line
{"ok": true, "device": {...}}. Without a CUDA device it exits with 1 and
prints no result.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

T_ULPS = 2          # K1 t against plain; measured 0 on the CPU twin
GOLDEN_DB = 38.0
WARMUP, TIMED = 2, 8
WIDTH = HEIGHT = 512
RANDOM_RAYS = 524288
TIMED_RAYS = (262144, 524288)
DEVICE = "cuda:0"


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _random_rays(torch, n, device, seed=0):
    g = np.random.default_rng(seed)
    o = g.uniform(-0.95, 0.95, (3, n)).astype(np.float32)
    d = g.standard_normal((3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    t_max = g.uniform(0.01, 3.0, n).astype(np.float32)
    t_max[g.uniform(size=n) < 0.3] = 0.0            # dead lanes
    return tuple(torch.from_numpy(x).to(device) for x in (o, d, t_max))


def _ulps(a, b):
    return (a.view(np.int32).astype(np.int64)
            - b.view(np.int32).astype(np.int64))


def _time_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    import torch

    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = _card()
    print(f"device: {card} ({torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda})", flush=True)
    dev = torch.device(DEVICE)

    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from tpu_raytracer_torch.models import scenes
    from tpu_raytracer_torch.ops import gbuffer, trace_api
    from tpu_raytracer_torch.render import camera, pipeline, renderer
    from tpu_raytracer_torch.runtime.build import BUILD_LOGS
    from tpu_raytracer_torch.utils.vec3 import V3

    # 2. build
    t0 = time.time()
    trace_api.load_kernels()
    ptxas = [ln.strip() for ln in BUILD_LOGS.get("trace_kernels", "")
             .splitlines() if "registers" in ln or "Compiling entry" in ln]
    print(f"build: K1+K2 from csrc/trace.cu in {time.time() - t0:.2f} s "
          f"(nvcc sm_90a); ptxas: {' | '.join(ptxas) or 'cached'}",
          flush=True)

    scene = scenes.create_cornell_box(dev)
    cam = camera.CameraController()
    uniform = renderer.camera_to_device(
        cam.uniform(WIDTH / HEIGHT, 0, scene.num_lights), dev)

    def kernel(o, d, t_min, t_max, any_hit=False):
        return trace_api.trace_kernel(scene.tri_planes, scene.chunk_aabb,
                                      o, d, t_min, t_max, any_hit=any_hit)

    def plain(o, d, t_min, t_max):
        return trace_api.trace_plain(scene.tri_planes, scene.chunk_aabb,
                                     V3(*o), V3(*d), t_min, t_max)

    # 3. K1 against plain
    po, pd = gbuffer.generate_primary_rays(uniform, WIDTH, HEIGHT)
    primary = (torch.stack(list(po)).contiguous(),
               torch.stack(list(pd)).contiguous())
    n_p = primary[0].shape[1]
    p_win = (torch.full((n_p,), 1e-3, device=dev),
             torch.full((n_p,), 1000.0, device=dev))
    ro, rd, rt_max = _random_rays(torch, RANDOM_RAYS, dev)
    r_tmin = torch.full((RANDOM_RAYS,), 1e-3, device=dev)
    k1_err, k1_ulps = 0.0, 0
    for name, (o, d), (t_min, t_max) in (
            ("primary 512^2", primary, p_win),
            ("random", (ro, rd), (r_tmin, rt_max))):
        got, want = kernel(o, d, t_min, t_max), plain(o, d, t_min, t_max)
        torch.cuda.synchronize()
        g_tri, w_tri = got["tri"].cpu().numpy(), want["tri"].cpu().numpy()
        g_t, w_t = got["t"].cpu().numpy(), want["t"].cpu().numpy()
        bad = int((g_tri != w_tri).sum())
        if bad:
            raise AssertionError(f"K1 {name}: tri differs on {bad} lanes")
        hit = w_tri >= 0
        k1_ulps = max(k1_ulps, int(np.abs(_ulps(g_t, w_t)).max()))
        k1_err = max(k1_err, float(np.abs(g_t - w_t)[hit].max(initial=0)))
        if k1_ulps > T_ULPS:
            raise AssertionError(f"K1 {name}: t differs by {k1_ulps} ulps")
    print(f"K1: closest-hit equals plain on {n_p} primary + {RANDOM_RAYS} "
          f"random rays: tri equal on every lane, t max {k1_ulps} ulps "
          f"(bound {T_ULPS}), max |dt| {k1_err:.3g}", flush=True)

    # 4. K2 against plain closest-hit tri >= 0
    got = kernel(ro, rd, r_tmin, rt_max, any_hit=True)
    want = plain(ro, rd, r_tmin, rt_max)["tri"] >= 0
    torch.cuda.synchronize()
    k2_bad = int(((got["tri"] >= 0) != want).sum())
    k2_err = float(k2_bad > 0)     # max |flag difference|
    if k2_bad:
        raise AssertionError(f"K2: occlusion differs on {k2_bad} lanes")
    if not torch.equal(got["t"], rt_max):
        raise AssertionError("K2: t is not t_max")
    print(f"K2: any-hit equals plain closest-hit tri>=0 on {RANDOM_RAYS} "
          f"windowed rays ({float(want.float().mean()):.3f} occluded)",
          flush=True)

    # 5. frame: the main path
    state = pipeline.init_state(WIDTH, HEIGHT, dev)
    trace_api.reset_launch_counts()
    rays = []
    for i in range(WARMUP + TIMED):
        uniform = renderer.camera_to_device(
            cam.uniform(WIDTH / HEIGHT, i, scene.num_lights), dev)
        ldr, hdr, state, aux = pipeline.render_frame(
            scene, uniform, i, state, WIDTH, HEIGHT, static_ok=i > 0)
        if i == WARMUP - 1:
            torch.cuda.synchronize()
            t0 = time.time()
        elif i >= WARMUP:
            rays.append(aux["rays"])
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = dict(trace_api.LAUNCHES)
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel was never launched: {launches}")
    if not (torch.isfinite(ldr).all() and ldr.min() >= 0
            and ldr.max() <= 1):
        raise AssertionError("ldr is not finite in [0, 1]")
    if not torch.isfinite(hdr).all():
        raise AssertionError("hdr is not finite")
    total_rays = float(sum(float(r) for r in rays))
    if min(float(r) for r in rays) <= 0:
        raise AssertionError("aux['rays'] is not positive")
    fps = TIMED / dt
    print(f"frame: Cornell ReSTIR {WIDTH}x{HEIGHT}, {TIMED} timed frames: "
          f"{fps:.4f} fps, {total_rays / dt / 1e6:.4f} Mrays/s, "
          f"{dt / TIMED * 1e3:.2f} ms/frame, {total_rays / TIMED:.0f} "
          f"rays/frame; launches {launches} [{card}]", flush=True)

    timings = {}
    for n in TIMED_RAYS:
        o, d, t_min, t_max = ro[:, :n], rd[:, :n], r_tmin[:n], rt_max[:n]
        o, d = o.contiguous(), d.contiguous()
        t_k1 = _time_ms(torch, lambda: kernel(o, d, t_min, t_max), 20)
        t_k2 = _time_ms(torch, lambda: kernel(o, d, t_min, t_max, True), 20)
        t_plain = _time_ms(torch, lambda: plain(o, d, t_min, t_max), 3)
        # the plain any-hit is closest-hit followed by `tri >= 0`
        t_plain2 = _time_ms(
            torch, lambda: plain(o, d, t_min, t_max)["tri"] >= 0, 3)
        timings[n] = (t_k1, t_plain, t_k2, t_plain2)
        print(f"timing {n} random rays: K1 {t_k1:.4f} ms vs plain "
              f"{t_plain:.4f} ms; K2 {t_k2:.4f} ms vs plain {t_plain2:.4f} ms "
              f"[{card}]", flush=True)

    # 6. golden
    golden = np.load(os.path.join(root, "tests", "golden",
                                  "cornell_64_f8_ldr.npy")).astype(np.float32)
    gcam = camera.CameraController()
    gstate = pipeline.init_state(64, 64, dev)
    for f in range(8):
        u = renderer.camera_to_device(
            gcam.uniform(1.0, f, scene.num_lights), dev)
        gldr, _, gstate, _ = pipeline.render_frame(scene, u, f, gstate,
                                                   64, 64)
    mse = float(np.mean((gldr.cpu().numpy().astype(np.float64)
                         - golden) ** 2))
    psnr = float("inf") if mse <= 0 else 10.0 * np.log10(1.0 / mse)
    if not psnr >= GOLDEN_DB:
        raise AssertionError(f"golden PSNR {psnr:.2f} dB < {GOLDEN_DB}")
    print(f"golden: 64x64 Cornell, 8 frames: PSNR {psnr:.2f} dB vs "
          f"tests/golden/cornell_64_f8_ldr.npy (floor {GOLDEN_DB})",
          flush=True)

    src = "tpu_raytracer_torch/csrc/trace.cu"
    n = TIMED_RAYS[-1]
    print(json.dumps({"kernels": [
        {"name": "closest_hit", "route": "cuda", "source": src,
         "replaces": "tpu_raytracer/ops/pallas_trace.py:392",
         "launches": launches["closest_hit"], "max_abs_err": k1_err,
         "ms": timings[n][0], "plain_ms": timings[n][1]},
        {"name": "any_hit", "route": "cuda", "source": src,
         "replaces": "tpu_raytracer/ops/pallas_trace.py:611",
         "launches": launches["any_hit"], "max_abs_err": k2_err,
         "ms": timings[n][2], "plain_ms": timings[n][3]},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
