"""Where a frame's time goes on the card: wall time per frame, device
kernel time by name (the port's own kernels K1-K8, listed apart, and
the table gather K7's), the device's busy share and the kernel launches
the host issues.

    python -m tpu_raytracer_torch.profile_frame --scene knot
    python -m tpu_raytracer_torch.profile_frame --scene cornell --kernel vpu
    python -m tpu_raytracer_torch.profile_frame --scene cornell \
        --size 3840x2160
    python -m tpu_raytracer_torch.profile_frame --scene big

`big` is the 2,621,444-triangle scene past the walk's cap
(`bigscene.big_scene(dev, 8, (-0.3, 0.3))`, chip_smoke.py phase
23's), `cornell-walk` the Cornell box built with brute_max=1: both take
K8, the BVH walk, for every query.

Renders WARMUP frames at `--size` (SIZE² unless given), times
`--frames` frames between
`torch.cuda.synchronize()` calls, then records the same number of frames
under `torch.profiler` and prints one JSON line. The busy share is the
profiled kernel time over the unprofiled wall time. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import functools
import json
import re
import subprocess
import time

import torch

from .bigscene import big_scene
from .models import scenes
from .ops import trace_api
from .render import camera, pipeline, renderer

SIZE = 512        # the frame's width and height
WARMUP = 3
TOP = 8           # kernels listed, by device time
# the port's hand-written kernels K1-K8 (csrc/*.cu), by their names
PORT_KERNEL = re.compile(
    r"^(?:void )?\(anonymous namespace\)::((?:closest_hit|any_hit|stream"
    r"|inst|vpu|mxu|gather|bvh)_kernel(?:<[^>]*>)?)\(")

# scene name -> its builder, called with the device
SCENES = {"big": functools.partial(big_scene, subdiv=8, xs=(-0.3, 0.3)),
          "bunny": scenes.create_bunny_scene,
          "cornell": scenes.create_cornell_box,
          "cornell-walk": functools.partial(scenes.create_cornell_box,
                                            brute_max=1),
          "gallery": scenes.create_instancing_gallery_scene,
          "knot": scenes.create_dense_knot_scene}


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--scene", choices=sorted(SCENES), default="gallery")
    p.add_argument("--frames", type=int, default=2)
    p.add_argument("--kernel", default="mxuf2",
                   help="the Cornell scene's trace-kernel mode "
                        "(SceneBuilder.build(kernel=))")
    p.add_argument("--incull", action="store_true",
                   help="the Cornell scene's in-kernel cull")
    p.add_argument("--size", default=f"{SIZE}x{SIZE}",
                   help="the frame's WIDTHxHEIGHT")
    args = p.parse_args(argv)
    try:
        w, h = (int(x) for x in args.size.lower().split("x"))
    except ValueError:
        p.error(f"--size {args.size!r}: want WIDTHxHEIGHT")
    mode = {"kernel": args.kernel, "incull": args.incull}
    if args.scene != "cornell" and mode != {"kernel": "mxuf2",
                                            "incull": False}:
        p.error("--kernel and --incull apply to --scene cornell")
    if not torch.cuda.is_available():
        raise SystemExit("profile_frame: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda:0")
    scene = SCENES[args.scene](dev,
                               **(mode if args.scene == "cornell" else {}))
    cam = camera.CameraController()
    state = pipeline.init_state(w, h, dev)
    frame = 0

    def run(n):
        nonlocal state, frame
        for _ in range(n):
            u = renderer.camera_to_device(
                cam.uniform(w / h, frame, scene.num_lights), dev)
            _, _, state, _ = pipeline.render_frame(
                scene, u, frame, state, w, h, static_ok=frame > 0)
            frame += 1
        torch.cuda.synchronize()

    run(WARMUP)
    trace_api.reset_launch_counts()
    t0 = time.time()
    run(args.frames)
    wall_ms = (time.time() - t0) * 1e3 / args.frames
    traversal = {k: v / args.frames for k, v in trace_api.LAUNCHES.items()}

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.time()
        run(args.frames)
        prof_wall_ms = (time.time() - t0) * 1e3 / args.frames
    avgs = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    kernels = sorted(((e.key, _device_us(e) / 1e3 / args.frames, e.count
                       / args.frames) for e in avgs
                      if e.device_type == cuda and _device_us(e) > 0),
                     key=lambda k: -k[1])
    device_ms = sum(k[1] for k in kernels)
    port = {}
    for name, ms, count in kernels:
        m = PORT_KERNEL.match(name)
        if m:
            port[m.group(1)] = {"ms": ms, "launches": count}
    # the row fetches' table gather (K7), which is rarely among the TOP
    k7 = port.get("gather_kernel", {"ms": 0.0, "launches": 0.0})
    # the BVH walk (K8), closest- and any-hit, on a scene past its cap
    k8 = [v for k, v in port.items() if k.startswith("bvh_kernel")]
    launches = sum(e.count for e in avgs
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                "cudaLaunchKernelExC")) / args.frames
    print(json.dumps({
        "scene": args.scene, **mode, "size": [w, h], "card": card,
        "wall_ms_per_frame": wall_ms,
        "profiled_wall_ms_per_frame": prof_wall_ms,
        "device_ms_per_frame": device_ms,
        "device_busy_share": device_ms / wall_ms,
        "host_launches_per_frame": launches,
        "traversal_launches_per_frame": traversal,
        "top_kernels_ms_per_frame": [
            {"name": k[0][:80], "ms": k[1], "launches": k[2]}
            for k in kernels[:TOP]],
        "k7_ms_per_frame": k7["ms"],
        "k7_launches_per_frame": k7["launches"],
        "k8_ms_per_frame": sum(v["ms"] for v in k8),
        "k8_launches_per_frame": sum(v["launches"] for v in k8),
        "port_kernels_ms_per_frame": port,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
