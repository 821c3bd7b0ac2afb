"""What config 4's per-frame refit costs on the card: the Cornell box's
crystal (instance 6) moved by bench.py's wobble and refit with
`update_instances(changed=(6,))`, as `chip_smoke.py` phase 20 does it.

    python -m tpu_raytracer_torch.profile_refit
    python -m tpu_raytracer_torch.profile_refit --reps 20

Runs WARMUP refits, then times `--reps` refits on the host clock (the
launches, no synchronisation) and records the same number under
`torch.profiler` for their device time and kernel launches. Prints one
JSON line with the card's name and power limit. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from .models import scenes
from .ops import refit
from .utils.math3d import rotation_y, scale, translation

WARMUP = 3
CRYSTAL = 6       # the Cornell box's moving instance (bench.py:194-199)
LAUNCH_KEYS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reps", type=int, default=10)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_refit: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda:0")
    scene = scenes.create_cornell_box(dev)
    base = scene.inst_transform.cpu().numpy()

    def wobble(i):
        """bench.py:194-199, on the card before the refit runs."""
        tf = base.copy()
        tf[CRYSTAL] = (translation([0.4, -0.5 + 0.02 * (i % 8), 0.3])
                       @ rotation_y(0.1 * i) @ scale(0.5))[:3, :4]
        return torch.as_tensor(tf, dtype=torch.float32, device=dev)

    tfs = [wobble(i) for i in range(WARMUP + args.reps)]
    for tf in tfs[:WARMUP]:
        scene = refit.update_instances(scene, tf, changed=(CRYSTAL,))
    torch.cuda.synchronize()
    host_ms = []
    for tf in tfs[WARMUP:]:
        t0 = time.perf_counter()
        scene = refit.update_instances(scene, tf, changed=(CRYSTAL,))
        host_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for tf in tfs[WARMUP:]:
            scene = refit.update_instances(scene, tf, changed=(CRYSTAL,))
        torch.cuda.synchronize()
    avgs = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    device_ms = sum(e.self_device_time_total for e in avgs
                    if e.device_type == cuda) / 1e3 / args.reps
    launches = sum(e.count for e in avgs
                   if e.key in LAUNCH_KEYS) / args.reps
    print(json.dumps({
        "refit": f"Cornell changed=({CRYSTAL},)", "reps": args.reps,
        "card": card, "host_ms_mean": sum(host_ms) / len(host_ms),
        "host_ms_min": min(host_ms), "host_ms_max": max(host_ms),
        "device_ms": device_ms, "launches": launches}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
