"""One run of one cell:

    python3 -m rtbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up builds the cell's scene on the card through the program's
`SceneBuilder`, makes the frame path and renders the traffic's set-up
frames, which capture every CUDA graph the window reaches. With
`--trace 0` the window then renders frames for `--seconds` seconds, each
waited for, and the run prints the cell's end-to-end metrics; with
`--trace 1` a stretch of frames runs under `torch.profiler` and the run
prints the cell's per-layer metrics. Either way the frames the seed
picks are compared with the reference once the window has closed
(`check.py`), and the last line on standard output is one JSON object:
correct, attempted, failed, metrics, device, breakdown (traced runs)
and, last, each compared number beside its limit. A traffic mix whose
frame path is `screenshot` also takes the app's denoised screenshots on
its schedule (`shots.py`): one untimed in set-up, then the window's, and
a shot the saver drops or does not write counts as failed.

The run exits with code 2 and prints no result where there is no CUDA
device, or fewer than the cell asks for, and with code 3 where a module
of JAX or of the JAX package was loaded into the process.

`--control bf16` puts the reference computed in bfloat16 in the
program's place, and `--control bf16_shading` the reference with its
shading alone in bfloat16 (the check's controls,
`reference/lower.py`; the benchmark's runs never use them).
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib
import json
import sys
import time

from . import cells, drive, shots, stats
from .reference import lower

FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_raytracer")


@dataclasses.dataclass
class RunView:
    """What a per-layer metric's reader reads."""
    cell: cells.Cell
    spans: dict
    trace: object           # profile.Trace, or None
    reference: dict         # counts from the reference's frames
    device_kind: str


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (`tpu_raytracer_torch` is not `tpu_raytracer`)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def _args(argv):
    p = argparse.ArgumentParser(prog="python3 -m rtbench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("none", *lower.CONTROLS),
                   default="none")
    return p.parse_args(argv)


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def device_log(kind: str, count: int):
    """A `log` whose every line names the device and how many."""
    def emit(*parts):
        log(f"[{kind} x {count}]", *parts)
    return emit


class GraphFrame:
    """The app's frame path on one CUDA device:
    `render/graph.py:FrameGraph`, with the refit inside the graph where
    the traffic moves instances."""

    def __init__(self, scene, traffic, devices):
        from tpu_raytracer_torch.render.graph import FrameGraph
        refit = traffic.get("refit")
        self.graph = FrameGraph(
            scene, traffic["width"], traffic["height"], devices[0],
            refit_changed=tuple(refit["ids"]) if refit else None,
            tap_batch=traffic["tap_batch"])
        self.gb_reuse = traffic["gb_reuse"]

    def __call__(self, uniform, frame_count, static_ok, transforms):
        return self.graph(uniform, frame_count, static_ok,
                          gb_reuse=self.gb_reuse, transforms=transforms)

    def refit_fields(self):
        s = self.graph.scene
        return {k: getattr(s, k).clone() for k in (
            "tri_planes", "chunk_aabb", "tri_table", "inst_transform",
            "inst_normal_mat")}

    @staticmethod
    def whole(state) -> dict:
        """A copy of the frame state, one tensor a key."""
        return {k: v.clone() for k, v in state.items()}


class BandsFrame:
    """The app's `--tiles N` path on N CUDA devices:
    `parallel/tiles.py:TiledFrameGraph`, one row band a device, halos
    exchanged between segments of each band's graphs."""

    def __init__(self, scene, traffic, devices):
        from tpu_raytracer_torch.parallel import tiles
        self.tiles = tiles
        self.graph = tiles.TiledFrameGraph(
            tiles.make_mesh(devices), scene, traffic["width"],
            traffic["height"], traffic["halo"],
            tap_batch=traffic["tap_batch"])
        self.gb_reuse = traffic["gb_reuse"]

    def __call__(self, uniform, frame_count, static_ok, transforms):
        if transforms is not None:
            raise ValueError("the bands path moves no instances")
        return self.graph(uniform, frame_count, static_ok,
                          gb_reuse=self.gb_reuse)

    def whole(self, state) -> dict:
        """The band states gathered into one frame state (a copy)."""
        return self.tiles.gather_state(state)


class ScreenshotFrame:
    """The app's frame path with `--denoise` screenshots: `GraphFrame`
    (or `inner`, a frame path of the same call shape) at the traffic's
    size, and the app's screenshot step (`shots.Shots`) after the frames
    the traffic's `screenshot` schedule names."""

    def __init__(self, scene, traffic, devices, inner=GraphFrame):
        self.inner = inner(scene, traffic, devices)
        self.shots = shots.Shots(traffic)

    def __call__(self, uniform, frame_count, static_ok, transforms):
        return self.inner(uniform, frame_count, static_ok, transforms)

    def whole(self, state) -> dict:
        return self.inner.whole(state)


FRAME_PATHS = {"graph": GraphFrame, "bands": BandsFrame,
               "screenshot": ScreenshotFrame}


def _snapshot(frame, out, input_state):
    record, ldr, hdr, state, aux = out
    return {"record": record, "input": input_state,
            "out": {"ldr": ldr.clone(), "hdr": hdr.clone(),
                    "state": frame.whole(state),
                    "rays": float(aux["rays"])}}


def measure(cell, seed: int, seconds: float, trace: bool, devices,
            t0: float, control=None, frame_factory=None, sync=None,
            log=log):
    """Set-up, the window (or the traced stretch) and the check. Returns
    the result dict. `control` names a control (`lower.CONTROLS`) that
    stands in the program's place in the check. `frame_factory(scene,
    traffic, devices)` and `sync` replace the traffic's CUDA frame path
    (FRAME_PATHS) and its wait (tests on the CPU)."""
    import torch

    from tpu_raytracer_torch.render import camera as port_camera
    from tpu_raytracer_torch.render.renderer import camera_to_device

    from . import check, profile, scenes
    from .reference import tables
    from .scenes import port

    traffic, config = cell.traffic, cell.config
    dev = devices[0]
    if sync is None:
        def sync():
            for d in devices:
                torch.cuda.synchronize(d)
    spans = {}

    t = t_scene = time.perf_counter()
    desc = scenes.describe(config)
    scene = port.build(desc, dev, kernel=config["kernel"],
                       brute_max=config.get("brute_max"))
    sync()
    spans["scene_build_s"] = time.perf_counter() - t

    scene_module = importlib.import_module(
        f"rtbench.scenes.{config['scene']}")
    refit = traffic.get("refit")
    moves = getattr(scene_module, refit["motion"]) if refit else None
    base = tables.instance_transforms(desc) if refit else None
    seq = drive.Sequence(traffic, desc, seed, base)

    t = time.perf_counter()
    frame = (frame_factory or FRAME_PATHS[traffic["path"]])(scene, traffic,
                                                            devices)
    w, h = traffic["width"], traffic["height"]
    driver = drive.Driver(seq, frame, port_camera.CameraController,
                          lambda cam: camera_to_device(cam, dev), w / h,
                          scene.num_lights, moves, sync)
    warm = traffic["warm_frames"]
    snaps = []
    last = None
    for i in range(warm):
        out = driver.step()
        if i == 0:
            snaps.append(_snapshot(frame, out, None))
        last = out
    spans["capture_s"] = time.perf_counter() - t
    # the screenshot step of the frame path that takes screenshots
    shot = getattr(frame, "shots", None)
    last_frame = max(seq.check)
    if shot is not None:
        shot.pick(seed)
        shot.warm(last)
        last_frame = max(last_frame, shot.check_frame())
    # the state each compared window frame starts from, copied as it
    # begins
    pending = [frame.whole(last[3])] if 0 in seq.check else []

    def on_frame(j, out):
        if shot is not None:
            shot.after_frame(j, out)
        if j in seq.check:
            snaps.append(_snapshot(frame, out, pending.pop()))
        if j + 1 in seq.check:
            pending.append(frame.whole(out[3]))

    sync()
    setup_s = time.perf_counter() - t0
    log(f"set-up {setup_s:.4f} s: before the scene {t_scene - t0:.4f}, "
        f"scene {spans['scene_build_s']:.4f}, frame path and set-up "
        f"frames {spans['capture_s']:.4f}")
    result = {"correct": False, "attempted": 0, "failed": 0, "metrics": {}}
    tr = None
    if trace:
        n = traffic["trace_frames"]
        with profile.profiled(n) as got:
            for j in range(n):
                on_frame(j, driver.step())
        tr = got[0]
        log("traced frames, ms: " + " ".join(
            f"{1e3 * sum(part):.1f}" for part in driver.host[-n:]))
        for j in range(n, last_frame + 1):
            on_frame(j, driver.step())
        result["attempted"] = n
    else:
        done, window_s = drive.run_window(driver, seconds, on_frame)
        # a compared frame the window did not reach is rendered after it,
        # untimed: late, not missing
        for j in range(len(done), last_frame + 1):
            on_frame(j, driver.step())
        times = stats.frame_times(done)
        result["attempted"] = len(done)
        e2e = {"fps": (len(done) / window_s, "frames/s"),
               "frame_ms_p90": (1e3 * stats.percentile(times, 90), "ms"),
               "setup_s": (setup_s, "s")}
        if shot is not None:
            shot.wait()
            e2e["screenshot_s"] = (shot.screenshot_s(len(done)), "s")
        result["metrics"] = {m["name"]: {"value": e2e[m["name"]][0],
                                         "unit": m["unit"]}
                             for m in cell.end_to_end
                             if e2e[m["name"]][0] is not None}
        log(f"window {window_s:.4f} s, {len(done)} frames, frame ms "
            + " ".join(f"p{q} {1e3 * stats.percentile(times, q):.4f}"
                       for q in (10, 25, 50, 75, 90, 100)))
        log("frame ms in order: "
            + " ".join(f"{1e3 * x:.1f}" for x in times))
        part = list(zip(*driver.host[-len(times):]))
        log("host ms a frame, median: inputs and uniform "
            f"{1e3 * stats.percentile(part[0], 50):.4f}, frame call "
            f"{1e3 * stats.percentile(part[1], 50):.4f}, wait for the "
            f"device {1e3 * stats.percentile(part[2], 50):.4f}")
    checked_shot = None
    if shot is not None:
        shot.wait()
        result["failed"] = shot.failed()
        spans["png_save_s"] = shot.png_save_s()
        log(f"screenshots: {len(shot.taken)} taken, {result['failed']} "
            f"dropped or not written; s from the step's start to the file "
            f"written: " + " ".join(
                f"{s['written'] - s['start']:.4f}" for s in shot.taken
                if s.get("written") is not None))
        checked_shot = shot.checked
        shot.close()
    peak = max(torch.cuda.max_memory_allocated(d) for d in devices) \
        if devices[0].type == "cuda" else 0
    log(f"memory peak {peak} bytes allocated (fullest device)")
    fields = frame.refit_fields() if refit else None
    last_tf = driver.seq.frame(driver.index - 1, moves).transforms \
        if refit else None
    frames_run = driver.index
    del frame, driver, scene, last, pending, shot
    gc.collect()
    if devices[0].type == "cuda":
        torch.cuda.empty_cache()
        for d in devices:
            torch.cuda.reset_peak_memory_stats(d)

    # the check, once the window has closed and the program's state is
    # freed
    t = time.perf_counter()
    numbers, counts = check.compare(snaps, desc, dev, seq, frames_run,
                                    traffic, fields, last_tf, control)
    if "screenshot" in traffic:
        numbers.update(check.shot_gaps(
            checked_shot, traffic["width"], traffic["height"],
            traffic["screenshot"]["denoise_iterations"], control))
    ref_peak = torch.cuda.max_memory_allocated(dev) \
        if dev.type == "cuda" else 0
    log(f"check: {len(snaps)} frames against the reference in "
        f"{time.perf_counter() - t:.2f} s, reference peak {ref_peak} bytes")
    result["correct"] = check.judge(numbers, cell.limits)

    kind = (torch.cuda.get_device_name(devices[0])
            if devices[0].type == "cuda" else "cpu")
    if trace:
        view = RunView(cell, spans, tr, counts, kind)
        for m in cell.per_layer:
            value = cells.metric_reader(m["name"])(view)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value,
                                                "unit": m["unit"]}
        log(f"traced: {view.reference['queries_per_frame']:.1f} queries "
            f"and {view.reference['stages_per_frame']:.1f} trace stages a "
            f"frame (reference)")
        ms = result["metrics"].get("trace_ms_per_frame")
        if ms:
            log(f"Mrays/s over trace device time: "
                f"{view.reference['queries_per_frame'] / ms['value'] / 1e3:.4f}"
                f" (not a metric)")
    result["device"] = {"platform": "gpu" if devices[0].type == "cuda"
                        else "cpu", "kind": kind, "count": len(devices),
                        "memory_peak_bytes": int(peak)}
    if trace:
        devs = tr.devices() or [None]
        result["device"]["busy_s"] = (sum(profile.busy(tr, d) for d in devs)
                                      / len(devs))
        result["device"]["window_s"] = tr.window[1] - tr.window[0]
        result["breakdown"] = profile.breakdown(tr)
        lo, hi = tr.window
        log("idle share by card: " + ", ".join(
            f"{d}: {100.0 * (1.0 - profile.busy(tr, d) / (hi - lo)):.4f}%"
            for d in devs))
    result["checked"] = {k: {"value": v, "limit": cell.limits.get(k)}
                         for k, v in numbers.items()}
    return result


def _power_limit() -> str:
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "power limit not read"


def main(t0: float, argv=None) -> int:
    args = _args(argv)
    cell = cells.load(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        log(f"{cell.name} needs {cell.chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            f": no measurement")
        return 2
    devices = [torch.device("cuda", i) for i in range(cell.chips)]
    kind = torch.cuda.get_device_name(devices[0])
    dlog = device_log(kind, len(devices))
    dlog(f"device: {kind} x {len(devices)} of {torch.cuda.device_count()} "
        f"({_power_limit()}); torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    result = measure(cell, args.seed, args.seconds, bool(args.trace),
                     devices, t0,
                     control=None if args.control == "none" else args.control,
                     log=dlog)
    found = forbidden_modules()
    if found:
        dlog(f"the run loaded {found}: the port must run without JAX or "
            f"the JAX package")
        return 3
    for k, v in result["checked"].items():
        dlog(f"check {k} {v['value']!r} limit {v['limit']!r} "
            f"{'ok' if v['limit'] is not None and v['value'] <= v['limit'] else 'FAIL'}")
    dlog(f"correct {result['correct']} on {kind} x {len(devices)}")
    print(json.dumps(result))
    return 0
