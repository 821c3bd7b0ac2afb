"""Interactive render loop: the reference app's event loop
(`tpu_raytracer/app/interactive.py`), on one torch device.

Replicates main.rs / state.rs behaviour headlessly (terminal keys instead
of winit):
  - continuous rendering with per-frame dt (main.rs:97 poll mode),
  - WASD move / arrow rotate / Space up / Z down (camera.rs:58-111; Z
    stands in for LShift - terminals can't see modifier state),
  - J toggles pause (state.rs:133-135), K queues an async screenshot
    (state.rs:136-138), Q quits, keys 0-4 switch the debug G-buffer
    visualization (renderer.rs:407-508),
  - camera motion resets the accumulation counter (state.rs:151-152),
  - fps / resolution / accumulated-sample telemetry, printed where the
    reference updates the window title (main.rs:81-95); on CUDA devices
    also the last frame's device ms by stage, from its graph's stamps
    (`stage_line`),
  - auto-screenshot when the accumulation counter reaches target_spp
    (state.rs:206-215), via the async saver thread,
  - checkpoint save on exit and resume on start (--checkpoint).

Every frame renders as one frame on one device, 3840x2160 included, or,
under --tiles N, as N row bands over N devices (parallel/tiles.py): the
first N CUDA devices, or N bands on the CPU with --device cpu. On CUDA
devices a frame is replayed from CUDA graphs: one device's from
render/graph.py:FrameGraph, N bands' from parallel/tiles.py:
TiledFrameGraph (each band in segments between its halo exchanges); the
CPU renders eagerly, the bands as threads. The reference app's TPU_RT_*
knobs arrive on the RenderConfig (utils/config.py:env_knobs): static
frames reuse last frame's G-buffer unless TPU_RT_GB_REUSE says otherwise,
as `python -m tpu_raytracer` does, and the trace-kernel mode, cull, cap
and batched spatial taps go to the scene build and the frame.
"""

from __future__ import annotations

import os
import select
import sys
import time

import numpy as np
import torch

from ..models import scenes as scene_catalog
from ..ops import gbuffer as gbuffer_ops
from ..ops import trace_api
from ..ops.post import resolve_tonemap
from ..parallel import tiles
from ..render import camera as camera_mod
from ..render import checkpoint, pipeline, renderer
from ..render.graph import FrameGraph
from ..utils.config import RenderConfig
from ..utils.profiling import STAGES, FrameStats
from ..utils.resample import resize_u8
from .screenshot import ScreenshotSaver, denoised_screenshot


def load_scene(name: str, device, kernel: str = "mxuf2",
               incull: bool = False, brute_max: int | None = None):
    """A catalog scene by name, or a .gltf/.glb path, built on `device`
    under the trace-kernel mode (kernel, incull) and cap (brute_max) that
    `SceneBuilder.build` takes."""
    build = {"kernel": kernel, "incull": incull, "brute_max": brute_max}
    catalog = {
        "cornell": scene_catalog.create_cornell_box,
        "cornell_diffuse": scene_catalog.create_cornell_box_diffuse,
        "restir": scene_catalog.create_restir_scene,
        "bunny": scene_catalog.create_bunny_scene,
        "avocado": scene_catalog.create_avocado_scene,
        "helmet": scene_catalog.create_damaged_helmet_scene,
        "vrm": scene_catalog.create_multi_material_model_scene,
        "truffle": scene_catalog.create_chocolate_truffle_scene,
        "knot": scene_catalog.create_dense_knot_scene,
        "gallery": scene_catalog.create_instancing_gallery_scene,
    }
    if name in catalog:
        return catalog[name](device, **build)
    if name.endswith((".gltf", ".glb")):
        return scene_catalog.create_gltf_scene(device, name, **build)
    raise ValueError(f"unknown scene '{name}'")


def debug_view(gb, hdr, mode: int, width: int, height: int):
    """G-buffer visualization modes (renderer.rs:407-508).

    1: position (float, through tonemap like the reference's post copy),
    2: normal-texture contents (oct.x, oct.y, uv.x), 3: albedo (direct),
    4: motion. Returns [n,3] display-ready values.
    """
    if mode == 1:
        return resolve_tonemap(torch.abs(gb["pos"]))
    if mode == 2:
        return resolve_tonemap(torch.abs(torch.cat(
            [gb["oct_normal"], gb["uv"][:, :1]], dim=-1)))
    if mode == 4:
        m = torch.abs(gb["motion"]) * 10.0
        return resolve_tonemap(torch.cat([m, m.new_zeros((m.shape[0], 1))],
                                         dim=-1))
    return gb["albedo"]   # 3: albedo, skips post entirely (:486-508)


class _RawTerminal:
    """Non-blocking single-key reads; no-op when stdin isn't a tty."""

    def __init__(self):
        self.enabled = sys.stdin.isatty()
        self._saved = None

    def __enter__(self):
        if self.enabled:
            import termios
            import tty

            self._saved = termios.tcgetattr(sys.stdin)
            tty.setcbreak(sys.stdin.fileno())
        return self

    def __exit__(self, *exc):
        if self._saved is not None:
            import termios

            termios.tcsetattr(sys.stdin, termios.TCSADRAIN, self._saved)

    def poll_keys(self) -> list:
        keys = []
        if not self.enabled:
            return keys
        while select.select([sys.stdin], [], [], 0)[0]:
            ch = sys.stdin.read(1)
            if ch == "\x1b":  # arrow escape sequences
                seq = sys.stdin.read(2) if select.select(
                    [sys.stdin], [], [], 0)[0] else ""
                keys.append({"[A": "up", "[B": "down", "[C": "right",
                             "[D": "left"}.get(seq, "esc"))
            else:
                keys.append(ch.lower())
        return keys


def _device(name: str) -> torch.device:
    """The device the app renders on; a CUDA device that is not there
    raises (the app never falls back to the CPU)."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device; pass "
                           f"--device cpu to render on the CPU")
    return dev


def _tile_mesh(n: int, dev: torch.device):
    """The mesh of `--tiles n`, or None for one device: n bands on the
    CPU, or the first n CUDA devices; with fewer, the app says so and
    renders on one device, as the reference does."""
    if n <= 1:
        return None
    if dev.type == "cpu":
        return tiles.make_mesh([dev] * n)
    count = torch.cuda.device_count()
    if count < n:
        print(f"--tiles {n} requested but only {count} device(s); falling "
              f"back to single-chip")
        return None
    return tiles.make_mesh([torch.device("cuda", i) for i in range(n)])


def run(cfg: RenderConfig) -> dict:
    """Run the interactive loop; returns the telemetry (FrameStats over
    the last 60 frames), the frames rendered and the kernel launches of
    the run."""
    dev = _device(cfg.device)
    w, h = cfg.width, cfg.height
    scene = load_scene(cfg.scene, dev, kernel=cfg.kernel, incull=cfg.incull,
                       brute_max=cfg.brute_max)
    cam = camera_mod.CameraController()
    state = pipeline.init_state(w, h, dev)
    frame_count = 0

    # --tiles N: row bands over N devices (parallel/tiles.py), with the
    # call shape of pipeline.render_frame; the state lives on the bands.
    # On CUDA devices: the frame's CUDA graphs, whose static state it is.
    mesh = _tile_mesh(cfg.tiles, dev)
    graph = None
    reuse, batch = cfg.gb_reuse, cfg.tap_batch
    if mesh is not None and dev.type == "cuda":
        graph = tiles.TiledFrameGraph(mesh, scene, w, h, cfg.halo,
                                      tap_batch=batch)

        def render_fn(camera, fc, state, static_ok):
            return graph(camera, fc, static_ok, gb_reuse=reuse)
    elif mesh is not None:
        tiled = tiles.make_render_frame_tiled(mesh, w, h, cfg.halo,
                                              tap_batch=batch)
        scene_r = tiles.replicate(scene, mesh)

        def render_fn(camera, fc, state, static_ok):
            return tiled(scene_r, camera, fc, state, static_ok,
                         gb_reuse=reuse)
    elif dev.type == "cuda":
        graph = FrameGraph(scene, w, h, dev, tap_batch=batch)

        def render_fn(camera, fc, state, static_ok):
            return graph(camera, fc, static_ok, gb_reuse=reuse)
    else:
        def render_fn(camera, fc, state, static_ok):
            return pipeline.render_frame(scene, camera, fc, state, w, h,
                                         static_ok=static_ok, gb_reuse=reuse,
                                         tap_batch=batch)

    def whole(state):
        """The frame state as one dict on `dev`."""
        return state if mesh is None else tiles.gather_state(state)

    if cfg.checkpoint and os.path.exists(cfg.checkpoint):
        st, frame_count, cam_state = checkpoint.load(cfg.checkpoint)
        state = {k: torch.as_tensor(v, device=dev) for k, v in st.items()}
        cam.position = cam_state["position"]
        cam.yaw, cam.pitch = cam_state["yaw"], cam_state["pitch"]
        cam.prev_view_proj = cam_state["prev_view_proj"]
        print(f"resumed from {cfg.checkpoint} at frame {frame_count}")
    if mesh is not None:
        state = tiles.shard_state(state, mesh)
    if graph is not None:
        graph.load_state(state)
        state = graph.state

    saver = ScreenshotSaver(cfg.out_dir)
    presenter = None
    if cfg.preview and sys.stdout.isatty():
        from .preview import TerminalPresenter

        presenter = TerminalPresenter(cols=cfg.preview_cols)
    paused = False
    debug_mode = cfg.debug_mode
    screenshot_requested = False
    auto_shot_done = False
    total_frames = 0
    stats = FrameStats()       # the first frame (kernel builds) untimed
    last_print = last_t = time.time()
    status_line = ""
    last_present = 0.0
    trace_api.reset_launch_counts()

    with _RawTerminal() as term:
        while cfg.max_frames == 0 or total_frames < cfg.max_frames:
            now = time.time()
            dt = now - last_t
            last_t = now

            for k in term.poll_keys():
                if k == "q":
                    cfg.max_frames = total_frames  # exit
                elif k == "j":
                    paused = not paused            # state.rs:133-135
                elif k == "k":
                    screenshot_requested = True    # state.rs:136-138
                elif k in "01234":
                    debug_mode = int(k)
                elif k in ("w", "a", "s", "d", "left", "right", "up", "down",
                           " ", "z"):
                    cam.press({" ": "space", "z": "shift"}.get(k, k))

            if paused and not screenshot_requested:
                # state.rs:147-149: skip everything while paused
                time.sleep(0.01)
                for k in list(cam.keys):
                    cam.release(k)
                continue

            moved = cam.update(dt if cam.keys else 0.0)
            for k in list(cam.keys):
                cam.release(k)
            if moved:
                frame_count = 0                    # state.rs:151-152
                auto_shot_done = False

            uniform = renderer.camera_to_device(
                cam.uniform(w / h, frame_count, scene.num_lights), dev)
            # dedup eligibility: same camera as last frame, scene untouched
            ldr, hdr, state, aux = render_fn(uniform, frame_count, state,
                                             frame_count > 0)

            if debug_mode != 0:
                gb = gbuffer_ops.unpack_gb(whole(state)["gb"])
                ldr = debug_view(gb, hdr, debug_mode, w, h)

            frame_count += 1
            total_frames += 1
            stats.frame(aux["rays"])

            # live display (blit/present analogue), throttled to spare the
            # host<->device link at high frame rates
            if presenter is not None and now - last_present >= 0.25:
                img = torch.clamp(ldr, 0.0, 1.0).reshape(h, w, 3)
                presenter.present(img.cpu().numpy(), status_line)
                last_present = now

            hit_target = (cfg.target_spp > 0 and frame_count >= cfg.target_spp
                          and not auto_shot_done)
            if screenshot_requested or hit_target:
                if cfg.denoise:
                    img = denoised_screenshot(whole(state)["gb"], hdr, w, h,
                                              cfg.denoise_iterations)
                else:
                    img = torch.clamp(ldr.reshape(h, w, 3), 0.0, 1.0) ** 2.2
                saver.submit(img)
                screenshot_requested = False
                if hit_target:
                    auto_shot_done = True

            if now - last_print >= 1.0:           # main.rs:81-95 telemetry
                last_print = now
                line = (f"FPS {stats.fps:6.2f} | {w}x{h} | samples "
                        f"{frame_count} | {stats.mrays_per_s:.1f} Mrays/s"
                        f" | mode {debug_mode}{' | PAUSED' if paused else ''}")
                if graph is not None:
                    line += stage_line(graph.stage_ms(), stats.fps)
                status_line = line
                if presenter is None:
                    print(line, flush=True)

    if cfg.checkpoint:
        checkpoint.save(cfg.checkpoint, whole(state), frame_count,
                        {"position": cam.position, "yaw": cam.yaw,
                         "pitch": cam.pitch,
                         "prev_view_proj": cam.prev_view_proj})
        print(f"checkpointed to {cfg.checkpoint}")
    saver.flush()
    return {"fps": stats.fps, "mrays_per_s": stats.mrays_per_s,
            "res": f"{w}x{h}", "samples": frame_count,
            "frames": total_frames, "launches": dict(trace_api.LAUNCHES)}


def stage_line(stage_ms: list, fps: float) -> str:
    """The status line's device part, from a frame graph's `stage_ms()`
    (one dict a card): the last frame's device ms of each stage, summed
    over the cards, and with several cards each card's busy share of a
    frame, its stages' ms over the frame time that fps gives."""
    if not stage_ms:
        return ""
    total = {k: sum(c.get(k, 0.0) for c in stage_ms) for k in STAGES
             if any(k in c for c in stage_ms)}
    line = " | device ms " + " ".join(f"{k} {v:.1f}"
                                      for k, v in total.items())
    if len(stage_ms) > 1 and fps > 0:
        line += " | busy " + " ".join(
            f"{100.0 * sum(c.values()) * fps / 1e3:.0f}%" for c in stage_ms)
    return line


def letterbox(img: np.ndarray, out_w: int, out_h: int,
              clear=(0.0, 0.0, 1.0)) -> np.ndarray:
    """Aspect-correct letterboxed blit (blit.wgsl + renderer.rs:381-397;
    blue clear color from blit.rs:119) of an RGB image, resized bicubic as
    the reference's PIL `resize` with no filter does it."""
    h, w = img.shape[:2]
    s = min(out_w / w, out_h / h)
    nw, nh = int(w * s), int(h * s)
    resized = resize_u8((np.clip(img, 0, 1) * 255).astype(np.uint8), nw, nh,
                        "bicubic")
    out = np.empty((out_h, out_w, 3), np.uint8)
    out[:] = (np.asarray(clear) * 255).astype(np.uint8)
    y0 = (out_h - nh) // 2
    x0 = (out_w - nw) // 2
    out[y0:y0 + nh, x0:x0 + nw] = resized[:, :, :3]
    return out
