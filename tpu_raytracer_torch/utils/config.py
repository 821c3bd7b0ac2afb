"""Render configuration and command-line flags
(`tpu_raytracer/utils/config.py`).

The reference app's one flag, `--scale=WxH` (main.rs:107-122), parses as
it does there; the rest is a dataclass and argparse. `--device` picks the
torch device the app renders on: `cuda:0` unless the caller asks for the
CPU.

`python -m tpu_raytracer` also honours five TPU_RT_* environment
variables, which have no flag there. They are read here and nowhere else
in the package (`env_knobs`), and reach the scene build and the frame as
plain arguments:

  TPU_RT_GB_REUSE   "1" (the reference app's default): reuse the
                    G-buffer on static frames; anything else traces it
  TPU_RT_BRUTE_MAX  the triangle slots past which queries walk the BVH;
                    "0" or unset: the default cap (2M)
  TPU_RT_KERNEL     the trace-kernel mode, default mxuf2
  TPU_RT_INCULL     not "0": the in-kernel cull
  TPU_RT_TAP_BATCH  not "0": batched spatial-tap visibility
"""

from __future__ import annotations

import argparse
import dataclasses
import os

from ..ops.trace_api import check_mode


@dataclasses.dataclass
class RenderConfig:
    scene: str = "cornell"          # models/scenes.py name or a .gltf path
    width: int = 1280               # reference default 1280x720 (main.rs:122)
    height: int = 720
    target_spp: int = 0             # auto-screenshot at N accumulated frames
                                    # (state.rs:206-215 TARGET_SPP; 0 = off)
    denoise: bool = False           # screenshot denoiser (ai-denoise feature)
    denoise_iterations: int = 4
    debug_mode: int = 0             # 0 shaded | 1 pos | 2 normal | 3 albedo
                                    # | 4 motion (renderer.rs:407-508)
    tiles: int = 1                  # row bands over devices (1 = one device)
    halo: int = 16                  # rows each band reads of its neighbours
    checkpoint: str = ""            # resume path ("" = fresh)
    out_dir: str = "output"
    max_frames: int = 0             # 0 = run until quit
    preview: bool = True            # live ANSI frame display (blit analogue;
                                    # off when stdout is not a tty)
    preview_cols: int = 100
    device: str = "cuda:0"          # torch device; "cpu" only when asked
    # the reference app's environment knobs (`env_knobs`)
    gb_reuse: bool = True           # TPU_RT_GB_REUSE
    brute_max: int | None = None    # TPU_RT_BRUTE_MAX (None: the default)
    kernel: str = "mxuf2"           # TPU_RT_KERNEL
    incull: bool = False            # TPU_RT_INCULL
    tap_batch: bool = False         # TPU_RT_TAP_BATCH


def env_knobs(environ=None) -> dict:
    """The reference app's TPU_RT_* knobs from `environ` (os.environ by
    default), as RenderConfig fields, read as `python -m tpu_raytracer`
    reads them: the G-buffer reuse set unless TPU_RT_GB_REUSE is another
    value than "1" (its __main__'s setdefault, pipeline.py:67); a bad
    kernel mode raises ValueError (`trace_api.check_mode`)."""
    env = os.environ if environ is None else environ
    return {
        "gb_reuse": env.get("TPU_RT_GB_REUSE", "1") == "1",
        "brute_max": int(env.get("TPU_RT_BRUTE_MAX", "0")) or None,
        "kernel": check_mode(env.get("TPU_RT_KERNEL", "mxuf2")),
        "incull": env.get("TPU_RT_INCULL", "0") != "0",
        "tap_batch": env.get("TPU_RT_TAP_BATCH", "0") != "0",
    }


def parse_args(argv=None) -> RenderConfig:
    cfg = RenderConfig()
    ap = argparse.ArgumentParser(description="tpu_raytracer_torch")
    ap.add_argument("--scale", type=str, default=None,
                    help="WxH render resolution (reference flag)")
    ap.add_argument("--scene", type=str, default=cfg.scene,
                    help="cornell, cornell_diffuse, restir, bunny, "
                         "avocado, helmet, vrm, truffle, knot, gallery or "
                         "a .gltf/.glb path")
    ap.add_argument("--target-spp", type=int, default=cfg.target_spp)
    ap.add_argument("--denoise", action="store_true")
    ap.add_argument("--denoise-iterations", type=int,
                    default=cfg.denoise_iterations)
    ap.add_argument("--debug-mode", type=int, default=cfg.debug_mode)
    ap.add_argument("--tiles", type=int, default=cfg.tiles,
                    help="row bands: the first N CUDA devices, or N bands "
                         "on the CPU with --device cpu")
    ap.add_argument("--halo", type=int, default=cfg.halo)
    ap.add_argument("--checkpoint", type=str, default=cfg.checkpoint)
    ap.add_argument("--out-dir", type=str, default=cfg.out_dir)
    ap.add_argument("--max-frames", type=int, default=cfg.max_frames)
    ap.add_argument("--no-preview", dest="preview", action="store_false")
    ap.add_argument("--preview-cols", type=int, default=cfg.preview_cols)
    ap.add_argument("--device", type=str, default=cfg.device,
                    help="torch device (default cuda:0; cpu runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)

    if args.scale:
        # main.rs:107-122: "--scale=WxH", fall back to default on parse error
        try:
            w, h = args.scale.lower().split("x")
            cfg.width, cfg.height = int(w), int(h)
        except ValueError:
            print(f"invalid --scale '{args.scale}', using "
                  f"{cfg.width}x{cfg.height}")
    for name in ("scene", "target_spp", "denoise", "denoise_iterations",
                 "debug_mode", "tiles", "halo", "checkpoint", "out_dir",
                 "max_frames", "preview", "preview_cols", "device"):
        setattr(cfg, name, getattr(args, name))
    for name, value in env_knobs().items():
        setattr(cfg, name, value)
    return cfg
