"""The port's app layer against the reference's: config and CLI parsing,
letterbox, FrameStats, checkpoints (each package loads the other's), the
debug views, the interactive loop, its row bands (--tiles, --halo), and
`python -m tpu_raytracer_torch`.

Tolerances, each with its measured value:
  - checkpoints: arrays, frame count and camera EXACTLY equal, across
    the two packages in both directions;
  - debug views 1-4 on one G-buffer: EXACT (measured 0: the same
    divisions and maxima);
  - interactive.run of both packages (cornell_diffuse, 32x32, 3 frames):
    frame count and camera state equal, the accumulation's PSNR >=
    APP_DB (measured 123.4 dB; ROADMAP's floor, 38, is raised to the
    measured value less a wide margin, since one flipped path costs
    tens of dB).
"""

import json
import os
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from tpu_raytracer.app import interactive as ref_interactive
from tpu_raytracer.ops import gbuffer as ref_gbuffer
from tpu_raytracer.render import checkpoint as ref_checkpoint
from tpu_raytracer.utils.config import parse_args as ref_parse_args
from tpu_raytracer.utils.image import psnr
from tpu_raytracer_torch.app import interactive
from tpu_raytracer_torch.ops import gbuffer
from tpu_raytracer_torch.render import checkpoint, pipeline
from tpu_raytracer_torch.utils.config import parse_args
from tpu_raytracer_torch.utils.profiling import FrameStats

APP_DB = 100.0
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)


def test_scale_flag_parses_like_reference():
    for argv in (["--scale=640x360"], ["--scale=banana"],
                 ["--scene", "restir", "--denoise", "--target-spp", "64"]):
        got, want = parse_args(argv), ref_parse_args(argv)
        assert got.device == "cuda:0"
        for k in ("width", "height", "scene", "denoise", "target_spp"):
            assert getattr(got, k) == getattr(want, k), (argv, k)
    assert (parse_args(["--scale=banana"]).width,
            parse_args(["--scale=banana"]).height) == (1280, 720)
    assert parse_args(["--device", "cpu"]).device == "cpu"


def test_letterbox_aspect():
    img = np.ones((100, 200, 3), np.float32)  # 2:1 into a square window
    out = interactive.letterbox(img, 300, 300)
    assert out.shape == (300, 300, 3)
    # bars top and bottom are the blit clear colour (blue, blit.rs:119)
    assert (out[0] == np.array([0, 0, 255], np.uint8)).all()
    assert (out[150] == 255).all()  # a full-width content row
    assert np.array_equal(out, ref_interactive.letterbox(img, 300, 300))


@pytest.mark.parametrize("src,dst", [
    ((100, 200), (300, 300)), ((64, 64), (128, 128)),
    ((720, 1280), (1920, 1080)), ((48, 64), (64, 48))],
    ids=["200x100-300x300", "64x64-128x128", "1280x720-1920x1080",
         "no-resize"])
def test_letterbox_matches_reference(src, dst):
    """A non-constant frame (out of [0, 1] in places), byte-equal to the
    reference's PIL blit, bicubic."""
    img = np.random.default_rng(sum(src)).uniform(
        -0.1, 1.1, (*src, 3)).astype(np.float32)
    out = interactive.letterbox(img, *dst)
    assert out.shape == (dst[1], dst[0], 3)
    assert np.array_equal(out, ref_interactive.letterbox(img, *dst))


@pytest.mark.parametrize("count", [1e6, torch.tensor(1e6)],
                         ids=["float", "tensor"])
def test_frame_stats(count):
    """The app hands FrameStats the pipeline's 0-d ray-count tensors; they
    are read only by mrays_per_s and give the float counts' rate."""
    fs = FrameStats(window=8)
    for _ in range(4):
        fs.frame(count)
        time.sleep(0.01)
    assert fs.fps > 0
    assert fs.mrays_per_s == pytest.approx(3e6 / sum(fs.times) / 1e6,
                                           rel=1e-12)
    assert "fps" in fs.summary()


def _cam_state():
    return {"position": np.asarray([1.0, 2.0, 3.0]), "yaw": 0.5,
            "pitch": -0.25, "prev_view_proj": np.eye(4)}


def test_checkpoint_roundtrip(tmp_path):
    state = pipeline.init_state(8, 8, "cpu")
    state["accum"] = torch.rand(64, 3)
    path = str(tmp_path / "ckpt.npz")
    checkpoint.save(path, state, 42, _cam_state())
    st, frames, cs = checkpoint.load(path)
    assert frames == 42
    assert np.array_equal(st["accum"], state["accum"].numpy())
    assert np.allclose(cs["position"], [1, 2, 3])
    assert cs["yaw"] == 0.5 and cs["pitch"] == -0.25


def test_checkpoint_format_mismatch_rejected(tmp_path):
    path = str(tmp_path / "old.npz")
    meta = {"format": {"gb_cols": 14, "res_cols": 8},  # pre-dedup layout
            "frame_count": 3,
            "camera": {"position": [0, 0, 0], "yaw": 0.0, "pitch": 0.0,
                       "prev_view_proj": None}}
    np.savez_compressed(path, meta=json.dumps(meta),
                        accum=np.zeros((64, 3), np.float32))
    with pytest.raises(ValueError, match="incompatible"):
        checkpoint.load(path)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoints_cross(tmp_path, writer):
    """A checkpoint either package writes loads in the other, equal."""
    rng = np.random.default_rng(4)
    state = {"gb": rng.standard_normal((64, 14)).astype(np.float32),
             "res": rng.standard_normal((64, 12)).astype(np.float32),
             "accum": rng.random((64, 3)).astype(np.float32)}
    path = str(tmp_path / "x.npz")
    save, load = ((ref_checkpoint.save, checkpoint.load)
                  if writer == "reference"
                  else (checkpoint.save, ref_checkpoint.load))
    save(path, state if writer == "reference" else
         {k: torch.from_numpy(v) for k, v in state.items()}, 17, _cam_state())
    st, frames, cs = load(path)
    assert frames == 17 and sorted(st) == sorted(state)
    for k in state:
        assert np.array_equal(st[k], state[k]), k
    assert np.array_equal(cs["prev_view_proj"], np.eye(4, dtype=np.float32))
    assert (cs["yaw"], cs["pitch"]) == (0.5, -0.25)


@pytest.fixture(scope="module")
def app_runs(tmp_path_factory):
    """interactive.run of both packages on one config, with checkpoints."""
    tmp = tmp_path_factory.mktemp("app")
    out = {}
    for name, parse, run in (
            ("reference", ref_parse_args, ref_interactive.run),
            ("port", parse_args, interactive.run)):
        ck = str(tmp / f"{name}.npz")
        argv = ["--scene", "cornell_diffuse", "--scale=32x32",
                "--max-frames", "3", "--no-preview", "--checkpoint", ck,
                "--out-dir", str(tmp / name)]
        cfg = parse(argv + (["--device", "cpu"] if name == "port" else []))
        out[name] = (run(cfg), *checkpoint.load(ck))
    return out


def test_app_matches_reference(app_runs):
    tel, state, frames, cam = app_runs["port"]
    _, r_state, r_frames, r_cam = app_runs["reference"]
    assert tel["frames"] == 3 and frames == r_frames == 3
    assert tel["fps"] > 0 and tel["mrays_per_s"] > 0   # FrameStats, frames 2-3
    for k in ("position", "prev_view_proj"):
        assert np.array_equal(cam[k], r_cam[k]), k
    assert (cam["yaw"], cam["pitch"]) == (r_cam["yaw"], r_cam["pitch"])
    assert np.isfinite(state["accum"]).all()
    p = psnr(state["accum"], r_state["accum"])
    assert p >= APP_DB, f"accum PSNR {p:.2f} dB"


@pytest.mark.parametrize("mode", [1, 2, 3, 4])
def test_debug_view_matches_reference(app_runs, mode):
    rows = app_runs["port"][1]["gb"]
    want = np.asarray(ref_interactive.debug_view(
        ref_gbuffer.unpack_gb(jax.numpy.asarray(rows)), None, mode, 32, 32))
    got = interactive.debug_view(gbuffer.unpack_gb(torch.from_numpy(rows)),
                                 None, mode, 32, 32)
    assert got.shape == (32 * 32, 3)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("name,writer,kw", [
    ("avocado", "write_avocado_glb", dict(nu=24, nv=16, tex_size=32)),
    ("helmet", "write_helmet_glb", dict(nu=32, tex_size=32)),
    ("vrm", "write_figure_glb", dict(nu=12, tex_size=32)),
    ("truffle", "write_truffle_glb", dict(nu=24, tex_size=32))])
def test_named_scene_loads(tmp_path, monkeypatch, name, writer, kw):
    """The reference's four asset scenes load by name, from a small
    stand-in (the default-size ones are built on the card)."""
    from tpu_raytracer_torch.models import procedural_assets as pa

    path = getattr(pa, writer)(str(tmp_path / f"{name}.glb"), **kw)
    monkeypatch.setattr(pa, "ensure_asset", lambda _: path)
    scene = interactive.load_scene(name, "cpu")
    # more than the floor and light of the glTF fallback
    assert scene.num_triangles > 500
    assert scene.num_lights == (3 if name == "truffle" else 1)

def _tiled_app(tmp_path, tiles: int, frames: int, tag: str):
    """interactive.run on the CPU over `tiles` row bands; returns the
    telemetry, the PNG it wrote and its checkpoint."""
    from tpu_raytracer_torch.utils import png

    out = tmp_path / f"out_{tag}"
    ck = str(tmp_path / f"ck_tiles{tiles}.npz")
    tel = interactive.run(parse_args([
        "--scene", "cornell_diffuse", "--scale=32x32", "--device", "cpu",
        "--tiles", str(tiles), "--halo", "16", "--max-frames", str(frames),
        "--target-spp", "2", "--no-preview", "--checkpoint", ck,
        "--out-dir", str(out)]))
    shots = sorted(out.glob("*.png"))
    img = png.decode(shots[-1].read_bytes()) if shots else None
    return tel, img, checkpoint.load(ck)


def test_tiles_app_matches_one_device(tmp_path):
    """--device cpu --tiles 2 renders over two row bands: its screenshot
    and checkpoint equal --tiles 1's, and its checkpoint resumes onto the
    bands (tolerance: none; the bands' frames equal the one-device
    frames bit for bit here)."""
    runs = {}
    for tiles in (2, 1):
        first = _tiled_app(tmp_path, tiles, 2, f"{tiles}a")
        resumed = _tiled_app(tmp_path, tiles, 1, f"{tiles}b")
        runs[tiles] = (first, resumed)
    for (tel, img, (state, frames, _)), (r_tel, r_img, (r_state, r_frames,
                                                        _)) \
            in zip(runs[2], runs[1]):
        assert tel["frames"] == r_tel["frames"] and frames == r_frames
        for k in state:     # bit patterns: seeds ride as f32 words
            assert np.array_equal(state[k].view(np.uint32),
                                  r_state[k].view(np.uint32)), k
    (_, img, _), (_, r_img, _) = runs[2][0], runs[1][0]
    assert img is not None and img.shape[:2] == (32, 32)
    assert np.array_equal(img, r_img)
    assert runs[2][0][0]["mrays_per_s"] > 0   # FrameStats, frame 2
    assert runs[2][1][2][1] == 3            # resumed at 2, one more frame


def test_tiles_fall_back_to_one_card(monkeypatch, capsys):
    """--tiles N on CUDA with fewer than N cards prints the reference's
    message and renders on one device."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert interactive._tile_mesh(2, torch.device("cuda:0")) is None
    assert "--tiles 2 requested but only 1 device(s); falling back to " \
        "single-chip" in capsys.readouterr().out
    assert interactive._tile_mesh(1, torch.device("cuda:0")) is None
    mesh = interactive._tile_mesh(3, torch.device("cpu"))
    assert mesh.devices == [torch.device("cpu")] * 3


def test_halo_flag_parses_like_reference():
    for argv in ([], ["--halo", "4", "--tiles", "8"]):
        got, want = parse_args(argv), ref_parse_args(argv)
        assert (got.halo, got.tiles) == (want.halo, want.tiles)


def test_module_runs_on_cpu(tmp_path):
    env = {**os.environ, "PYTHONPATH": ROOT}
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_raytracer_torch", "--device", "cpu",
         "--scale=16x16", "--max-frames", "1", "--no-preview"],
        cwd=tmp_path, env=env, stdin=subprocess.DEVNULL, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    tel = json.loads(proc.stdout.strip().splitlines()[-1])
    assert tel["frames"] == 1


KNOBS = ("TPU_RT_GB_REUSE", "TPU_RT_BRUTE_MAX", "TPU_RT_KERNEL",
         "TPU_RT_INCULL", "TPU_RT_TAP_BATCH")


def _knob_run(tmp_path, monkeypatch, env):
    """interactive.run on the CPU (cornell, 8x8, 2 frames) under the
    TPU_RT_* variables `env` (the others unset): the config, and per
    frame the scene and keyword arguments render_frame got and the ctx
    restir_spatial got."""
    from tpu_raytracer_torch.ops import restir

    for name in KNOBS:
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    frames, ctxs = [], []
    orig_frame, orig_spatial = pipeline.render_frame, restir.restir_spatial

    def frame(scene, *args, **kwargs):
        frames.append((scene, kwargs))
        return orig_frame(scene, *args, **kwargs)

    def spatial(*args):
        ctxs.append(args[-1])
        return orig_spatial(*args)
    monkeypatch.setattr(pipeline, "render_frame", frame)
    monkeypatch.setattr(restir, "restir_spatial", spatial)
    cfg = parse_args(["--device", "cpu", "--scale=8x8", "--max-frames", "2",
                      "--no-preview", "--out-dir", str(tmp_path)])
    interactive.run(cfg)
    return cfg, frames, ctxs


def test_knobs_default_to_the_reference_app(tmp_path, monkeypatch):
    """With no TPU_RT_* variable set the app runs as `python -m
    tpu_raytracer` does: the G-buffer reused on static frames, the 2M
    cap, mxuf2, no in-kernel cull, sequential taps."""
    from tpu_raytracer_torch.ops import trace_api

    cfg, frames, ctxs = _knob_run(tmp_path, monkeypatch, {})
    assert (cfg.gb_reuse, cfg.brute_max, cfg.kernel, cfg.incull,
            cfg.tap_batch) == (True, None, "mxuf2", False, False)
    scene = frames[0][0]
    assert scene.brute_max == trace_api.BRUTE_FORCE_MAX_TRIS == 2 * 1024 ** 2
    assert (scene.kernel, scene.incull) == ("mxuf2", False)
    assert [kw["gb_reuse"] for _, kw in frames] == [True, True]
    assert [kw["tap_batch"] for _, kw in frames] == [False, False]
    assert [c["tap_batch"] for c in ctxs] == [False, False]


def test_knobs_reach_the_frame(tmp_path, monkeypatch):
    """TPU_RT_GB_REUSE=0 reaches render_fn as gb_reuse=False and
    TPU_RT_TAP_BATCH=1 reaches the ReSTIR ctx."""
    cfg, frames, ctxs = _knob_run(tmp_path, monkeypatch, {
        "TPU_RT_GB_REUSE": "0", "TPU_RT_TAP_BATCH": "1"})
    assert (cfg.gb_reuse, cfg.tap_batch) == (False, True)
    assert [kw["gb_reuse"] for _, kw in frames] == [False, False]
    assert [c["tap_batch"] for c in ctxs] == [True, True]


def test_knobs_reach_the_scene(tmp_path, monkeypatch):
    """TPU_RT_BRUTE_MAX=1, TPU_RT_KERNEL=vpu and TPU_RT_INCULL=1 reach
    the built scene; TPU_RT_BRUTE_MAX=0 is the default cap."""
    _, frames, _ = _knob_run(tmp_path, monkeypatch, {
        "TPU_RT_BRUTE_MAX": "1", "TPU_RT_KERNEL": "vpu",
        "TPU_RT_INCULL": "1"})
    scene = frames[0][0]
    assert (scene.brute_max, scene.kernel, scene.incull) == (1, "vpu", True)
    monkeypatch.setenv("TPU_RT_BRUTE_MAX", "0")
    assert parse_args([]).brute_max is None


def test_bad_kernel_knob_raises(monkeypatch):
    """A TPU_RT_KERNEL that names no mode raises as trace_api.check_mode
    does."""
    monkeypatch.setenv("TPU_RT_KERNEL", "mxq7")
    with pytest.raises(ValueError, match="kernel='mxq7'"):
        parse_args([])
