"""The truffle cell (`truffle.still_720p`) on the CPU at a tiny size: a
sound run, the faults this scene can hide planted in the program's side,
and the controls. The asset is shrunk (nu 24, a 32^2 texture), as the
knot is in `test_rtbench_run.py`; the three sphere lights keep their
5,120 triangles each."""

import os
import time

import numpy as np
import pytest
import torch

from rtbench import cells, run
from rtbench.scenes import port, truffle
from rtbench.tests import cpu_frame

CELL = "truffle.still_720p"


def _cell():
    cell = cells.load(CELL)
    cell.traffic.update(width=32, height=24, check_within=3, trace_frames=2)
    cell.config.update(asset_nu=24, texture_size=32)
    return cell


def _measure(control=None, seed=2 ** 31 + 7):
    return run.measure(_cell(), seed, 0.5, False, [torch.device("cpu")],
                       time.perf_counter(), control=control,
                       frame_factory=cpu_frame.EagerFrame,
                       sync=lambda: None, log=lambda *a: None)


@pytest.fixture(autouse=True)
def _cache(tmp_path, monkeypatch):
    monkeypatch.setattr(truffle, "CACHE_DIR", str(tmp_path))


def _program_builds(monkeypatch, change):
    """The program's scene built from the description's operations as
    `change(ops)` leaves them; the reference keeps the description."""
    real = port.build

    def build(desc, *args, **kwargs):
        return real(type(desc)(change(list(desc.ops)), desc.camera),
                    *args, **kwargs)
    monkeypatch.setattr(port, "build", build)


def test_sound_run_is_correct():
    r = _measure()
    assert r["correct"], r["checked"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["checked"]) == {"hdr_gap", "ldr_px_pct", "state_px_pct",
                                 "rays_gap"}
    assert set(r["metrics"]) == {"fps", "frame_ms_p90", "setup_s"}


def test_rewrite_dropped_is_caught(monkeypatch, tmp_path):
    """The program loads the stand-in as its generator writes it (the
    chocolate at roughness 0.6, the ribbon at 0.5): the rewrite left
    out."""
    from tpu_raytracer_torch.models.procedural_assets import \
        write_truffle_glb
    path = write_truffle_glb(str(tmp_path / "as_written.glb"), nu=24,
                             tex_size=32)

    def as_written(ops):
        i = next(k for k, op in enumerate(ops) if op[0] == "gltf")
        asset = truffle.TruffleAsset(ops[i][1].transform, 24, 32)
        asset.ensure = lambda: path
        ops[i] = ("gltf", asset)
        return ops
    _program_builds(monkeypatch, as_written)
    r = _measure()
    assert not r["correct"], r["checked"]


def test_key_light_halved_is_caught(monkeypatch):
    """The warm key light at x40, not x80."""
    def halved(ops):
        i = next(k for k, op in enumerate(ops) if op[0] == "sphere_light")
        assert ops[i][4] == 80.0
        ops[i] = ops[i][:4] + (40.0,)
        return ops
    _program_builds(monkeypatch, halved)
    r = _measure()
    assert not r["correct"], r["checked"]


def _bilinear(img, width, height, filt="lanczos"):
    """uint8 [H, W, C] resized by bilinear interpolation (pixel centres
    aligned), in place of Lanczos."""
    src = torch.as_tensor(np.ascontiguousarray(img)).permute(2, 0, 1)[None]
    out = torch.nn.functional.interpolate(src.double(), (height, width),
                                          mode="bilinear",
                                          align_corners=False)
    return out[0].permute(1, 2, 0).round().clamp(0, 255).byte().numpy()


def test_bilinear_texture_is_below_the_limits(monkeypatch):
    """The program's texture upsampled bilinear, not Lanczos. The texels
    are a near-white swirl, so the frame moves by little: here the
    G-buffer's albedo words differ in 13.4% of pixels and the HDR by
    4e-6, under the cell's limits, which leave room for the reference's
    own errors on grazing shadow rays (PERF.md section 2). The frame
    check does not see this fault; `tests/test_torch_truffle.py` holds
    the resize byte for byte."""
    from tpu_raytracer_torch.scene import builder
    img = truffle.truffle_texture(32)
    lanczos = builder._prep_texture(img, srgb=True)
    monkeypatch.setattr(builder, "resize_u8", _bilinear)
    assert not np.array_equal(builder._prep_texture(img, srgb=True), lanczos)
    checked = _measure()["checked"]
    assert checked["state_px_pct"]["value"] > 0.0, checked
    assert checked["hdr_gap"]["value"] < checked["hdr_gap"]["limit"], checked


@pytest.mark.parametrize("control", ["bf16", "bf16_shading"])
def test_control_is_caught(control):
    r = _measure(control=control)
    assert not r["correct"]
    failed = [k for k, v in r["checked"].items() if v["value"] > v["limit"]]
    assert failed, r["checked"]


def test_asset_written_once(tmp_path):
    asset = truffle.TruffleAsset(np.eye(4), 12, 16)
    path = asset.ensure()
    stamp = os.path.getmtime(path)
    assert asset.ensure() == path and os.path.getmtime(path) == stamp
    assert os.path.dirname(path) == str(tmp_path)
