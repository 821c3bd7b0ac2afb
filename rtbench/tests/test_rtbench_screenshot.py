"""The screenshot cell (`cornell.screenshot_2160p`) on the CPU at a tiny
size: the `screenshot` frame path through `frame_factory` (the program's
eager frame in place of its CUDA graphs), shots taken, written, read
back and counted; the reference denoiser against the program's; the
harness's PNG reader; the faults the check must catch; and the denoise
readers on a hand-built trace."""

import functools
import os
import struct
import time
import zlib

import numpy as np
import pytest
import torch

from rtbench import cells, png, profile, run, shots
from rtbench.reference import denoise as ref_denoise
from rtbench.tests import cpu_frame
from tpu_raytracer_torch.app import screenshot as port_screenshot
from tpu_raytracer_torch.ops import denoise as port_denoise
from tpu_raytracer_torch.utils import png as port_png

CELL = "cornell.screenshot_2160p"


def _cell():
    cell = cells.load(CELL)
    cell.traffic.update(width=32, height=24, check_within=2,
                        trace_frames=2)
    cell.traffic["screenshot"].update(every=2, phase=0, check_within=1)
    return cell


def _measure(control=None, trace=False, seconds=1.5,
             inner=cpu_frame.EagerFrame):
    frame = functools.partial(run.ScreenshotFrame, inner=inner)
    return run.measure(_cell(), 2 ** 31 + 11, seconds, trace,
                       [torch.device("cpu")], time.perf_counter(),
                       control=control, frame_factory=frame,
                       sync=lambda: None, log=lambda *a: None)


def test_sound_run_is_correct():
    r = _measure()
    assert r["correct"], r["checked"]
    assert r["attempted"] >= 2 and r["failed"] == 0
    assert set(r["metrics"]) == {"fps", "setup_s", "screenshot_s"}
    assert r["metrics"]["screenshot_s"]["value"] > 0
    assert set(r["checked"]) == {"hdr_gap", "ldr_px_pct", "state_px_pct",
                                 "rays_gap", "shot_gap", "png_px_pct"}
    # the PNG was written, read back and equal to the reference's bytes
    assert r["checked"]["png_px_pct"]["value"] == 0.0
    assert list(r)[-1] == "checked"


def test_traced_run_reports_png_save_s():
    r = _measure(trace=True)
    assert r["correct"], r["checked"]
    assert r["metrics"]["png_save_s"]["value"] > 0
    assert "screenshot_s" not in r["metrics"]


def test_shots_are_scheduled_counted_and_cleaned_up(monkeypatch):
    made = []
    real = shots.Shots.__init__

    def init(self, traffic):
        real(self, traffic)
        made.append(self)
    monkeypatch.setattr(shots.Shots, "__init__", init)
    r = _measure()
    s, = made
    frames = [x["frame"] for x in s.taken]
    assert frames[0] is None                     # set-up's shot
    assert frames[1:] == list(range(0, frames[-1] + 1, 2))
    assert all(x["written"] >= x["returned"] >= x["start"]
               for x in s.taken)
    assert r["failed"] == 0
    assert not os.path.exists(s.dir)


def test_reference_denoise_word_equal_to_the_port():
    g = torch.Generator().manual_seed(5)
    h = w = 32
    hdr = torch.rand(h, w, 3, generator=g) * 4.0
    albedo = torch.rand(h, w, 3, generator=g)
    octn = torch.rand(h, w, 2, generator=g) * 2.0 - 1.0
    pos = torch.rand(h, w, 3, generator=g) * 3.0
    for levels in (1, 4):
        a = port_denoise.atrous_denoise(hdr, albedo, octn, pos, levels)
        b = ref_denoise.atrous_denoise(hdr, albedo, octn, pos, levels)
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    rows = torch.rand(h * w, 14, generator=g)
    flat = hdr.reshape(-1, 3)
    a = port_screenshot.denoised_screenshot(rows, flat, w, h, 4)
    b = ref_denoise.denoised_screenshot(rows, flat, w, h, 4)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    img = np.linspace(-0.5, 1.5, 300, dtype=np.float32).reshape(10, 10, 3)
    from tpu_raytracer_torch.utils.image import linear_to_srgb_u8
    assert np.array_equal(ref_denoise.srgb_u8(img), linear_to_srgb_u8(img))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _encode(img, filters):
    """RGB8 PNG bytes whose row y uses filters[y % len(filters)], made
    a byte at a time (the PNG spec's definitions)."""
    h, w, _ = img.shape
    raw = img.reshape(h, w * 3).astype(int)
    body = bytearray()
    for y in range(h):
        f = filters[y % len(filters)]
        body.append(f)
        for i in range(w * 3):
            a = raw[y, i - 3] if i >= 3 else 0
            b = raw[y - 1, i] if y else 0
            c = raw[y - 1, i - 3] if y and i >= 3 else 0
            pred = [0, a, b, (a + b) >> 1, _paeth(a, b, c)][f]
            body.append((raw[y, i] - pred) & 0xFF)

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))
    return (png.SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(body)))
            + chunk(b"IEND", b""))


def test_png_reader_against_the_ports_encoder():
    img = np.random.default_rng(3).integers(0, 256, (23, 37, 3),
                                            dtype=np.uint8)
    assert np.array_equal(png.read_rgb8(port_png.encode_rgb(img)), img)


@pytest.mark.parametrize("filters", [[1], [2], [3], [4], [0, 1, 2, 3, 4],
                                     [4, 3, 2, 1]])
def test_png_reader_every_filter(filters):
    img = np.random.default_rng(len(filters)).integers(
        0, 256, (17, 29, 3), dtype=np.uint8)
    data = _encode(img, filters)
    assert np.array_equal(png.read_rgb8(data), img)
    assert np.array_equal(port_png.decode(data)[..., :3], img)


def test_png_reader_refuses_what_it_cannot_read():
    data = bytearray(port_png.encode_rgb(np.zeros((4, 5, 3), np.uint8)))
    for broken in (bytes(data[:-5]), b"\x00" + bytes(data[1:])):
        with pytest.raises(ValueError):
            png.read_rgb8(broken)
    data[-17] ^= 1        # inside the IDAT chunk: its CRC fails
    with pytest.raises(ValueError):
        png.read_rgb8(bytes(data))
    grey = bytearray(port_png.encode_rgb(np.zeros((4, 5, 3), np.uint8)))
    grey[25] = 0          # IHDR's colour type -> 0 (CRC fixed below)
    start = len(png.SIGNATURE)
    body = bytes(grey[start + 4:start + 8 + 13])
    grey[start + 21:start + 25] = struct.pack(">I", zlib.crc32(body))
    with pytest.raises(ValueError):
        png.read_rgb8(bytes(grey))


def _off_by_two(real):
    def save(path, u8):
        u8 = u8.copy()
        u8[..., 1] = np.where(u8[..., 1] < 128, u8[..., 1] + 2,
                              u8[..., 1] - 2)
        real(path, u8)
    return save


@pytest.mark.parametrize("fault", ["undenoised", "three_levels",
                                   "channel_off_by_two", "dropped",
                                   "state_unchanged", "half_batch",
                                   "answer_altered"])
def test_faults_are_caught(monkeypatch, fault):
    inner = {"state_unchanged": cpu_frame.StateUnchanged,
             "half_batch": cpu_frame.HalfBatch}.get(fault,
                                                    cpu_frame.EagerFrame)
    undo = lambda: None  # noqa: E731
    if fault == "undenoised":
        monkeypatch.setattr(shots.Shots, "denoise", lambda self, gb, hdr:
                            hdr.reshape(self.height, self.width, 3))
    elif fault == "three_levels":
        def denoise(self, gb, hdr):
            return port_screenshot.denoised_screenshot(
                gb, hdr, self.width, self.height,
                self.cfg["denoise_iterations"] - 1)
        monkeypatch.setattr(shots.Shots, "denoise", denoise)
    elif fault == "channel_off_by_two":
        monkeypatch.setattr(port_screenshot, "save_png",
                            _off_by_two(port_screenshot.save_png))
    elif fault == "dropped":
        monkeypatch.setattr(shots.Shots, "submit",
                            lambda self, img, label: False)
    elif fault == "answer_altered":
        undo = cpu_frame.altered_answers()
    try:
        r = _measure(inner=inner)
    finally:
        undo()
    if fault == "dropped":
        assert r["failed"] >= 1
    assert not r["correct"], r["checked"]


@pytest.mark.parametrize("control", ["bf16", "bf16_shading"])
def test_control_is_caught(control):
    r = _measure(control=control)
    assert not r["correct"]
    c = r["checked"]["shot_gap"]
    assert c["value"] > c["limit"], c


@pytest.mark.card
@pytest.mark.parametrize("control", ["bf16", "bf16_shading"])
def test_control_fails_at_the_cells_size(card, control):
    """The controls on the card at the cell's own size (3840x2160): the
    reference in bfloat16, or with its shading alone in bfloat16, its
    denoise in bfloat16 either way, in the program's place reads above
    a limit."""
    r = run.measure(cells.load(CELL), 7, 15.0, False, [card],
                    time.perf_counter(), control=control,
                    log=lambda *a: None)
    assert not r["correct"], r["checked"]
    c = r["checked"]["shot_gap"]
    assert c["value"] > c["limit"], c


MS = 1e-3


def _shot_trace(phase=1, frames=3):
    """`frames` frames on card 0, each its marks, a 1 ms op and the end
    after state_copy; the host's wait ends 0.2 ms after each frame; after
    frame `phase` the denoise's ops (2 + 3 ms) and the image's copy to
    the host, with a 0.01 ms copy of the frame's aux before the wait."""
    kernels, copies, host, t = [], [], [], 1.0
    for f in range(frames):
        for stage in ("gbuffer", "state_copy", "end"):
            kernels.append((f"tpurt_mark_{stage}(long*, int)", 0, t * MS,
                            (t + 0.001) * MS))
            if stage != "end":
                kernels.append(("work", 0, (t + 0.01) * MS, (t + 1) * MS))
            t += 1.0
        copies.append(("Memcpy DtoD (Device -> Device)", 0, (t + 0.05) * MS,
                       (t + 0.06) * MS))
        host.append(("cudaDeviceSynchronize", (t - 1.5) * MS,
                     (t + 0.2) * MS))
        t += 0.3
        if f == phase:
            kernels.append(("elementwise_kernel", 0, t * MS, (t + 2) * MS))
            kernels.append(("roll_kernel", 0, (t + 2.5) * MS,
                            (t + 5.5) * MS))
            copies.append(("Memcpy DtoH (Device -> Pageable)", 0,
                           (t + 6) * MS, (t + 9) * MS))
            t += 10.0
        t += 1.0
    return profile.Trace(kernels, copies, [], host, (0.0, t * MS), frames)


def test_denoise_readers_on_a_hand_built_trace():
    cell = cells.load(CELL)
    view = run.RunView(cell, {}, _shot_trace(), {}, "NVIDIA H100 80GB HBM3")
    ms = cells.metric_reader("denoise_ms_per_shot")(view)
    assert ms == pytest.approx(5.0)
    share = cells.metric_reader("denoise_roofline")(view)
    want = 3840 * 2160 * 56 / 3.35e12 / 5e-3 * 100
    assert share == pytest.approx(want)
    # no shot among the traced frames, no card in the table: nothing
    assert cells.metric_reader("denoise_ms_per_shot")(
        run.RunView(cell, {}, _shot_trace(phase=5), {}, "x")) is None
    assert cells.metric_reader("denoise_roofline")(
        run.RunView(cell, {}, _shot_trace(), {}, "x")) is None
