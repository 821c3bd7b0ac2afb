"""K10, the post pass (`csrc/post.cu`), built with g++ under the host
emulation `csrc/host/emulation/cuda_runtime.h`, driven through one
`post.run_k10` call a case and held to `post_process_plain` on the CPU.

The libm is taken out of the comparison: K10 is built with
-DTPURT_EMU_ROUNDED_LIBM (expf and powf rounded from double) and the plain
version runs under torch.exp, torch.pow and torch.sqrt rounded from double
the same way. Every word of `ldr` and `accum` is then equal, which holds
K10's f32 arithmetic, operation order, constants, the rolls' wrap and the
history taps' addressing to the eager version's exactly. Where a case's
inputs hold a non-finite word, NaNs must fall on the same words; their
payloads are the host's and are not compared. On the card K10 meets
PyTorch's CUDA kernels, which call the same expf, powf and sqrtf as its
own; chip_smoke.py holds it to the eager route there.
"""

import contextlib
import zlib
from unittest import mock

import numpy as np
import pytest
import torch

from test_torch_kernel_emulation import _build
from tpu_raytracer_torch.ops import gbuffer, post, trace_api
from tpu_raytracer_torch.parallel.views import BandView, PairBandView

# (name, width, height, bands, band, halo, frame_count, motion)
CASES = (
    ("still_f0", 40, 24, 1, 0, 0, 0, "still"),
    ("still_f1", 40, 24, 1, 0, 0, 1, "still"),
    ("still_f37", 40, 24, 1, 0, 0, 37, "still"),
    ("moving_off_image", 40, 24, 1, 0, 0, 5, "moving"),
    ("band_top_halo2", 40, 48, 3, 0, 2, 3, "moving"),
    ("band_mid_halo2", 40, 48, 3, 1, 2, 3, "moving"),
    ("band_bottom_halo2", 40, 48, 3, 2, 2, 3, "moving"),
    ("band_top_halo16", 40, 48, 3, 0, 16, 3, "moving"),
    ("band_mid_halo16", 40, 48, 3, 1, 16, 3, "moving"),
    ("band_bottom_halo16", 40, 48, 3, 2, 16, 3, "moving"),
    ("masked_nonfinite", 40, 48, 3, 0, 2, 3, "moving"),
    ("odd_width", 37, 13, 1, 0, 0, 2, "moving"),
)

# The tests run in several worker processes at once: one torch thread each
# keeps them from oversubscribing the cores.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return _build(tmp_path_factory.mktemp("k10_rounded"), ("post",),
                  defines=("TPURT_EMU_ROUNDED_LIBM",))


@contextlib.contextmanager
def _rounded_libm():
    """torch.exp, pow and sqrt rounded from double, as the rounded build's
    expf, powf and (IEEE) sqrtf give them; pow's exponent is the f32 value
    PyTorch's kernels raise to."""
    exp, pow_, sqrt = torch.exp, torch.pow, torch.sqrt
    with mock.patch.object(torch, "exp",
                           lambda x: exp(x.double()).float()), \
            mock.patch.object(torch, "pow", lambda x, e: pow_(
                x.double(), float(np.float32(e))).float()), \
            mock.patch.object(torch, "sqrt",
                              lambda x: sqrt(x.double()).float()):
        yield


def _frame(g, width, height, motion_kind):
    """Full-image inputs: HDR rows, packed G-buffer rows, accumulation rows.
    The G-buffer has flat walls (equal albedo and normal, smooth position)
    with random patches, so the bilateral's weights span 0 to 1; moving
    motion sends some history taps out of the image and leaves some pixels
    under half a pixel of motion."""
    n = width * height
    yy, xx = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    wall = (xx * 3 // width + yy * 2 // height).reshape(-1)
    gb = np.zeros((n, gbuffer.GB_COLS), np.float32)
    gb[:, gbuffer.GB_POS] = np.stack(
        [xx.reshape(-1) * 0.02, yy.reshape(-1) * 0.02, wall * 0.3], -1)
    gb[:, gbuffer.GB_OCT] = np.array([[0.1, 0.2], [-0.4, 0.3], [0.7, -0.6],
                                      [0.0, 0.9], [-0.5, -0.5]])[wall % 5]
    gb[:, gbuffer.GB_ALBEDO] = np.array([[0.8, 0.7, 0.6], [0.2, 0.6, 0.3],
                                         [0.5, 0.5, 0.9], [0.9, 0.1, 0.1],
                                         [0.3, 0.3, 0.3]])[wall % 5]
    noisy = g.uniform(size=n) < 0.3
    gb[noisy, gbuffer.GB_POS] += g.normal(0, 0.05, (noisy.sum(), 3))
    gb[noisy, gbuffer.GB_OCT] = g.uniform(-1, 1, (noisy.sum(), 2))
    gb[noisy, gbuffer.GB_ALBEDO] = g.uniform(0, 1, (noisy.sum(), 3))
    if motion_kind == "moving":
        m = g.normal(0, 2.0, (n, 2)) / [width, height]
        far = g.uniform(size=n) < 0.15
        m[far] = g.uniform(-0.7, 0.7, (far.sum(), 2))
        still = g.uniform(size=n) < 0.15
        m[still] = g.uniform(-0.2, 0.2, (still.sum(), 2)) / [width, height]
        gb[:, gbuffer.GB_MOTION] = m
    hdr = g.gamma(0.6, 0.8, (n, 3)).astype(np.float32)
    accum = g.gamma(0.6, 0.8, (n, 3)).astype(np.float32)
    return (torch.from_numpy(hdr), torch.from_numpy(gb),
            torch.from_numpy(accum))


def _view(full, width, height, y0, band_h, halo, fill):
    """The BandView halo_exchange gives band [y0, y0 + band_h) of `full`,
    with `fill` in the halo rows outside the image."""
    rows = full.reshape(height, width, -1)
    ext = torch.full((band_h + 2 * halo, width, rows.shape[2]), fill)
    lo, hi = max(y0 - halo, 0), min(y0 + band_h + halo, height)
    ext[lo - (y0 - halo):hi - (y0 - halo)] = rows[lo:hi]
    return BandView(data=ext.reshape(-1, rows.shape[2]), y0=y0, width=width,
                    height=height, band_h=band_h, halo=halo)


def _case(name, width, height, bands, band, halo, frame_count, motion):
    """(views, gb, frame_count, ctx) of a case, on the CPU."""
    g = np.random.default_rng(zlib.crc32(name.encode()))
    hdr, gb_rows, accum = _frame(g, width, height, motion)
    band_h = height // bands
    y0 = band * band_h
    hdr_view = _view(hdr, width, height, y0, band_h, halo, 0.0)
    gb_view = _view(gb_rows, width, height, y0, band_h, halo, 0.0)
    hist_view = _view(accum, width, height, y0, band_h, halo, 0.0)
    if name == "masked_nonfinite":
        # the top band's halo, above the image: inf HDR in both rows, NaN
        # G-buffer words in the first; and an inf HDR word at the end of
        # band row 8, which columns 0 and 1 read through the roll's wrap
        hdr_view.data[:2 * width] = float("inf")
        gb_view.data[:width] = float("nan")
        hdr_view.data[(halo + 9) * width - 1] = float("inf")
    # the band's own rows of the packed G-buffer: motion at its stride, as
    # render_band's gb holds the words it packs (K10 reads them there)
    own = gb_view.data[halo * width:(halo + band_h) * width]
    gb = {"motion": own[:, gbuffer.GB_MOTION]}
    ctx = {"width": width, "height": height, "device": torch.device("cpu"),
           "y0": y0, "band_h": band_h}
    if bands > 1:   # as a captured frame holds it
        frame_count = torch.tensor(frame_count, dtype=torch.int64)
    return (hdr_view, gb, gb_view, hist_view), frame_count, ctx


def _same_words(got, want, what):
    a, b = got.view(torch.int32), want.view(torch.int32)
    nan_a, nan_b = torch.isnan(got), torch.isnan(want)
    assert torch.equal(nan_a, nan_b), (what, (nan_a != nan_b).sum())
    diff = (a != b) & ~nan_a
    assert not diff.any(), (what, int(diff.sum()),
                            float((got - want)[diff].abs().max()))


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_k10_against_plain(lib, case):
    views, frame_count, ctx = _case(*case)
    with _rounded_libm():
        want = post.post_process_plain(*views, frame_count, ctx)
        names = []
        got = post.run_k10(lib, None, names.append, *views, frame_count, ctx)
    assert names == ["post"]
    for g_, w_, what in zip(got, want, ("ldr", "accum")):
        assert g_.shape == w_.shape == (ctx["band_h"] * ctx["width"], 3)
        _same_words(g_, w_, what)

    # the case holds what it is there for
    ldr = want[0]
    if case[0] == "masked_nonfinite":
        # row 1's masked taps multiply the inf HDR words by 0: NaN; row 0's
        # also meet the NaN G-buffer words, so its weight sum is NaN and
        # it keeps its own HDR: finite. The inf word at (8, W - 1) reaches
        # rows 6-10 in its own columns and, wrapped, in columns 0 and 1
        w = ctx["width"]
        want_nan = torch.zeros(ctx["band_h"], w, dtype=torch.bool)
        want_nan[1] = True
        want_nan[6:11, [0, 1, w - 3, w - 2, w - 1]] = True
        nan = torch.isnan(ldr).reshape(ctx["band_h"], w, 3)
        assert torch.equal(nan.all(-1), want_nan)
        assert torch.equal(nan.any(-1), want_nan)
    else:
        assert torch.isfinite(ldr).all()
    if case[-1] == "moving":
        m = views[1]["motion"]
        uv = (m * torch.tensor([ctx["width"], ctx["height"]])).abs()
        assert (uv.amax(-1) > ctx["width"] / 4).any()    # off the image
        assert (uv.norm(dim=-1) < 0.5).any()             # static pixels
        assert (uv.norm(dim=-1) > 0.5).float().mean() > 0.5


def _cpu_views():
    views, frame_count, ctx = _case(*CASES[4])
    return list(views), frame_count, ctx


def test_k10_dispatch_cpu_plain(monkeypatch):
    """CPU tensors take the plain route, and launch nothing."""
    views, frame_count, ctx = _cpu_views()

    def refuse(*a, **k):
        raise AssertionError("post_process_kernel on CPU tensors")

    trace_api.reset_launch_counts()
    want = post.post_process_plain(*views, frame_count, ctx)
    monkeypatch.setattr(post, "post_process_kernel", refuse)
    got = post.post_process(*views, frame_count, ctx)
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert trace_api.LAUNCHES["post"] == 0


class _NoLib:
    """A library whose K10 must not be reached."""

    def tpurt_post(self, *a):
        raise AssertionError("K10 launched on inputs it does not take")


def _misuse(kind):
    views, frame_count, ctx = _cpu_views()
    hdr, gb, gbv, hist = views
    if kind == "dtype":
        hdr = BandView(hdr.data.double(), hdr.y0, hdr.width, hdr.height,
                       hdr.band_h, hdr.halo)
    elif kind == "stride":   # columns not adjacent
        data = hdr.data.t().contiguous().t()
        hdr = BandView(data, hdr.y0, hdr.width, hdr.height, hdr.band_h,
                       hdr.halo)
    elif kind == "device":
        hist = BandView(hist.data.to("meta"), hist.y0, hist.width,
                        hist.height, hist.band_h, hist.halo)
    elif kind == "shape":
        gbv = BandView(gbv.data[:, :12], gbv.y0, gbv.width, gbv.height,
                       gbv.band_h, gbv.halo)
    elif kind == "halo":
        gbv = BandView(gbv.data[2 * gbv.width:-2 * gbv.width], gbv.y0,
                       gbv.width, gbv.height, gbv.band_h, 0)
    elif kind == "pair_view":
        gbv = PairBandView(gbv.data[:, :7], gbv.data[:, 7:], gbv.y0,
                           gbv.width, gbv.height, gbv.band_h, gbv.halo)
    elif kind == "frame_dtype":
        frame_count = frame_count.to(torch.int32)
    elif kind == "band_h":   # the views are not the context's band
        ctx = dict(ctx, band_h=ctx["band_h"] - 1)
    return (hdr, gb, gbv, hist), frame_count, ctx


@pytest.mark.parametrize("kind", ("dtype", "stride", "device", "shape",
                                  "halo", "pair_view", "frame_dtype",
                                  "band_h"))
def test_k10_refuses_misuse(kind):
    """Inputs K10 does not take raise before any launch: the CUDA route
    never falls back to the eager version."""
    views, frame_count, ctx = _misuse(kind)
    with pytest.raises(ValueError):
        post.run_k10(_NoLib(), None, None, *views, frame_count, ctx)


def test_k10_wants_cuda():
    views, frame_count, ctx = _cpu_views()
    with pytest.raises(ValueError, match="CUDA"):
        post.post_process_kernel(*views, frame_count, ctx)
