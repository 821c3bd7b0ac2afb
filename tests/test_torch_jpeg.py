"""The port's numpy JPEG decoder (`utils/jpeg.py`) against Pillow, and the
loader's choice of decoder (`scene/loader.py:decode_image`).

Tolerances: none. `jpeg.decode` equals Pillow 12.1.0's
`np.asarray(Image.open(...).convert("RGBA"))` (libjpeg-turbo 3.1.3)
byte for byte in every case: the inputs are encoded here by Pillow from
seeded numpy images, over sizes, chroma subsampling, quality, optimized
Huffman tables, restart intervals, grayscale, progressive streams and
CMYK.
"""

from io import BytesIO

import numpy as np
import pytest
from PIL import Image

from tpu_raytracer_torch.scene.loader import decode_image
from tpu_raytracer_torch.utils import jpeg, png

SIZES = [(1, 1), (7, 13), (32, 32), (100, 37), (256, 256)]   # (w, h)


def _image(w, h, channels=3, seed=0):
    """Noise over gradients: smooth areas and edges for every IDCT term
    and every upsampling branch."""
    g = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1),
                     (x * 7 + y * 3) % 256], axis=-1)
    img = np.clip(base + g.integers(-40, 41, base.shape), 0, 255)
    img = img.astype(np.uint8)
    return img[..., 0] if channels == 1 else img


def _encode(img, **kw) -> bytes:
    out = BytesIO()
    Image.fromarray(img).save(out, format="JPEG", **kw)
    return out.getvalue()


def _pillow(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(BytesIO(data)).convert("RGBA"))


def _assert_decodes_like_pillow(data: bytes):
    want = _pillow(data)
    got = jpeg.decode(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("quality", [50, 75, 95])
@pytest.mark.parametrize("subsampling", [0, 1, 2])
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_decode_equals_pillow(size, subsampling, quality):
    _assert_decodes_like_pillow(_encode(_image(*size), subsampling=subsampling,
                                        quality=quality))


@pytest.mark.parametrize("case", [
    dict(optimize=True, subsampling=0),
    dict(optimize=True, subsampling=1),
    dict(optimize=True, subsampling=2, quality=95),
    dict(restart_marker_blocks=1, subsampling=2),
    dict(restart_marker_blocks=5, subsampling=0),
    dict(restart_marker_rows=1, subsampling=1, optimize=True),
], ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items()))
@pytest.mark.parametrize("size", [(7, 13), (100, 37)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_decode_options_equal_pillow(size, case):
    _assert_decodes_like_pillow(_encode(_image(*size, seed=1), **case))


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("quality", [50, 95])
def test_decode_grayscale_equals_pillow(size, quality):
    data = _encode(_image(*size, channels=1, seed=2), quality=quality)
    assert Image.open(BytesIO(data)).mode == "L"
    _assert_decodes_like_pillow(data)


def _patched(marker: int, precision: int = 8) -> bytes:
    """A baseline stream whose SOF0 is relabelled `marker` with sample
    precision `precision`."""
    data = bytearray(_encode(_image(16, 16)))
    sof = data.index(b"\xff\xc0")
    data[sof + 1] = marker
    data[sof + 4] = precision
    return bytes(data)


PROGRESSIVE_SIZES = [(1, 1), (37, 23), (100, 37)]                # (w, h)


@pytest.mark.parametrize("restart", [0, 1, 3])
@pytest.mark.parametrize("quality", [50, 95])
@pytest.mark.parametrize("subsampling", [0, 1, 2])
@pytest.mark.parametrize("size", PROGRESSIVE_SIZES,
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_progressive_equals_pillow(size, subsampling, quality, restart):
    """SOF2 streams in Pillow's scan script: DC first and refine, AC
    first with end-of-band runs, AC refine with correction bits, at odd
    sizes, with and without restart markers."""
    kw = dict(progressive=True, subsampling=subsampling, quality=quality)
    if restart:
        kw["restart_marker_blocks"] = restart
    data = _encode(_image(*size, seed=4), **kw)
    assert data[data.index(b"\xff\xc2") + 1] == 0xC2
    _assert_decodes_like_pillow(data)


@pytest.mark.parametrize("restart", [0, 2])
@pytest.mark.parametrize("size", PROGRESSIVE_SIZES,
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_progressive_grayscale_equals_pillow(size, restart):
    kw = dict(progressive=True, quality=75)
    if restart:
        kw["restart_marker_blocks"] = restart
    data = _encode(_image(*size, channels=1, seed=6), **kw)
    assert Image.open(BytesIO(data)).mode == "L"
    _assert_decodes_like_pillow(data)


def _cmyk(w=8, h=8, **kw) -> bytes:
    out = BytesIO()
    Image.fromarray(_image(w, h, seed=3)).convert("CMYK").save(
        out, format="JPEG", **kw)
    return out.getvalue()


@pytest.mark.parametrize("case", [
    dict(), dict(quality=95, restart_marker_blocks=2),
    dict(progressive=True)], ids=["baseline", "restart", "progressive"])
@pytest.mark.parametrize("size", [(1, 1), (37, 23), (64, 64)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_cmyk_equals_pillow(size, case):
    """Four components under Adobe transform 0: Pillow reads them
    inverted (CMYK;I) and `convert("RGBA")` applies its integer CMYK to
    RGB formula; the decoder repeats both."""
    data = _cmyk(*size, **case)
    assert Image.open(BytesIO(data)).mode == "CMYK"
    _assert_decodes_like_pillow(data)


def test_cmyk_conversion_equals_pillow_on_every_ink():
    """The CMYK to RGB step alone against Pillow's Convert.c on random
    samples covering every value of each ink."""
    g = np.random.default_rng(8)
    raw = g.integers(0, 256, (256, 64, 4)).astype(np.uint8)
    raw[:, 0] = np.arange(256)[:, None]
    want = np.asarray(Image.frombytes("CMYK", (64, 256), (255 - raw)
                                      .tobytes()).convert("RGB"))
    got = np.stack(jpeg._cmyk_to_rgb(list(raw.astype(np.int64)
                                         .transpose(2, 0, 1))), axis=-1)
    assert np.array_equal(got, want)


def _ycck() -> bytes:
    """A CMYK stream whose Adobe marker says transform 2 (YCCK)."""
    data = bytearray(_cmyk())
    adobe = data.index(b"Adobe")
    data[adobe + 11] = 2
    return bytes(data)


def _truncated_progressive() -> bytes:
    """A progressive stream cut after its first scan: its AC terms never
    get their last bit, so libjpeg would smooth the blocks."""
    data = _encode(_image(32, 32), progressive=True)
    second = data.index(b"\xff\xda", data.index(b"\xff\xda") + 2)
    return data[:second] + b"\xff\xd9"


@pytest.mark.parametrize("data,words", [
    (lambda: _patched(0xCB), "arithmetic"),
    (lambda: _patched(0xC3), "lossless"),
    (lambda: _patched(0xC1, precision=12), "12-bit"),
], ids=["arithmetic", "lossless", "12-bit"])
def test_unsupported_modes_raise_naming_them(data, words):
    """Streams Pillow refuses too: arithmetic-coded lossless (SOF11), a
    lossless frame over 2x2-sampled DCT data, 12-bit samples
    (tests/test_torch_jpeg_modes.py holds the rest to Pillow)."""
    with pytest.raises(OSError):
        _pillow(data())
    with pytest.raises(ValueError, match=words):
        jpeg.decode(data())


@pytest.mark.parametrize("data", [_ycck, _truncated_progressive],
                         ids=["ycck", "incomplete-progressive"])
def test_former_gaps_equal_pillow(data):
    """Pillow's own streams of two modes the decoder once refused: a
    CMYK stream relabelled YCCK, a progressive stream cut after its first
    scan (libjpeg smooths its blocks)."""
    _assert_decodes_like_pillow(data())


def test_decode_image_chooses_by_magic_bytes():
    img = _image(9, 5)
    from_png = decode_image(png.encode_rgb(img))
    assert np.array_equal(from_png[..., :3], img)
    data = _encode(img)
    assert np.array_equal(decode_image(data), _pillow(data))
    with pytest.raises(ValueError, match="neither PNG nor JPEG"):
        decode_image(b"GIF89a" + b"\0" * 16)
    with pytest.raises(ValueError, match="not a JPEG stream"):
        jpeg.decode(b"\x89PNG")
