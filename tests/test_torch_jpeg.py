"""The port's numpy JPEG decoder (`utils/jpeg.py`) against Pillow, and the
loader's choice of decoder (`scene/loader.py:decode_image`).

Tolerances: none. `jpeg.decode` equals Pillow 12.1.0's
`np.asarray(Image.open(...).convert("RGBA"))` (libjpeg-turbo 3.1.3)
byte for byte in every case: the inputs are encoded here by Pillow from
seeded numpy images, over sizes, chroma subsampling, quality, optimized
Huffman tables, restart intervals and grayscale.
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


def _cmyk() -> bytes:
    out = BytesIO()
    Image.fromarray(_image(8, 8, seed=3)).convert("CMYK").save(
        out, format="JPEG")
    return out.getvalue()


@pytest.mark.parametrize("data,words", [
    (lambda: _encode(_image(32, 32), progressive=True), "progressive"),
    (_cmyk, "CMYK"),
    (lambda: _patched(0xC9), "arithmetic"),
    (lambda: _patched(0xC3), "lossless"),
    (lambda: _patched(0xC1, precision=12), "12-bit"),
], ids=["progressive", "cmyk", "arithmetic", "lossless", "12-bit"])
def test_unsupported_modes_raise_naming_them(data, words):
    with pytest.raises(ValueError, match=words):
        jpeg.decode(data())


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
