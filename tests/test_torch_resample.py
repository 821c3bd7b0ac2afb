"""The port's numpy resampler (`utils/resample.py`) against Pillow, and the
builder's texture preparation against the reference's.

Tolerances: none. `resize_u8` equals `Image.resize` byte for byte, and
`_prep_texture` equals the reference's bit for bit, in every case.
"""

import numpy as np
import pytest
import torch
from PIL import Image

from tpu_raytracer.scene import builder as ref_builder
from tpu_raytracer_torch.scene import builder
from tpu_raytracer_torch.utils.resample import resize_u8

torch.set_num_threads(1)

PIL_FILTERS = {"lanczos": Image.LANCZOS, "bicubic": Image.BICUBIC}


def _image(h, w, channels=3, seed=0):
    shape = (h, w) if channels == 1 else (h, w, channels)
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


@pytest.mark.parametrize("src,dst,filt", [
    ((32, 32), (1024, 1024), "lanczos"),
    ((256, 256), (1024, 1024), "lanczos"),
    ((512, 512), (1024, 1024), "lanczos"),
    ((300, 170), (1024, 1024), "lanczos"),    # non-square
    ((1500, 1100), (1024, 1024), "lanczos"),  # downscale, both axes
    ((32, 1024), (1024, 1024), "lanczos"),    # one axis only
    # the letterbox cases: 200x100 into 300^2, 64^2 into 128^2 and
    # 1280x720 into 1920x1080
    ((100, 200), (150, 300), "bicubic"),
    ((64, 64), (128, 128), "bicubic"),
    ((720, 1280), (1080, 1920), "bicubic"),
    ((37, 91), (13, 200), "bicubic"),         # shrink one axis, grow one
], ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else v)
def test_resize_equals_pil(src, dst, filt):
    img = _image(*src)
    want = np.asarray(Image.fromarray(img).resize(dst[::-1],
                                                  PIL_FILTERS[filt]))
    got = resize_u8(img, dst[1], dst[0], filt)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("filt", ["lanczos", "bicubic"])
def test_resize_one_channel_equals_pil(filt):
    img = _image(40, 24, channels=1, seed=3)
    want = np.asarray(Image.fromarray(img).resize((61, 17),
                                                  PIL_FILTERS[filt]))
    assert np.array_equal(resize_u8(img, 61, 17, filt), want)


def test_resize_same_size_is_a_copy():
    img = _image(8, 6)
    got = resize_u8(img, 6, 8, "lanczos")
    assert np.array_equal(got, img) and not np.shares_memory(got, img)


def test_resize_refuses_what_it_does_not_take():
    with pytest.raises(ValueError, match="uint8"):
        resize_u8(np.zeros((4, 4, 3), np.float32), 8, 8)
    with pytest.raises(ValueError, match="filter"):
        resize_u8(_image(4, 4), 8, 8, "nearest")


@pytest.mark.parametrize("srgb", [True, False], ids=["srgb", "linear"])
@pytest.mark.parametrize("size", [32, 256, 512, 1024])
def test_prep_texture_equals_reference(size, srgb):
    """Random RGBA images; 1024^2 takes no resize."""
    img = _image(size, size, channels=4, seed=size)
    got = builder._prep_texture(img, srgb=srgb)
    want = ref_builder._prep_texture(img, srgb=srgb)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == (builder.TEXTURE_SIZE, builder.TEXTURE_SIZE, 3)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("img", [
    np.random.default_rng(5).uniform(-0.2, 1.2, (48, 80, 3)).astype(
        np.float32),
    _image(70, 50, channels=1, seed=6)], ids=["float", "grey"])
def test_prep_texture_other_inputs_equal_reference(img):
    """Float pixels outside [0, 1] are clipped before the resize; a grey
    image is repeated into three channels."""
    assert np.array_equal(builder._prep_texture(img, srgb=True),
                          ref_builder._prep_texture(img, srgb=True))
