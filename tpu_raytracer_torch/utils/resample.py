"""Image resizing with numpy, equal byte for byte to Pillow's.

The port's stand-in for the two PIL calls of the reference: the Lanczos
resize of a texture to the texture array's size
(`tpu_raytracer/scene/builder.py:_prep_texture`) and the bicubic resize of
the letterboxed blit (`tpu_raytracer/app/interactive.py:letterbox`, where
`Image.resize` with no filter means BICUBIC for RGB).

It follows Pillow's separable resampler (libImaging/Resample.c) on 8-bit
channels: per output column the filter taps are computed in f64 around
`center = (x + 0.5) * in / out`, with the support widened by
`max(in / out, 1)` when shrinking, normalised by their sum, and rounded
away from zero to 22-bit fixed point. A horizontal pass, then a vertical
pass, each add `1 << 21` to the integer sum, shift right by 22 and clip to
uint8; the horizontal pass's uint8 result feeds the vertical one. A size
that does not change skips its pass.
"""

from __future__ import annotations

import numpy as np

PRECISION_BITS = 32 - 8 - 2


def _bicubic(x):
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def _sinc(x):
    with np.errstate(invalid="ignore", divide="ignore"):
        px = x * np.pi
        return np.where(x == 0.0, 1.0, np.sin(px) / px)


def _lanczos(x):
    return np.where((-3.0 <= x) & (x < 3.0), _sinc(x) * _sinc(x / 3), 0.0)


FILTERS = {"bicubic": (_bicubic, 2.0), "lanczos": (_lanczos, 3.0)}


def _coeffs(in_size: int, out_size: int, filt: str):
    """(first input index [out], integer weights [out, ksize]) of one
    axis, as Pillow's precompute_coeffs and normalize_coeffs_8bpc give
    them; weights past an output's last input are 0."""
    fn, support = FILTERS[filt]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = support * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    # C's (int) cast truncates toward zero
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5),
                      in_size).astype(np.int64) - xmin
    taps = np.arange(ksize)
    live = taps[None, :] < xmax[:, None]
    w = np.where(live, fn((taps[None, :] + xmin[:, None] - center[:, None]
                           + 0.5) * (1.0 / filterscale)), 0.0)
    ww = np.zeros(out_size)
    for k in range(ksize):        # C's sum order, left to right
        ww = ww + w[:, k]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None],
                 w)
    one = float(1 << PRECISION_BITS)
    kk = np.where(w < 0, np.trunc(-0.5 + w * one),
                  np.trunc(0.5 + w * one)).astype(np.int32)
    return xmin, kk


def _pass(img: np.ndarray, out_size: int, filt: str, axis: int):
    """One separable pass along `axis` (0 rows, 1 columns) of uint8
    [H, W, C]."""
    in_size = img.shape[axis]
    xmin, kk = _coeffs(in_size, out_size, filt)
    # int32 as Pillow sums: normalised taps keep |sum| under 2**31
    src = np.moveaxis(img, axis, 0).astype(np.int32)
    acc = np.full((out_size,) + src.shape[1:], 1 << (PRECISION_BITS - 1),
                  np.int32)
    wshape = (out_size,) + (1,) * (src.ndim - 1)
    for k in range(kk.shape[1]):  # one gather per tap, over every output
        idx = np.minimum(xmin + k, in_size - 1)
        acc += src[idx] * kk[:, k].reshape(wshape)
    out = np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_u8(img: np.ndarray, width: int, height: int,
              filt: str = "bicubic") -> np.ndarray:
    """uint8 [H, W, C] (or [H, W]) -> uint8 [height, width, C], as
    `Image.fromarray(img).resize((width, height), filter)` gives it for
    an image of one channel ("L") or three ("RGB"); filt is "bicubic" or
    "lanczos". Pillow resizes RGBA premultiplied by alpha: this does not."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"resize_u8 takes uint8, got {img.dtype}")
    if filt not in FILTERS:
        raise ValueError(f"filter {filt!r}: one of {sorted(FILTERS)}")
    if width < 1 or height < 1:
        raise ValueError(f"size {width}x{height}")
    out = img
    if width != img.shape[1]:
        out = _pass(out, width, filt, axis=1)
    if height != img.shape[0]:
        out = _pass(out, height, filt, axis=0)
    return np.array(out, copy=True) if out is img else out
