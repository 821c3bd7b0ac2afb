"""The reference's Lanczos resize: Pillow's `Image.resize(size,
Image.LANCZOS)` on 8-bit images, written out plainly, for the scene
textures a description hands over at another size than 1024^2 (the
program resizes them in set-up, as the published app does through PIL).

Pillow's resampler (libImaging/Resample.c) is separable: the columns are
resized first, the result rounded to uint8, then the rows. Along one
axis of `n_in` pixels resized to `n_out`, output pixel j is centred at
`(j + 0.5) * n_in / n_out` and reads the inputs within 3 (Lanczos's
support) times `max(n_in / n_out, 1)` of it, each weighted by the Lanczos
window at its distance from the centre, scaled back by that factor. The
weights are normalised to sum to 1 and rounded half away from zero to
fixed point with 22 fractional bits; a pixel is the integer sum of
weights times inputs, plus half a unit, shifted right 22 bits and
clipped to [0, 255].

Here each axis is one dense matrix of those integer weights, applied as
a float64 product: every product and partial sum is an integer below
2^53, so the product is exact in any order of summation.
"""

from __future__ import annotations

import math

import numpy as np

FRACTION_BITS = 22
SUPPORT = 3.0


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _lanczos(x: float) -> float:
    if -SUPPORT <= x < SUPPORT:
        return _sinc(x) * _sinc(x / 3)
    return 0.0


def _weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] fixed-point weights of one axis (integers, float64)."""
    scale = n_in / n_out
    stretch = max(scale, 1.0)
    support = SUPPORT * stretch
    inv = 1.0 / stretch
    one = float(1 << FRACTION_BITS)
    out = np.zeros((n_out, n_in), np.float64)
    for j in range(n_out):
        centre = (j + 0.5) * scale
        # C's int casts truncate toward zero, as Python's int() does
        first = max(int(centre - support + 0.5), 0)
        stop = min(int(centre + support + 0.5), n_in)
        taps = [_lanczos((i - centre + 0.5) * inv)
                for i in range(first, stop)]
        total = 0.0
        for w in taps:
            total += w
        for k, w in enumerate(taps):
            if total != 0.0:
                w = w / total
            out[j, first + k] = float(int(w * one - 0.5) if w < 0
                                      else int(w * one + 0.5))
    return out


def _axis(img: np.ndarray, n_out: int, axis: int) -> np.ndarray:
    """uint8 `img` resized along `axis` (0 rows, 1 columns)."""
    w = _weights(img.shape[axis], n_out)
    src = np.moveaxis(img, axis, 0).astype(np.float64)
    flat = w @ src.reshape(src.shape[0], -1)
    acc = flat.astype(np.int64) + (1 << (FRACTION_BITS - 1))
    px = np.clip(acc >> FRACTION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(px.reshape((n_out,) + src.shape[1:]), 0, axis)


def resize_lanczos(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """uint8 [H, W] or [H, W, C] -> uint8 [height, width(, C)]; an axis
    whose size does not change is left as it is."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"resize_lanczos takes uint8, got {img.dtype}")
    out = img
    if width != img.shape[1]:
        out = _axis(out, width, 1)
    if height != img.shape[0]:
        out = _axis(out, height, 0)
    return img.copy() if out is img else out
