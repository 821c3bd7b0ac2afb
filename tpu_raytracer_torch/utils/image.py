"""Image helpers: gamma encode to u8, PNG save, PSNR
(`tpu_raytracer/utils/image.py`). PNGs are written by the port's own
encoder (`utils/png.py`), since the card's machine has no PIL."""

from __future__ import annotations

import os

import numpy as np

from . import png


def linear_to_srgb_u8(img) -> np.ndarray:
    """Gamma-2.2 encode like post.wgsl:279 and clamp to u8."""
    img = np.clip(np.asarray(img, np.float32), 0.0, 1.0)
    return (np.power(img, 1.0 / 2.2) * 255.0 + 0.5).astype(np.uint8)


def save_png(path: str, img_u8: np.ndarray) -> None:
    """Write an RGB u8 [H, W, 3] image to `path` as PNG."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(png.encode_rgb(img_u8))


def psnr(a, b, peak: float = 1.0) -> float:
    """PSNR in dB; inf when the images are equal."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = np.mean((a - b) ** 2)
    if mse <= 0:
        return float("inf")
    return float(10.0 * np.log10(peak * peak / mse))
