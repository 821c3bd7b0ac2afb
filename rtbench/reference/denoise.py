"""The screenshot's denoise and its display encoding (the reference app's
OIDN screenshot, src/screenshot.rs:69-118; BASELINE.md config 5): a
frozen plain float32 copy of the port's whole-frame a-trous filter
(`tpu_raytracer_torch/ops/denoise.py`), of the G-buffer unpack of
`app/screenshot.py:denoised_screenshot` and of the sRGB encode of
`utils/image.py:linear_to_srgb_u8`.

  - N levels of the 5x5 B3-spline a-trous kernel with power-of-two
    dilation (Dammertz et al. 2010);
  - edge-stopping weights on albedo, normal and world position;
  - it filters demodulated irradiance (color / albedo) and remodulates.

Every stencil runs on per-channel [H, W] planes; a tap is a roll of the
plane, and the `ok` mask gives taps that wrapped around the image
weight 0.
"""

from __future__ import annotations

import numpy as np
import torch

from . import vec3
from .gbuffer import unpack_gb
from .vec3 import V3

_B3 = [1 / 16, 1 / 4, 3 / 8, 1 / 4, 1 / 16]

SIGMA_ALBEDO = 0.15
SIGMA_NORMAL = 12.0
SIGMA_POS = 0.8


def _to_planes(img):
    """[H, W, C] -> list of C contiguous [H, W] planes."""
    return list(img.permute(2, 0, 1).contiguous().unbind(0))


def _shift3(v: V3, dy: int, dx: int) -> V3:
    """Each plane rolled so that pixel (y, x) reads (y + dy, x + dx)."""
    return V3(*(torch.roll(p, (-dy, -dx), (0, 1)) for p in v))


def _filter_level(irr: V3, ap: V3, normal: V3, pp: V3, step: int) -> V3:
    """One a-trous level of dilation `step` over whole [H, W] planes."""
    h, w = irr.x.shape
    device = irr.x.device
    ys = torch.arange(h, dtype=torch.int32, device=device)[:, None]
    xs = torch.arange(w, dtype=torch.int32, device=device)[None, :]

    zeros = torch.zeros_like(irr.x)
    sum_c = V3(zeros, zeros, zeros)
    sum_w = zeros
    for ky in range(5):
        for kx in range(5):
            dy = (ky - 2) * step
            dx = (kx - 2) * step
            c = _shift3(irr, dy, dx)
            a = _shift3(ap, dy, dx)
            n = _shift3(normal, dy, dx)
            p = _shift3(pp, dy, dx)
            ok = ((ys + dy >= 0) & (ys + dy < h)
                  & (xs + dx >= 0) & (xs + dx < w))

            w_k = _B3[ky] * _B3[kx]
            da = a - ap
            w_a = torch.exp(-vec3.dot(da, da) / (2 * SIGMA_ALBEDO ** 2))
            w_n = torch.clamp(vec3.dot(n, normal), min=0.0) ** SIGMA_NORMAL
            dp = p - pp
            w_p = torch.exp(-vec3.dot(dp, dp) / (2 * SIGMA_POS ** 2))

            wgt = w_k * w_a * w_n * w_p * ok
            sum_c = sum_c + c * wgt
            sum_w = sum_w + wgt
    return vec3.where(sum_w > 1e-6, sum_c / torch.clamp(sum_w, min=1e-6),
                      irr)


def atrous_denoise(hdr, albedo, oct_normal, pos, iterations: int = 4):
    """hdr, albedo, pos: [H, W, 3]; oct_normal: [H, W, 2]; iterations:
    a-trous levels (dilation 1, 2, 4, ...). Returns [H, W, 3] denoised
    linear radiance."""
    hp = V3(*_to_planes(hdr))
    ap = V3(*_to_planes(albedo))
    normal = vec3.oct_decode(*_to_planes(oct_normal))
    pp = V3(*_to_planes(pos))
    alb_safe = V3(*(torch.clamp(c, min=1e-3) for c in ap))
    irr = hp / alb_safe
    for level in range(iterations):
        irr = _filter_level(irr, ap, normal, pp, 1 << level)
    return vec3.arr(irr * alb_safe)


def denoised_screenshot(gb_rows, hdr_flat, width: int, height: int,
                        iterations: int = 4):
    """The packed G-buffer rows [H*W, 14] and the frame's HDR [H*W, 3] ->
    [H, W, 3] denoised linear HDR."""
    gb = unpack_gb(gb_rows)
    hdr = hdr_flat.reshape(height, width, 3)
    albedo = gb["albedo"].reshape(height, width, 3)
    octn = gb["oct_normal"].reshape(height, width, 2)
    pos = gb["pos"].reshape(height, width, 3)
    return atrous_denoise(hdr, albedo, octn, pos, iterations)


def srgb_u8(img) -> np.ndarray:
    """Linear [H, W, 3] -> the screenshot's bytes: gamma 2.2, clamped to
    u8 (post.wgsl:279)."""
    img = np.clip(np.asarray(img, np.float32), 0.0, 1.0)
    return (np.power(img, 1.0 / 2.2) * 255.0 + 0.5).astype(np.uint8)
