"""Post pass: joint bilateral filter, variance-clipped TAA / progressive
accumulation, reversible tonemap, gamma encode (post.wgsl:61-282;
`tpu_raytracer/ops/post.py`).

  - 5x5 joint bilateral over the HDR input, weighted by a spatial
    Gaussian (sigma 1.5), albedo similarity (0.2), normal^20 and position
    (0.1) (post.wgsl:85-141);
  - 3x3 variance bounds in YCoCg of reversibly tonemapped color, gamma
    1.2 (:143-177);
  - history reprojection through the motion vectors with bilinear taps of
    the accumulation buffer (:180-228);
  - static pixels (< 0.5 px motion) average progressively with unclamped
    history; moving pixels use clipped history with speed-dependent
    feedback 0.98 -> 0.85 (:246-266);
  - inverse tonemap into the accumulation buffer, gamma 2.2 for display.

The pass works on per-channel [H, W] planes of the image; stencil taps
are rolls of the planes, masked by the image bounds. Camera jitter is disabled upstream as in the
reference (camera.rs:202-203), so there is no unjitter resample.
"""

from __future__ import annotations

import math

import torch

from . import vec3, views
from .vec3 import V3, ipow
from .gbuffer import GB_ALBEDO, GB_OCT, GB_POS

SIGMA_SPATIAL = 1.5
SIGMA_COLOR = 0.2
SIGMA_POS = 0.1
KERNEL_RADIUS = 2
VARIANCE_GAMMA = 1.2


def _gauss(x2, sigma):
    return torch.exp(-x2 / (2.0 * sigma * sigma))


def _ycocg(c: V3) -> V3:
    return V3(0.25 * c.x + 0.5 * c.y + 0.25 * c.z,
              0.5 * c.x - 0.5 * c.z,
              -0.25 * c.x + 0.5 * c.y - 0.25 * c.z)


def _rgb(c: V3) -> V3:
    return V3(c.x + c.y - c.z, c.x + c.z, c.x - c.y - c.z)


def _tonemap(c: V3) -> V3:
    """Reversible Reinhard-max (post.wgsl:51-53)."""
    return c / (1.0 + vec3.vmax(c))


def _inv_tonemap(c: V3) -> V3:
    return c / torch.clamp(1.0 - vec3.vmax(c), min=1e-4)


def resolve_tonemap(c):
    """Reversible Reinhard-max of [..., 3] colors (post.wgsl:51-53;
    the reference's `ops/post.py:resolve_tonemap`)."""
    return c / (1.0 + c.amax(dim=-1, keepdim=True))


class _PlaneStencil:
    """Shifted-window reads of per-channel planes at static (dy, dx)
    offsets: a tap rolls the planes, and the image bounds mask the roll's
    wrap."""

    def __init__(self, flat, ctx, channels):
        self.height, self.width = ctx["height"], ctx["width"]
        img = flat.reshape(self.height, self.width, *flat.shape[1:])
        self.planes = [img[:, :, k] for k in channels]
        device = flat.device
        self.ys = torch.arange(self.height, device=device)[:, None]
        self.xs = torch.arange(self.width, device=device)[None, :]

    def tap(self, dy: int, dx: int):
        out = [torch.roll(p, (-dy, -dx), dims=(0, 1)) for p in self.planes]
        gy = self.ys + dy
        gx = self.xs + dx
        valid = (gy >= 0) & (gy < self.height) & (gx >= 0) & (gx < self.width)
        return out, valid


def frame_f32(frame_count, device):
    """The accumulation counter as a 0-dim f32 tensor on `device`, from a
    Python int or a 0-dim int64 tensor (a captured frame's static input,
    `render/graph.py`); both give the same bits and neither reads the
    device back."""
    if isinstance(frame_count, torch.Tensor):
        return frame_count.to(device=device, dtype=torch.float32)
    return torch.full((), float(frame_count), dtype=torch.float32,
                      device=device)


def accumulation_blend(frame):
    """1 - 1/(N + 1) of a 0-dim f32 counter, rounded in f32 at each step
    as the reference's f32 scalar arithmetic rounds it
    (post.wgsl:256-259)."""
    return 1.0 - 1.0 / (frame + 1.0)


def post_process(hdr_flat, gb, gb_packed, history, frame_count, ctx):
    """Full post pass over the image.

    hdr_flat: the spatial pass's HDR output [n, 3]; gb: the flat
    G-buffer (motion); gb_packed: the packed G-buffer [n, GB_COLS];
    history: the accumulation buffer [n, 3]; frame_count: the SPP
    counter, a Python int or a 0-dim int64 tensor on the device; ctx:
    the frame context (restir.make_ctx).

    Returns (ldr [n, 3] gamma-encoded, new_accum [n, 3] linear HDR)."""
    width, height = ctx["width"], ctx["height"]
    frame = frame_f32(frame_count, ctx["device"])

    gb_ch = (list(range(GB_ALBEDO.start, GB_ALBEDO.stop))
             + list(range(GB_OCT.start, GB_OCT.stop))
             + list(range(GB_POS.start, GB_POS.stop)))
    s_hdr = _PlaneStencil(hdr_flat, ctx, [0, 1, 2])
    s_gb = _PlaneStencil(gb_packed, ctx, gb_ch)

    def gb_split(planes):
        return (V3(planes[0], planes[1], planes[2]),
                vec3.oct_decode(planes[3], planes[4]),
                V3(planes[5], planes[6], planes[7]))

    hdr = V3(*s_hdr.tap(0, 0)[0])
    albedo, normal, pos = gb_split(s_gb.tap(0, 0)[0])

    # 5x5 joint bilateral (post.wgsl:85-141)
    zeros = torch.zeros_like(hdr.x)
    sum_color = V3(zeros, zeros, zeros)
    sum_weight = zeros
    for dy in range(-KERNEL_RADIUS, KERNEL_RADIUS + 1):
        for dx in range(-KERNEL_RADIUS, KERNEL_RADIUS + 1):
            ct, ok = s_hdr.tap(dy, dx)
            a, nrm, p = gb_split(s_gb.tap(dy, dx)[0])
            w_spatial = math.exp(-(dx * dx + dy * dy)
                                 / (2.0 * SIGMA_SPATIAL ** 2))
            dc = a - albedo
            w_color = _gauss(vec3.dot(dc, dc), SIGMA_COLOR)
            w_normal = ipow(torch.clamp(vec3.dot(nrm, normal), 0.0, 1.0), 20)
            dp = p - pos
            w_pos = _gauss(vec3.dot(dp, dp), SIGMA_POS)
            w = w_spatial * w_color * w_normal * w_pos * ok
            sum_color = sum_color + V3(*ct) * w
            sum_weight = sum_weight + w
    filtered = vec3.where(sum_weight > 1e-3,
                          sum_color / torch.clamp(sum_weight, min=1e-3), hdr)

    # 3x3 YCoCg variance bounds (post.wgsl:143-177)
    m1 = V3(zeros, zeros, zeros)
    m2 = V3(zeros, zeros, zeros)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            ct, ok = s_hdr.tap(dy, dx)
            s = _ycocg(_tonemap(vec3.where(ok, V3(*ct), filtered)))
            m1 = m1 + s
            m2 = m2 + s * s
    m1 = m1 * (1.0 / 9.0)
    m2 = m2 * (1.0 / 9.0)
    sigma = V3(*(torch.sqrt(torch.clamp(b - a * a, min=0.0))
                 for a, b in zip(m1, m2)))
    c_min = m1 - sigma * VARIANCE_GAMMA
    c_max = m1 + sigma * VARIANCE_GAMMA
    tm_filtered = _tonemap(filtered)

    # history reprojection (post.wgsl:180-228)
    motion = gb["motion"].reshape(height, width, 2)
    motion_x = motion[..., 0]
    motion_y = motion[..., 1]
    device = motion.device
    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=device),
        torch.arange(width, dtype=torch.float32, device=device),
        indexing="ij")
    uv_x = (xs + 0.5) / width + motion_x
    uv_y = (ys + 0.5) / height + motion_y
    hist_valid = (uv_x >= 0.0) & (uv_x <= 1.0) & (uv_y >= 0.0) & (uv_y <= 1.0)

    px = uv_x * width - 0.5
    py = uv_y * height - 0.5
    x0 = torch.floor(px).to(torch.int32)
    y0 = torch.floor(py).to(torch.int32)
    fx = px - x0.to(torch.float32)
    fy = py - y0.to(torch.float32)

    def hist_tap(yy, xx):
        cols, ok = views.read_cols(history, width, height, yy.reshape(-1),
                                   xx.reshape(-1))
        t = vec3.where(ok, _tonemap(V3(*cols)), 0.0)
        return V3(*(c.reshape(height, width) for c in t))

    c00, c10 = hist_tap(y0, x0), hist_tap(y0, x0 + 1)
    c01, c11 = hist_tap(y0 + 1, x0), hist_tap(y0 + 1, x0 + 1)
    top = c00 * (1 - fx) + c10 * fx
    bot = c01 * (1 - fx) + c11 * fx
    hist_tm = top * (1 - fy) + bot * fy

    hist_valid = hist_valid & (frame > 0.0)
    hist_tm = vec3.where(hist_valid, hist_tm, tm_filtered)

    # variance-clipped history for the TAA branch (post.wgsl:235-239)
    h_y = _ycocg(hist_tm)
    clipped = _rgb(V3(*(torch.clamp(h, lo, hi)
                        for h, lo, hi in zip(h_y, c_min, c_max))))

    motion_px_x = motion_x * width
    motion_px_y = motion_y * height
    speed = torch.sqrt(motion_px_x * motion_px_x + motion_px_y * motion_px_y)

    # static: progressive average with raw history (post.wgsl:246-259);
    # the blend is an f32 scalar in the reference, so round as it does
    accum_blend = torch.clamp(accumulation_blend(frame), 0.0, 1.0)
    static_tm = tm_filtered * (1.0 - accum_blend) + hist_tm * accum_blend
    # moving: clamped history with dynamic feedback (post.wgsl:261-266)
    t = torch.clamp(speed / 2.0, 0.0, 1.0)
    feedback = 0.98 + (0.85 - 0.98) * (t * t * (3.0 - 2.0 * t))
    moving_tm = tm_filtered * (1.0 - feedback) + clipped * feedback

    final_tm = vec3.where(speed < 0.5, static_tm, moving_tm)
    final_tm = vec3.where(hist_valid, final_tm, tm_filtered)

    inv = _inv_tonemap(final_tm)
    final = V3(*(torch.clamp(c, min=0.0) for c in inv))
    ldr = V3(*(torch.pow(torch.clamp(c, 0.0, 1.0), 1.0 / 2.2)
               for c in final))
    return (torch.stack([c.reshape(-1) for c in ldr], dim=-1),
            torch.stack([c.reshape(-1) for c in final], dim=-1))
