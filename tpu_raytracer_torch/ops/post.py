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

The pass works on per-channel [band_h, W] planes of one row band; stencil
taps are rolls of the band's planes with their halo rows, masked by the
image bounds. Camera jitter is disabled upstream as in the
reference (camera.rs:202-203), so there is no unjitter resample.

Route by device, as every kernel of the port:
  - CPU tensors: `post_process_plain`, the eager PyTorch version below;
  - CUDA tensors: kernel K10 (`csrc/post.cu`, `post_process_kernel`), one
    launch a band, counted in `trace_api.LAUNCHES` ("post"), or the call
    raises. K10 reads the views' rows in place and reproduces the eager
    version's arithmetic on the card op for op (f32, the same order and
    constants, the rolls' wrap, the history taps' clamp and coverage).
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..parallel.views import BandView
from ..utils import vec3
from ..utils.vec3 import V3, ipow
from .gbuffer import GB_ALBEDO, GB_COLS, GB_MOTION, GB_OCT, GB_POS
from .trace_api import count_launch, load_kernels

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
    offsets. The planes cover the view's band_h + 2 * halo rows; a tap
    rolls them and crops the band's rows, so a roll's wrap lands in the
    halo (which holds |dy| <= halo rows) or is masked by the global image
    bounds."""

    def __init__(self, view, ctx, channels):
        img = view.as_2d()
        self.planes = [img[:, :, k] for k in channels]
        self.halo, self.band_h = view.halo, ctx["band_h"]
        self.height, self.width = ctx["height"], ctx["width"]
        device = view.data.device
        self.ys = ctx["y0"] + torch.arange(self.band_h, device=device)[:, None]
        self.xs = torch.arange(self.width, device=device)[None, :]

    def tap(self, dy: int, dx: int):
        out = [torch.roll(p, (-dy, -dx), dims=(0, 1))
               [self.halo:self.halo + self.band_h] for p in self.planes]
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


def post_process(hdr_view, gb, gb_view, history_view, frame_count, ctx):
    """Full post pass over one band: `post_process_plain` on CPU tensors,
    K10 (`post_process_kernel`) on CUDA tensors.

    hdr_view: view of the spatial pass's HDR output [n, 3] (halo >= 2 on
    row bands); gb: the band's flat G-buffer (motion); gb_view: view of
    the packed G-buffer; history_view: view of the accumulation buffer,
    read at global rows; frame_count: the SPP counter, a Python int or a
    0-dim int64 tensor on the band's device; ctx: the band context
    (restir.make_ctx).

    Returns (ldr [n, 3] gamma-encoded, new_accum [n, 3] linear HDR)."""
    if gb["motion"].device.type == "cpu":
        return post_process_plain(hdr_view, gb, gb_view, history_view,
                                  frame_count, ctx)
    return post_process_kernel(hdr_view, gb, gb_view, history_view,
                               frame_count, ctx)


def post_process_plain(hdr_view, gb, gb_view, history_view, frame_count,
                       ctx):
    """`post_process` in eager PyTorch ops, on any device: the CPU route,
    and on the card the yardstick K10 is held to."""
    band_h, width, height = ctx["band_h"], ctx["width"], ctx["height"]
    frame = frame_f32(frame_count, ctx["device"])

    gb_ch = (list(range(GB_ALBEDO.start, GB_ALBEDO.stop))
             + list(range(GB_OCT.start, GB_OCT.stop))
             + list(range(GB_POS.start, GB_POS.stop)))
    s_hdr = _PlaneStencil(hdr_view, ctx, [0, 1, 2])
    s_gb = _PlaneStencil(gb_view, ctx, gb_ch)

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
    motion = gb["motion"].reshape(band_h, width, 2)
    motion_x = motion[..., 0]
    motion_y = motion[..., 1]
    device = motion.device
    ys, xs = torch.meshgrid(
        float(ctx["y0"]) + torch.arange(band_h, dtype=torch.float32,
                                        device=device),
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
        cols, ok = history_view.read_cols(yy.reshape(-1), xx.reshape(-1))
        t = vec3.where(ok, _tonemap(V3(*cols)), 0.0)
        return V3(*(c.reshape(band_h, width) for c in t))

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


# ---------------------------------------------------------------------------
# K10 (CUDA tensors)
# ---------------------------------------------------------------------------

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
# the bilateral's spatial weights, in its tap order, as the eager version
# multiplies them (a Python float, rounded to f32 by the product)
W_SPATIAL = [math.exp(-(dx * dx + dy * dy) / (2.0 * SIGMA_SPATIAL ** 2))
             for dy in range(-KERNEL_RADIUS, KERNEL_RADIUS + 1)
             for dx in range(-KERNEL_RADIUS, KERNEL_RADIUS + 1)]


class PostArgs(ctypes.Structure):
    """csrc/post.cu:PostArgs, field for field."""
    _fields_ = [
        *((n, _P) for n in ("hdr", "gb", "accum", "frame", "ldr", "out")),
        *((n, _L) for n in ("hdr_s", "gb_s", "accum_s", "frame_value")),
        *((n, _I) for n in ("width", "height", "band_h", "y0", "halo",
                            "h_y0", "h_band_h", "h_halo", "h_width",
                            "h_height", "gb_pos", "gb_oct", "gb_albedo",
                            "gb_motion", "blocks_x")),
        ("w_spatial", _F * len(W_SPATIAL)),
    ]


def _rows(x, name, rows, cols, device):
    """x's pointer and row stride, where x is [rows, cols] f32 on `device`
    with adjacent columns; raises on anything else."""
    if x.device != device or x.dtype != torch.float32 or x.dim() != 2 \
            or tuple(x.shape) != (rows, cols) or x.stride(1) != 1 \
            or x.stride(0) < cols:
        raise ValueError(
            f"{name}: want f32 [{rows}, {cols}] rows of adjacent words on "
            f"{device}, got {x.dtype} {tuple(x.shape)} strides "
            f"{tuple(x.stride())} on {x.device}")
    return x.data_ptr(), x.stride(0)


def post_process_kernel(hdr_view, gb, gb_view, history_view, frame_count,
                        ctx):
    """`post_process` on CUDA tensors: one launch of K10, counted in
    `trace_api.LAUNCHES`. The three views must be `BandView`s whose rows
    and frame_count (an int, or a 0-dim int64 tensor) lie on gb["motion"]'s
    CUDA device; raises on anything else."""
    device = gb["motion"].device
    if device.type != "cuda":
        raise ValueError(f"post_process_kernel needs CUDA tensors, got "
                         f"{device}")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        return run_k10(load_kernels(), stream, count_launch, hdr_view, gb,
                       gb_view, history_view, frame_count, ctx)


def run_k10(lib, stream, launched, hdr_view, gb, gb_view, history_view,
            frame_count, ctx):
    """K10's launch from `lib` on `stream` (a handle, or None for the host
    emulation of the tests), `launched("post")` after it. It reads the
    views' rows in place, and frame_count's device word where it is a
    tensor: nothing is read back to the host, so the call captures into a
    CUDA graph. The motion is read from the band's own rows of gb_view, at
    GB_MOTION, where `pack_gb` put gb["motion"]; gb gives the device."""
    band_h, width, height = ctx["band_h"], ctx["width"], ctx["height"]
    device = gb["motion"].device
    views = (("hdr_view", hdr_view), ("gb_view", gb_view),
             ("history_view", history_view))
    for name, v in views:
        if not isinstance(v, BandView):
            raise ValueError(f"{name}: want a BandView, got "
                             f"{type(v).__name__}")
    for name, v in views[:2]:
        if (v.band_h, v.width, v.halo) != (band_h, width, hdr_view.halo):
            raise ValueError(
                f"{name}: band_h {v.band_h}, width {v.width}, halo "
                f"{v.halo}; K10 wants the band's {band_h} and {width}, and "
                f"one halo for the HDR and G-buffer views")
    n = band_h * width
    if n == 0:
        raise ValueError("K10 needs a band of at least one pixel")
    halo = hdr_view.halo
    h_cover = history_view.band_h + 2 * history_view.halo
    if (band_h + 2 * halo) * width >= 2 ** 31 \
            or h_cover * history_view.width >= 2 ** 31:
        raise ValueError("a view exceeds K10's int32 pixel indices")
    hdr, hdr_s = _rows(hdr_view.data, "hdr_view", (band_h + 2 * halo) * width,
                       3, device)
    gbr, gb_s = _rows(gb_view.data, "gb_view", (band_h + 2 * halo) * width,
                      GB_COLS, device)
    acc, acc_s = _rows(history_view.data, "history_view",
                       h_cover * history_view.width, 3, device)
    args = PostArgs(
        hdr=hdr, gb=gbr, accum=acc, hdr_s=hdr_s, gb_s=gb_s, accum_s=acc_s,
        width=width, height=height, band_h=band_h, y0=ctx["y0"], halo=halo,
        h_y0=history_view.y0, h_band_h=history_view.band_h,
        h_halo=history_view.halo, h_width=history_view.width,
        h_height=history_view.height, gb_pos=GB_POS.start,
        gb_oct=GB_OCT.start, gb_albedo=GB_ALBEDO.start,
        gb_motion=GB_MOTION.start,
        w_spatial=(_F * len(W_SPATIAL))(*W_SPATIAL))
    if isinstance(frame_count, torch.Tensor):
        if frame_count.device != device or frame_count.dtype != torch.int64 \
                or frame_count.dim() != 0:
            raise ValueError(f"frame_count: want a 0-dim int64 tensor on "
                             f"{device}, got {frame_count.dtype} "
                             f"{tuple(frame_count.shape)} on "
                             f"{frame_count.device}")
        args.frame = frame_count.data_ptr()
    else:
        args.frame_value = int(frame_count)

    ldr = torch.empty((n, 3), dtype=torch.float32, device=device)
    accum = torch.empty((n, 3), dtype=torch.float32, device=device)
    args.ldr, args.out = ldr.data_ptr(), accum.data_ptr()
    err = lib.tpurt_post(ctypes.addressof(args), stream)
    if err != 0:
        raise RuntimeError(f"post launch failed: CUDA error {err}")
    launched("post")
    return ldr, accum
