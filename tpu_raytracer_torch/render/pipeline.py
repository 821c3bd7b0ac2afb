"""Full ReSTIR frame (src/renderer.rs:399-515;
`tpu_raytracer/render/pipeline.py`):

    G-buffer -> ReSTIR temporal -> ReSTIR spatial (+shade) -> post -> LDR

State between frames is a plain dict of tensors (`init_state`): the
packed G-buffer, the packed spatial reservoirs and the accumulation
buffer, in the reference's layouts. `render_band` is one frame over one
row band; `render_frame` is the one-device case, and
`parallel/tiles.py` runs it over row bands on several devices.
"""

from __future__ import annotations

import torch

from ..ops import gbuffer as gbuffer_ops
from ..ops import post as post_ops
from ..ops import restir as restir_ops
from ..parallel import views as views_mod
from ..utils import profiling

# frames above this many pixels read G-buffer + reservoir rows through a
# pair view instead of materializing their concatenation
PAIR_VIEW_PIXELS = 4 * 1024 * 1024


def init_state(width: int, height: int, device) -> dict:
    """Fresh frame state: packed prev G-buffer + reservoirs + accum."""
    n = width * height
    return {
        "gb": torch.zeros((n, gbuffer_ops.GB_COLS), dtype=torch.float32,
                          device=device),
        "res": restir_ops.pack_reservoirs(
            restir_ops.empty_reservoirs(n, device)),
        "accum": torch.zeros((n, 3), dtype=torch.float32, device=device),
    }


def _gb_for_band(scene, camera, prev_gb_rows, ctx, reuse: bool):
    """The band's G-buffer (reference pipeline.py:42-71): traced, or with
    `reuse` last frame's packed rows of this band unpacked. Reuse is
    exact when camera and scene are unchanged (static_ok): the G-buffer
    draws no RNG, so it is deterministic in (scene, camera), and
    pack_gb/unpack_gb round-trip every value."""
    if reuse:
        return gbuffer_ops.unpack_gb(prev_gb_rows)
    return gbuffer_ops.render_gbuffer(scene, camera, ctx["width"],
                                      ctx["height"], y0=ctx["y0"],
                                      band_h=ctx["band_h"])


def render_band(scene, camera, frame_count, state, ctx, make_view,
                static_ok: bool = False, make_view2=None,
                gb_reuse: bool = False):
    """One frame over one row band (the whole image on one device).

    make_view lifts a band-local flat array to a neighbour-readable
    BandView: trivial on one device, halo-exchanged over row bands
    (`parallel/tiles.py`), where every band reaches it in the same order.
    make_view2: optional (a, b) -> a view of their concatenation that
    never builds it, used for bands above PAIR_VIEW_PIXELS. gb_reuse:
    on a static_ok frame, unpack last frame's G-buffer rows instead of
    tracing the primary rays (the reference's TPU_RT_GB_REUSE), which
    then count 0 rays.
    Returns (ldr, hdr, new_state, aux) for the band's rows."""
    width = ctx["width"]
    n_primary = ctx["band_h"] * width
    reuse = gb_reuse and static_ok

    def comb(a, b):
        if make_view2 is not None and n_primary > PAIR_VIEW_PIXELS:
            return make_view2(a, b)
        return make_view(torch.cat([a, b], dim=-1))

    # every device operation of the band's frame lies in a stage
    # (utils/profiling.py:stage), the halo exchanges of its views too
    with profiling.stage("gbuffer"):
        gb = _gb_for_band(scene, camera, state["gb"], ctx, reuse)
    # G-buffer and reservoir rows ride one view, so every neighbour tap
    # is a single row gather
    with profiling.stage("restir_temporal"):
        reservoirs_t, rays_t = restir_ops.restir_temporal(
            scene, gb, comb(state["gb"], state["res"]), camera, frame_count,
            ctx, static_ok=static_ok)

    with profiling.stage("restir_spatial"):
        gb_packed = gbuffer_ops.pack_gb(gb)
        res_t_packed = restir_ops.pack_reservoirs(reservoirs_t)
        reservoirs_s, hdr, rays_s, diag = restir_ops.restir_spatial(
            scene, gb, comb(gb_packed, res_t_packed), reservoirs_t, camera,
            frame_count, ctx)

    with profiling.stage("post"):
        ldr, accum = post_ops.post_process(
            make_view(hdr), gb, make_view(gb_packed),
            make_view(state["accum"]), frame_count, ctx)
        new_state = {"gb": gb_packed,
                     "res": restir_ops.pack_reservoirs(reservoirs_s),
                     "accum": accum}
        # the exact traversal-query count: primary rays (none when the
        # G-buffer is reused) + both path traces + every shadow and
        # visibility ray
        aux = {"rays": (0.0 if reuse else float(n_primary)) + rays_t
               + rays_s, **diag}
    return ldr, hdr, new_state, aux


def render_frame(scene, camera, frame_count, state, width: int,
                 height: int, static_ok: bool = False,
                 gb_reuse: bool = False, tap_batch: bool = False):
    """One complete ReSTIR frame on one device.

    scene: CompiledScene; camera: device camera uniform
    (renderer.camera_to_device); frame_count: the accumulation counter
    (the caller resets it on camera motion), a Python int or a 0-dim
    int64 tensor on the frame's device, the same bits either way; state:
    from `init_state` or the previous frame; static_ok: nothing (camera,
    scene) changed since the previous frame, which enables temporal
    replay dedup - False is always safe; gb_reuse: on a static_ok frame,
    reuse last frame's G-buffer instead of tracing the primary rays (off
    by default, as in the reference; the app turns it on); tap_batch:
    the spatial taps' visibility as one any-hit call over 5R rays
    (`restir.tap_batch_on`; off by default, as in the reference).

    Returns (ldr [n, 3] gamma-encoded, hdr [n, 3], new_state, aux) where
    aux["rays"] is the exact number of traversal queries (0-dim tensor).
    """
    ctx = restir_ops.make_ctx(width, height, state["accum"].device,
                              tap_batch=tap_batch)

    def make_view(flat):
        return views_mod.trivial_view(flat, width, height)

    def make_view2(a, b):
        return views_mod.trivial_pair_view(a, b, width, height)

    return render_band(scene, camera, frame_count, state, ctx, make_view,
                       static_ok=static_ok, make_view2=make_view2,
                       gb_reuse=gb_reuse)
