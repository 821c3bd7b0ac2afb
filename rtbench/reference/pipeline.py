"""Full ReSTIR frame (src/renderer.rs:399-515;
`tpu_raytracer/render/pipeline.py`), on one device over the whole image:

    G-buffer -> ReSTIR temporal -> ReSTIR spatial (+shade) -> post -> LDR

State between frames is a plain dict of tensors (`init_state`): the
packed G-buffer, the packed spatial reservoirs and the accumulation
buffer, in the reference's layouts. The program's row bands render the
same frame band by band, so their gathered output is held to this one.
"""

from __future__ import annotations

import torch

from . import gbuffer as gbuffer_ops
from . import post as post_ops
from . import restir as restir_ops


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


def render_frame(scene, camera, frame_count, state, width: int,
                 height: int, static_ok: bool = False,
                 gb_reuse: bool = False):
    """One complete ReSTIR frame.

    scene: the reference's scene tables (`tables.build`); camera: the
    camera uniform on the device; frame_count: the accumulation counter
    (the caller resets it on camera motion), a Python int or a 0-dim
    int64 tensor on the frame's device, the same bits either way; state:
    from `init_state` or the previous frame; static_ok: nothing (camera,
    scene) changed since the previous frame, which enables temporal
    replay dedup; gb_reuse: on a static_ok frame, unpack last frame's
    G-buffer instead of tracing the primary rays (the reference's
    TPU_RT_GB_REUSE), which then count 0 rays. The G-buffer draws no RNG
    and pack_gb/unpack_gb round-trip every value, so reuse is exact when
    camera and scene are unchanged.

    Returns (ldr [n, 3] gamma-encoded, hdr [n, 3], new_state, aux) where
    aux["rays"] is the exact number of traversal queries: primary rays
    (none when the G-buffer is reused), both path traces and every
    shadow and visibility ray.
    """
    ctx = restir_ops.make_ctx(width, height, state["accum"].device)
    reuse = gb_reuse and static_ok
    if reuse:
        gb = gbuffer_ops.unpack_gb(state["gb"])
    else:
        gb = gbuffer_ops.render_gbuffer(scene, camera, width, height)
    # G-buffer and reservoir rows ride one array, so every neighbour tap
    # is a single row gather
    reservoirs_t, rays_t = restir_ops.restir_temporal(
        scene, gb, torch.cat([state["gb"], state["res"]], dim=-1), camera,
        frame_count, ctx, static_ok=static_ok)

    gb_packed = gbuffer_ops.pack_gb(gb)
    res_t_packed = restir_ops.pack_reservoirs(reservoirs_t)
    reservoirs_s, hdr, rays_s, diag = restir_ops.restir_spatial(
        scene, gb, torch.cat([gb_packed, res_t_packed], dim=-1),
        reservoirs_t, camera, frame_count, ctx)

    ldr, accum = post_ops.post_process(hdr, gb, gb_packed, state["accum"],
                                       frame_count, ctx)
    new_state = {"gb": gb_packed,
                 "res": restir_ops.pack_reservoirs(reservoirs_s),
                 "accum": accum}
    aux = {"rays": (0.0 if reuse else float(width * height)) + rays_t
           + rays_s, **diag}
    return ldr, hdr, new_state, aux
