"""Progressive frame: one candidate path per pixel plus a running average
(post.wgsl:246-259; `tpu_raytracer/render/renderer.py`). The full ReSTIR
frame is render/pipeline.py."""

from __future__ import annotations

import numpy as np
import torch

from ..ops import gbuffer as gbuffer_ops
from ..ops import path_trace
from ..ops import post as post_ops
from ..utils import profiling, rng


def camera_to_device(camera: dict, device) -> dict:
    """Camera uniform (render/camera.py) -> dict of tensors on `device`;
    uint32 scalars become int64. A host span, "camera.to_device"
    (`utils/profiling.py:span`)."""
    out = {}
    with profiling.span("camera.to_device"):
        for k, v in camera.items():
            v = np.asarray(v)
            if v.dtype == np.uint32:
                v = v.astype(np.int64)
            out[k] = torch.as_tensor(v, device=device)
    return out


def render_progressive(scene, camera, frame_count, accum, width: int,
                       height: int):
    """One progressive frame. frame_count: a Python int or a 0-dim int64
    tensor on accum's device (the same bits either way); accum: [H*W, 3]
    running average. Returns (new_accum, radiance), both [H*W, 3] linear
    HDR."""
    gb = gbuffer_ops.render_gbuffer(scene, camera, width, height)
    n = width * height
    pixel = torch.arange(n, dtype=torch.int64, device=accum.device)
    seed = rng.pcg_hash(pixel + (frame_count & 0xFFFFFFFF) * 927163)
    radiance = path_trace.trace_path(scene, gb, camera["view_pos"][:3],
                                     seed)["radiance"]
    # blend = 1 - 1/(N+1) in f32, as the reference rounds it
    blend = post_ops.accumulation_blend(
        post_ops.frame_f32(frame_count, accum.device))
    return accum * blend + radiance * (1.0 - blend), radiance


def make_accum(width: int, height: int, device):
    return torch.zeros((width * height, 3), dtype=torch.float32,
                       device=device)
