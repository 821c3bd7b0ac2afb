"""Analytic light sampling for NEE (restir.wgsl:219-245;
`tpu_raytracer/ops/lights.py`). Quad lights sample the parallelogram of
their half-extent vectors u/v; sphere lights (radius in v.x) sample the
whole sphere. Area pdf = 1 / area."""

from __future__ import annotations

import numpy as np
import torch

from . import vec3
from .vec3 import V3

PI = float(np.float32(np.pi))


def sample_light(light_rows, r1, r2):
    """Sample light rows (hit.gather_light) with uniforms r1, r2.
    Returns dict: pos V3, normal V3, pdf [R], emission V3, emission_w,
    area."""
    position = light_rows["position"]
    u_vec = light_rows["u"]
    v_vec = light_rows["v"]
    area = light_rows["area"]

    su = r1 * 2.0 - 1.0
    sv = r2 * 2.0 - 1.0
    quad_pos = position + u_vec * su + v_vec * sv
    quad_normal = vec3.normalize(vec3.cross(u_vec, v_vec))

    z = 1.0 - 2.0 * r1
    r_xy = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = 2.0 * PI * r2
    local_dir = V3(r_xy * torch.cos(phi), r_xy * torch.sin(phi), z)
    sphere_pos = position + local_dir * v_vec.x

    is_quad = light_rows["type"] == 0
    return {
        "pos": vec3.where(is_quad, quad_pos, sphere_pos),
        "normal": vec3.where(is_quad, quad_normal, local_dir),
        "pdf": 1.0 / torch.clamp(area, min=1e-12),
        "emission": light_rows["emission"],
        "emission_w": light_rows["emission_w"],
        "area": area,
    }
