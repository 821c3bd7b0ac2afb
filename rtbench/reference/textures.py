"""Texture-array sampling with repeat addressing and bilinear filtering
(builder.rs:477-575 semantics; `tpu_raytracer/ops/textures.py`).

Textures are [L, H, W, 3] bf16 with color pre-decoded to linear, so
filtering happens in linear space like hardware Rgba8UnormSrgb. A sample
is four plain gathers plus lerps.
"""

from __future__ import annotations

import torch

from .tables import NO_TEXTURE
from .vec3 import V3


def sample_bilinear(tex, layer, u, v) -> V3:
    """tex [L, H, W, 3]; layer [R] int texture ids (``NO_TEXTURE`` lanes
    return 1.0); u, v [R] f32. Returns a V3 of [R] channels."""
    n_layers, h, w = tex.shape[0], tex.shape[1], tex.shape[2]
    valid = layer != NO_TEXTURE
    base = torch.where(valid, torch.clamp(layer, max=n_layers - 1), 0) \
        .to(torch.int64) * (h * w)

    x = u * w - 0.5
    y = v * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    # repeat wrap: floor-mod, like jnp.mod (not fmod)
    xi0 = torch.remainder(x0.to(torch.int64), w)
    yi0 = torch.remainder(y0.to(torch.int64), h)
    xi1 = torch.remainder(xi0 + 1, w)
    yi1 = torch.remainder(yi0 + 1, h)

    flat = tex.reshape(-1, 3)

    def texel(yi, xi):
        return flat[base + yi * w + xi].to(torch.float32)

    q00, q10 = texel(yi0, xi0), texel(yi0, xi1)
    q01, q11 = texel(yi1, xi0), texel(yi1, xi1)

    def chan(k):
        top = q00[:, k] * (1 - fx) + q10[:, k] * fx
        bot = q01[:, k] * (1 - fx) + q11[:, k] * fx
        return torch.where(valid, top * (1 - fy) + bot * fy, 1.0)

    return V3(chan(0), chan(1), chan(2))
