"""Procedural dense test asset: a 100,800-triangle textured trefoil knot,
written as a self-contained binary .glb (bench.py config 6).

Port of `tpu_raytracer/models/dense_asset.py`: the mesh and the texture
pixels are the reference's, array for array; the PNGs are written by
`utils/png.py` (filter 0), so the file's bytes differ from the
reference's while every decoded value is the same. The file is generated
on first use and cached under assets/models/ at a name of the port's own.
"""

from __future__ import annotations

import os

import numpy as np

from ..utils import png
from .glb_writer import ensure_written, write_glb

# anchored to the repo root (two levels above this package), so every
# entry point finds the same cached asset whatever the working directory
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_PATH = os.path.join(_REPO_ROOT, "assets", "models",
                            "torch_dense_knot.glb")


def _knot_curve(u):
    """Trefoil curve + unit Frenet-ish frame at parameters u [M]."""
    p = np.stack([np.sin(u) + 2.0 * np.sin(2.0 * u),
                  np.cos(u) - 2.0 * np.cos(2.0 * u),
                  -np.sin(3.0 * u)], axis=-1) / 3.0
    d = np.stack([np.cos(u) + 4.0 * np.cos(2.0 * u),
                  -np.sin(u) + 4.0 * np.sin(2.0 * u),
                  -3.0 * np.cos(3.0 * u)], axis=-1)
    dd = np.stack([-np.sin(u) - 8.0 * np.sin(2.0 * u),
                   -np.cos(u) + 8.0 * np.cos(2.0 * u),
                   9.0 * np.sin(3.0 * u)], axis=-1)
    t = d / np.linalg.norm(d, axis=-1, keepdims=True)
    # curve normal: curvature direction (trefoil curvature never vanishes)
    n = dd - t * np.sum(dd * t, axis=-1, keepdims=True)
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    b = np.cross(t, n)
    return p, t, n, b


def knot_mesh(major: int = 420, minor: int = 120, tube_r: float = 0.22):
    """Tube around the trefoil: (positions, normals, uvs, tangents, indices).

    major*minor vertices, 2*major*minor triangles (420x120 -> 100,800)."""
    u = np.arange(major, dtype=np.float64) * (2.0 * np.pi / major)
    c, t, n, b = _knot_curve(u)                       # [M, 3] each
    theta = np.arange(minor, dtype=np.float64) * (2.0 * np.pi / minor)
    cos_t = np.cos(theta)[None, :, None]              # [1, m, 1]
    sin_t = np.sin(theta)[None, :, None]
    ring_n = n[:, None, :] * cos_t + b[:, None, :] * sin_t   # [M, m, 3]
    pos = c[:, None, :] + tube_r * ring_n
    # uv tiles the texture 6x around the knot, 2x around the tube
    uu = (np.arange(major) / major)[:, None].repeat(minor, 1) * 6.0
    vv = (np.arange(minor) / minor)[None, :].repeat(major, 0) * 2.0
    uv = np.stack([uu % 1.0, vv % 1.0], axis=-1)
    # surface tangent = direction of increasing u (the curve tangent)
    tan = np.broadcast_to(t[:, None, :], pos.shape)
    tangents = np.concatenate(
        [tan.reshape(-1, 3), np.ones((major * minor, 1))], axis=-1)

    def vid(i, j):
        return (i % major) * minor + (j % minor)

    ii, jj = np.meshgrid(np.arange(major), np.arange(minor), indexing="ij")
    a = vid(ii, jj)
    b2 = vid(ii + 1, jj)
    cq = vid(ii + 1, jj + 1)
    d2 = vid(ii, jj + 1)
    # the winding makes cross(v1 - v0, v2 - v0) agree with the outward
    # ring normals; the other order flips every shading normal at the
    # front-face test and renders the knot black
    tris = np.concatenate([
        np.stack([a, cq, b2], axis=-1).reshape(-1, 3),
        np.stack([a, d2, cq], axis=-1).reshape(-1, 3),
    ], axis=0)
    return (pos.reshape(-1, 3).astype(np.float32),
            ring_n.reshape(-1, 3).astype(np.float32),
            uv.reshape(-1, 2).astype(np.float32),
            tangents.astype(np.float32),
            tris.reshape(-1).astype(np.uint32))


def _texture_pixels(size: int = 1024):
    """(base_color, normal, metallic_roughness) RGB uint8 [size, size, 3]."""
    y, x = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    fu = x / size
    fv = y / size
    # base color: two-tone lacquer bands + fine marbling
    swirl = np.sin(2 * np.pi * (fu * 4 + 0.35 * np.sin(2 * np.pi * fv * 3)))
    marble = 0.5 + 0.5 * np.sin(
        2 * np.pi * (fv * 9 + 0.2 * np.sin(2 * np.pi * fu * 13)))
    band = (swirl > 0.0).astype(np.float64)
    r = band * (0.72 + 0.18 * marble) + (1 - band) * 0.10
    g = band * (0.20 + 0.10 * marble) + (1 - band) * 0.25
    bl = band * 0.12 + (1 - band) * (0.55 + 0.25 * marble)
    base = np.stack([r, g, bl], axis=-1)
    base_u8 = np.clip(base * 255.0 + 0.5, 0, 255).astype(np.uint8)

    # normal map from a bump height field (dimples + grooves)
    h = (0.6 * np.sin(2 * np.pi * fu * 24) * np.sin(2 * np.pi * fv * 24)
         + 0.4 * np.sin(2 * np.pi * (fu * 3 + fv * 7)))
    gx = np.roll(h, -1, 1) - np.roll(h, 1, 1)
    gy = np.roll(h, -1, 0) - np.roll(h, 1, 0)
    nz = np.full_like(h, 0.35)
    n = np.stack([-gx, -gy, nz], axis=-1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    normal_u8 = np.clip((n * 0.5 + 0.5) * 255.0 + 0.5, 0, 255
                        ).astype(np.uint8)

    # glTF MR: G = roughness (rough in the grooves), B = metallic (bands)
    rough = np.clip(0.25 + 0.5 * (1.0 - band) + 0.2 * (h * 0.5 + 0.5), 0, 1)
    metal = np.clip(band * 0.9, 0, 1)
    mr = np.stack([np.zeros_like(rough), rough, metal], axis=-1)
    mr_u8 = np.clip(mr * 255.0 + 0.5, 0, 255).astype(np.uint8)
    return base_u8, normal_u8, mr_u8


def _texture_set(size: int = 1024):
    """(base_color, normal, metallic_roughness) PNG bytes."""
    return tuple(png.encode_rgb(img) for img in _texture_pixels(size))


def write_knot_glb(path: str = DEFAULT_PATH, major: int = 420,
                   minor: int = 120, tex_size: int = 1024) -> str:
    """Write the dense knot .glb to `path` (through a private temporary
    file and a rename, so a concurrent reader never sees half a file);
    returns the path."""
    pos, nrm, uv, tan, idx = knot_mesh(major, minor)
    knot = {"pos": pos, "nrm": nrm, "uv": uv, "tan": tan, "idx": idx,
            "material": 0}
    material = {
        "name": "knot_lacquer",
        "pbrMetallicRoughness": {
            "baseColorFactor": [1.0, 1.0, 1.0, 1.0],
            "baseColorTexture": {"index": 0},
            "metallicRoughnessTexture": {"index": 2},
            "metallicFactor": 1.0,
            "roughnessFactor": 1.0,
        },
        "normalTexture": {"index": 1},
    }
    return write_glb(path, [knot], _texture_set(tex_size), [material],
                     generator="tpu_raytracer_torch dense_asset")


# Raised when the generator's output changes: a cached .glb from an older
# generator is stale and is written again.
ASSET_VERSION = 1


def ensure_dense_asset(path: str = DEFAULT_PATH) -> str:
    """Generate the asset if missing or stale; returns the path."""
    return ensure_written(path, write_knot_glb, ASSET_VERSION)
