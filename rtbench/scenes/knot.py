"""The dense glTF scene: the upstream glTF scene (fast-raytracing-wgpu
src/scene/scenes.rs:249-319: a model on a 10x floor under a quad light)
holding the reference bench's config 6 asset, a 100,800-triangle
textured trefoil knot (base colour, normal and metallic-roughness
textures at 1024^2): 100,804 triangles.

The knot's mesh and texels are a frozen copy of the generator of
`tpu_raytracer_torch/models/dense_asset.py`. This package writes the
.glb itself (`glb.py`) into `rtbench/_cache/`, once per checkout, and
the program loads it through its glTF loader; the reference takes the
same arrays without the file (`KnotAsset.expand`).
"""

from __future__ import annotations

import os

import numpy as np

from ..reference.math3d import rotation_x, scale, translation
from . import SceneDesc, glb, shapes

PI = np.pi
CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_cache")
# raised when the asset's content changes: a cached file of another
# version is written again
ASSET_VERSION = 1


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


class KnotAsset:
    """The knot as a glTF file (`path`, for the program) and as scene
    operations (`expand`, for the reference), placed by `transform`."""

    def __init__(self, transform, major: int, minor: int):
        self.transform = np.asarray(transform, np.float32)
        self.major, self.minor = major, minor
        self.path = os.path.join(CACHE_DIR,
                                 f"knot_{major}x{minor}.glb")

    def ensure(self) -> str:
        """Write the .glb unless this version of it is there; its path."""
        stamp = self.path + ".version"
        try:
            with open(stamp) as f:
                fresh = f.read().strip() == str(ASSET_VERSION)
        except OSError:
            fresh = False
        if not (fresh and os.path.exists(self.path)):
            pos, nrm, uv, tan, idx = knot_mesh(self.major, self.minor)
            material = {
                "name": "knot_lacquer",
                "pbrMetallicRoughness": {
                    "baseColorFactor": [1.0, 1.0, 1.0, 1.0],
                    "baseColorTexture": {"index": 0},
                    "metallicRoughnessTexture": {"index": 2},
                    "metallicFactor": 1.0, "roughnessFactor": 1.0},
                "normalTexture": {"index": 1}}
            glb.write_glb(self.path, [{"pos": pos, "nrm": nrm, "uv": uv,
                                       "tan": tan, "idx": idx,
                                       "material": 0}],
                          [glb.encode_rgb(t) for t in _texture_pixels()],
                          [material])
            with open(stamp, "w") as f:
                f.write(str(ASSET_VERSION))
        return self.path

    def expand(self) -> list:
        """The asset as scene operations, in the order a glTF loader
        registers it after the floor and the light: the base colour
        (colour texture 3), normal and metallic-roughness maps (data
        textures 3 and 4), the material (2), the mesh (1) and its
        instance."""
        pos, nrm, uv, tan, idx = knot_mesh(self.major, self.minor)
        nrm = nrm.astype(np.float32)
        nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-12)
        base, normal, mr = _texture_pixels()
        return [
            ("color_texture", base, True), ("data_texture", normal),
            ("data_texture", mr),
            ("material", {"base_color": (1.0, 1.0, 1.0, 1.0),
                          "roughness": 1.0, "metallic": 1.0, "tex_id": 3,
                          "normal_tex_id": 3,
                          "metallic_roughness_tex_id": 4}),
            ("mesh", {"positions": pos, "oct_normals":
                      shapes.oct_encode_np(nrm), "uvs": uv, "tangents": tan,
                      "indices": idx}),
            ("instance", 1, 2, self.transform)]


def describe(config: dict) -> SceneDesc:
    ops = [("mesh", shapes.create_plane()),
           ("material", {"base_color": (0.73, 0.73, 0.73, 1.0),
                         "roughness": 0.99}),
           ("instance", 0, 0, translation([0, -1, 0]) @ scale(10.0)),
           ("quad_light", 0, translation([0, 5.0, 0]) @ rotation_x(PI)
            @ scale(1.5), [1.0, 1.0, 1.0], 15.0),
           ("gltf", KnotAsset(translation([0, 1.2, 0]) @ scale(1.1),
                              config["knot_major"], config["knot_minor"]))]
    return SceneDesc(ops, {"position": [0.0, 0.0, 3.0],
                           "yaw": float(np.radians(-90.0)), "pitch": 0.0})
