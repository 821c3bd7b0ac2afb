"""Deterministic procedural stand-ins for the reference's showcase assets.

Port of `tpu_raytracer/models/procedural_assets.py`: the meshes, the
texture pixels and the materials are the reference's, array for array;
the PNGs are written by `utils/png.py`, so the files' bytes differ from
the reference's while every decoded value is the same. The Rust original
renders downloaded glTF models (src/scene/scenes.rs:321-504): Avocado,
DamagedHelmet, a multi-material VRM avatar and the gift-wrapped
chocolate its default state loads. None of them is redistributable, so
each named scene gets a .glb generated on first use that exercises what
the scene exercises:

  avocado  - one textured lathe body (base color + MR + normal maps)
  helmet   - dome/visor/rim, 3 materials, emissive-texture stripe
  figure   - VRM-class humanoid: 15 primitives across 5 materials
             (skin, dress w/ textures, hair, eyes, ribbon)
  truffle  - dark chocolate sphere + bright ribbon bands + bow, so the
             luminance-threshold material rewrite (scenes.rs:393-411)
             hits both branches on a loaded asset

Geometry is surfaces of revolution (`lathe`) plus rigid placement;
meshes carry positions/normals/uvs/tangents and go through the glTF
loader (scene/loader.py). The files are cached under assets/models/ at
names of the port's own (`asset_path`).
"""

from __future__ import annotations

import os

import numpy as np

from ..utils import png
from .glb_writer import ensure_written, write_glb

# anchored to the repo root (two levels above this package), so every
# entry point finds the same cached assets whatever the working directory
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MODELS_DIR = os.path.join(_REPO_ROOT, "assets", "models")


# ---------------------------------------------------------------------------
# geometry: lathe (surface of revolution about +Y) + rigid placement
# ---------------------------------------------------------------------------

def lathe(profile, nu: int = 48):
    """Revolve a polyline profile [(r_i, y_i), ...] (bottom->top) about +Y.

    Returns dict(pos [N,3], nrm [N,3], uv [N,2], tan [N,4], idx [M]) with
    outward normals from the profile tangent, u wrapping the axis (seam
    column duplicated for clean uvs) and v along the profile.
    """
    prof = np.asarray(profile, np.float64)
    nv = prof.shape[0]
    r, y = prof[:, 0], prof[:, 1]
    # profile tangent via central differences (one-sided at the ends)
    dr = np.gradient(r)
    dy = np.gradient(y)
    # outward surface normal in the (radial, y) plane: (dy, -dr)
    ln = np.maximum(np.hypot(dy, dr), 1e-12)
    n_rad, n_y = dy / ln, -dr / ln

    theta = np.arange(nu + 1, dtype=np.float64) * (2.0 * np.pi / nu)
    ct, st = np.cos(theta)[None, :], np.sin(theta)[None, :]
    px = r[:, None] * ct
    pz = r[:, None] * st
    py = np.broadcast_to(y[:, None], px.shape)
    nx = n_rad[:, None] * ct
    nz = n_rad[:, None] * st
    ny = np.broadcast_to(n_y[:, None], nx.shape)
    # at poles (r=0) the lathe normal is +-Y exactly (n_rad -> 0 there
    # already; zero the radial parts so normalization can't wobble them)
    pole = np.abs(r[:, None]) < 1e-9
    nx = np.where(pole, 0.0, nx)
    nz = np.where(pole, 0.0, nz)

    uu = (theta / (2.0 * np.pi))[None, :].repeat(nv, 0)
    seg = np.concatenate([[0.0], np.cumsum(np.hypot(np.diff(r),
                                                    np.diff(y)))])
    vv = (seg / max(seg[-1], 1e-12))[:, None].repeat(nu + 1, 1)

    pos = np.stack([px, py, pz], -1).reshape(-1, 3)
    nrm = np.stack([nx, ny, nz], -1)
    nrm /= np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-12)
    nrm = nrm.reshape(-1, 3)
    uv = np.stack([uu, vv], -1).reshape(-1, 2)
    # tangent = direction of increasing u (around the axis)
    tan = np.stack([-st.repeat(nv, 0), np.zeros_like(px.reshape(nv, -1)),
                    ct.repeat(nv, 0)], -1).reshape(-1, 3)
    tan4 = np.concatenate([tan, np.ones((tan.shape[0], 1))], -1)

    cols = nu + 1

    def vid(i, j):
        return i * cols + j

    ii, jj = np.meshgrid(np.arange(nv - 1), np.arange(nu), indexing="ij")
    a = vid(ii, jj)
    b = vid(ii, jj + 1)
    c = vid(ii + 1, jj + 1)
    d = vid(ii + 1, jj)
    # outward CCW winding (matches the outward normals above)
    idx = np.concatenate([
        np.stack([a, c, b], -1).reshape(-1, 3),
        np.stack([a, d, c], -1).reshape(-1, 3),
    ], 0).reshape(-1)
    return {"pos": pos.astype(np.float32), "nrm": nrm.astype(np.float32),
            "uv": uv.astype(np.float32), "tan": tan4.astype(np.float32),
            "idx": idx.astype(np.uint32)}


def sphere_profile(radius: float, n: int = 24, y0: float = 0.0,
                   lat_range=(0.0, np.pi)):
    """Profile for a (partial) sphere, ordered bottom -> top.

    lat_range is (top_lat, bottom_lat), latitude measured from the north
    pole (0 = top, pi = bottom); y = y0 + radius*cos(lat)."""
    top, bot = lat_range
    phi = np.linspace(bot, top, n)
    return np.stack([radius * np.sin(phi), y0 + radius * np.cos(phi)], -1)


def capsule_profile(radius: float, height: float, n: int = 10):
    """Capsule (cylinder + hemispherical caps) centered at the origin,
    ordered bottom -> top."""
    h2 = height / 2.0
    phi_b = np.linspace(np.pi, np.pi / 2, n)
    bot = np.stack([radius * np.sin(phi_b),
                    -h2 + radius * np.cos(phi_b)], -1)
    phi_t = np.linspace(np.pi / 2, 0.0, n)
    top = np.stack([radius * np.sin(phi_t), h2 + radius * np.cos(phi_t)], -1)
    return np.concatenate([bot, top], 0)


def _rot_x(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float64)


def _rot_y(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float64)


def _rot_z(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float64)


def place(part, rot=None, pos=(0.0, 0.0, 0.0), s: float = 1.0,
          material: int = 0):
    """Rigid placement (+ uniform scale): rotate normals/tangents by the
    same rotation, scale positions only. Returns a new prim dict."""
    r = np.eye(3) if rot is None else np.asarray(rot, np.float64)
    p = dict(part)
    p["pos"] = (part["pos"].astype(np.float64) * s @ r.T
                + np.asarray(pos)).astype(np.float32)
    p["nrm"] = (part["nrm"].astype(np.float64) @ r.T).astype(np.float32)
    t = part["tan"][:, :3].astype(np.float64) @ r.T
    p["tan"] = np.concatenate(
        [t, part["tan"][:, 3:4].astype(np.float64)], -1).astype(np.float32)
    p["material"] = material
    return p


# ---------------------------------------------------------------------------
# textures
# ---------------------------------------------------------------------------

def _grid(size):
    y, x = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    return x / size, y / size


def _u8(a):
    return np.clip(np.asarray(a) * 255.0 + 0.5, 0, 255).astype(np.uint8)


def _normal_from_height(h, strength: float = 0.35):
    gx = np.roll(h, -1, 1) - np.roll(h, 1, 1)
    gy = np.roll(h, -1, 0) - np.roll(h, 1, 0)
    n = np.stack([-gx, -gy, np.full_like(h, strength)], -1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return _u8(n * 0.5 + 0.5)


def avocado_textures(size: int = 512):
    """(base, normal, mr) PNGs: mottled dark-green skin, bumpy, dielectric."""
    fu, fv = _grid(size)
    warp = (np.sin(2 * np.pi * (fu * 7 + 0.3 * np.sin(2 * np.pi * fv * 5)))
            * np.sin(2 * np.pi * (fv * 6 + 0.4 * np.sin(2 * np.pi * fu * 3))))
    mottle = 0.5 + 0.5 * warp
    r = 0.06 + 0.06 * mottle
    g = 0.16 + 0.14 * mottle
    b = 0.04 + 0.04 * mottle
    base = _u8(np.stack([r, g, b], -1))
    h = 0.5 * np.sin(2 * np.pi * fu * 40) * np.sin(2 * np.pi * fv * 40) \
        + 0.5 * warp
    normal = _normal_from_height(h, 0.5)
    rough = np.clip(0.55 + 0.25 * mottle, 0, 1)
    mr = _u8(np.stack([np.zeros_like(rough), rough,
                       np.zeros_like(rough)], -1))
    return tuple(png.encode_rgb(a) for a in (base, normal, mr))


def helmet_textures(size: int = 512):
    """(base, normal, mr, emissive) PNGs: scuffed olive armor + visor glow."""
    fu, fv = _grid(size)
    scratches = (np.sin(2 * np.pi * (fu * 23 + fv * 3)) > 0.93)
    panel = ((np.floor(fu * 6) + np.floor(fv * 4)) % 2)
    r = 0.32 + 0.08 * panel - 0.18 * scratches
    g = 0.30 + 0.06 * panel - 0.14 * scratches
    b = 0.22 + 0.04 * panel - 0.10 * scratches
    base = _u8(np.stack([r, g, b], -1))
    h = 0.6 * panel + 0.8 * scratches + 0.2 * np.sin(2 * np.pi * fv * 17)
    normal = _normal_from_height(h, 0.45)
    rough = np.clip(0.35 + 0.3 * panel + 0.3 * scratches, 0, 1)
    metal = np.clip(0.85 - 0.5 * scratches, 0, 1)
    mr = _u8(np.stack([np.zeros_like(rough), rough, metal], -1))
    stripe = ((fv > 0.46) & (fv < 0.54)).astype(np.float64)
    emissive = _u8(np.stack([stripe * 0.9, stripe * 0.25,
                             stripe * 0.05], -1))
    return tuple(png.encode_rgb(a) for a in (base, normal, mr, emissive))


def dress_textures(size: int = 512):
    """(base, mr) PNGs: pleated two-tone dress fabric."""
    fu, fv = _grid(size)
    pleat = 0.5 + 0.5 * np.sin(2 * np.pi * fu * 24)
    hem = (fv > 0.85).astype(np.float64)
    r = (0.25 + 0.10 * pleat) * (1 - hem) + hem * 0.85
    g = (0.30 + 0.12 * pleat) * (1 - hem) + hem * 0.80
    b = (0.55 + 0.15 * pleat) * (1 - hem) + hem * 0.75
    base = _u8(np.stack([r, g, b], -1))
    rough = np.clip(0.7 + 0.2 * pleat, 0, 1)
    mr = _u8(np.stack([np.zeros_like(rough), rough,
                       np.zeros_like(rough)], -1))
    return tuple(png.encode_rgb(a) for a in (base, mr))


# ---------------------------------------------------------------------------
# assets
# ---------------------------------------------------------------------------

def write_avocado_glb(path: str, nu: int = 96, nv: int = 64,
                      tex_size: int = 512) -> str:
    """Avocado-profile lathe body + stem nub; full PBR texture set."""
    t = np.linspace(0.0, 1.0, nv)
    # pear-ish silhouette: bulbous bottom, tapered neck; sized like the
    # Khronos Avocado sample (~0.08 units tall) so the scene's 20x scale
    # (scenes.rs:321-332) lands it at a plausible on-floor size
    r = 0.038 * (np.sin(np.pi * t) ** 0.9) * (1.0 - 0.45 * t) \
        * (1.0 + 0.35 * np.exp(-((t - 0.25) / 0.22) ** 2))
    y = -0.05 + 0.08 * t
    body = lathe(np.stack([r, y], -1), nu=nu)
    body["material"] = 0
    stem = place(lathe(sphere_profile(0.005, 8), nu=12),
                 pos=(0.0, 0.032, 0.0), material=1)
    base, normal, mr = avocado_textures(tex_size)
    materials = [
        {"name": "avocado_skin", "pbrMetallicRoughness": {
            "baseColorFactor": [1, 1, 1, 1],
            "baseColorTexture": {"index": 0},
            "metallicRoughnessTexture": {"index": 2},
            "metallicFactor": 1.0, "roughnessFactor": 1.0},
         "normalTexture": {"index": 1}},
        {"name": "avocado_stem", "pbrMetallicRoughness": {
            "baseColorFactor": [0.28, 0.2, 0.08, 1.0],
            "metallicFactor": 0.0, "roughnessFactor": 0.9}},
    ]
    return write_glb(path, [body, stem], [base, normal, mr], materials,
                     generator="tpu_raytracer_torch procgen avocado")


def write_helmet_glb(path: str, nu: int = 160, tex_size: int = 512) -> str:
    """DamagedHelmet-class: dome + visor + rim, emissive stripe texture."""
    dome = lathe(sphere_profile(1.0, 48, lat_range=(0.12, np.pi * 0.62)),
                 nu=nu)
    dome["material"] = 0
    visor = place(
        lathe(sphere_profile(1.01, 24, lat_range=(np.pi * 0.52,
                                                  np.pi * 0.78)), nu=nu),
        material=1)
    # rim band hugging the dome's lower edge (bottom -> top ordering,
    # y = +R cos(lat) like sphere_profile)
    rim = place(
        lathe(np.stack([
            [0.995 * np.sin(np.pi * 0.72), 0.995 * np.cos(np.pi * 0.72)],
            [1.045 * np.sin(np.pi * 0.70), 1.045 * np.cos(np.pi * 0.70)],
            [1.045 * np.sin(np.pi * 0.64), 1.045 * np.cos(np.pi * 0.64)],
            [0.995 * np.sin(np.pi * 0.62), 0.995 * np.cos(np.pi * 0.62)],
        ], 0), nu=nu), material=2)
    # the scene wrapper applies the reference's DamagedHelmet fix-up
    # rotation Rx(pi/2) (scenes.rs:334-347, the asset is Z-up); bake the
    # inverse so the procedural stand-in comes out upright under the SAME
    # wrapper transform a real DamagedHelmet.glb would get
    prims = [place(p, rot=_rot_x(-np.pi / 2), material=p["material"])
             for p in (dome, visor, rim)]
    base, normal, mr, emissive = helmet_textures(tex_size)
    materials = [
        {"name": "helmet_shell", "pbrMetallicRoughness": {
            "baseColorFactor": [1, 1, 1, 1],
            "baseColorTexture": {"index": 0},
            "metallicRoughnessTexture": {"index": 2},
            "metallicFactor": 1.0, "roughnessFactor": 1.0},
         "normalTexture": {"index": 1},
         "emissiveTexture": {"index": 3},
         "emissiveFactor": [1.0, 1.0, 1.0]},
        {"name": "helmet_visor", "pbrMetallicRoughness": {
            "baseColorFactor": [0.03, 0.03, 0.035, 1.0],
            "metallicFactor": 0.9, "roughnessFactor": 0.08}},
        {"name": "helmet_rim", "pbrMetallicRoughness": {
            "baseColorFactor": [0.6, 0.55, 0.45, 1.0],
            "metallicFactor": 1.0, "roughnessFactor": 0.35}},
    ]
    return write_glb(path, prims,
                     [base, normal, mr, emissive], materials,
                     generator="tpu_raytracer_torch procgen helmet")


def write_figure_glb(path: str, nu: int = 40, tex_size: int = 512) -> str:
    """VRM-class multi-primitive humanoid: 14 primitives, 5 materials.

    Matches what the reference's AliciaSolid scene exercises
    (scenes.rs:349-365): many primitives sharing a material table, a
    textured clothing material, and untextured skin/hair/eye materials.
    Proportions are stylized; the point is the loader/material path.
    """
    SKIN, DRESS, HAIR, EYE, RIBBON = range(5)
    prims = []
    # head + neck
    prims.append(place(lathe(sphere_profile(0.115, 24), nu=nu),
                       pos=(0, 1.38, 0), material=SKIN))
    prims.append(place(lathe(capsule_profile(0.035, 0.08, 8), nu=16),
                       pos=(0, 1.26, 0), material=SKIN))
    # dress: neckline to hem (lathe silhouette), flared skirt
    t = np.linspace(0.0, 1.0, 28)     # 0 = neckline, 1 = hem
    r = (0.055 + 0.065 * np.sin(np.pi * np.clip(t * 1.25, 0, 1)) ** 1.5
         + 0.16 * np.clip((t - 0.45) / 0.55, 0, 1) ** 1.6)
    y = 1.22 - 0.62 * t
    prims.append(place(lathe(np.stack([r[::-1], y[::-1]], -1), nu=nu * 2),
                       material=DRESS))
    # arms (capsules angled out) + hands
    arm = lathe(capsule_profile(0.032, 0.34, 8), nu=16)
    for side in (-1.0, 1.0):
        prims.append(place(arm, rot=_rot_z(side * 1.25),
                           pos=(side * 0.21, 1.05, 0.0), material=SKIN))
        prims.append(place(lathe(sphere_profile(0.04, 10), nu=12),
                           pos=(side * 0.385, 0.92, 0.0), material=SKIN))
    # legs
    leg = lathe(capsule_profile(0.042, 0.52, 10), nu=16)
    for side in (-1.0, 1.0):
        prims.append(place(leg, pos=(side * 0.075, 0.33, 0.0),
                           material=SKIN))
    # hair: offset cap shell + ponytail
    prims.append(place(
        lathe(sphere_profile(0.125, 20, lat_range=(0.0, np.pi * 0.62)),
              nu=nu), pos=(0, 1.395, -0.012), material=HAIR))
    prims.append(place(
        lathe(capsule_profile(0.045, 0.28, 8), nu=16),
        rot=_rot_x(0.55), pos=(0, 1.27, -0.17), material=HAIR))
    # eyes
    for side in (-1.0, 1.0):
        prims.append(place(lathe(sphere_profile(0.018, 8), nu=10),
                           pos=(side * 0.045, 1.40, 0.102), material=EYE))
    # waist ribbon band + bow knot
    prims.append(place(
        lathe(np.stack([[0.125, -0.025], [0.132, 0.0], [0.125, 0.025]], 0),
              nu=nu), pos=(0, 1.02, 0), material=RIBBON))
    prims.append(place(lathe(sphere_profile(0.035, 10), nu=12),
                       pos=(0, 1.02, 0.12), material=RIBBON))
    # feet to y=-2 in model space: the VRM scene wrapper scales by 0.5
    # (scenes.rs:349-365), putting them on the floor plane at y=-1
    prims = [place(p, pos=(0.0, -2.0, 0.0), material=p["material"])
             for p in prims]
    base, mr = dress_textures(tex_size)
    materials = [
        {"name": "skin", "pbrMetallicRoughness": {
            "baseColorFactor": [0.96, 0.80, 0.69, 1.0],
            "metallicFactor": 0.0, "roughnessFactor": 0.55}},
        {"name": "dress", "pbrMetallicRoughness": {
            "baseColorFactor": [1, 1, 1, 1],
            "baseColorTexture": {"index": 0},
            "metallicRoughnessTexture": {"index": 1},
            "metallicFactor": 0.0, "roughnessFactor": 1.0}},
        {"name": "hair", "pbrMetallicRoughness": {
            "baseColorFactor": [0.35, 0.22, 0.12, 1.0],
            "metallicFactor": 0.0, "roughnessFactor": 0.35}},
        {"name": "eye", "pbrMetallicRoughness": {
            "baseColorFactor": [0.05, 0.05, 0.08, 1.0],
            "metallicFactor": 0.0, "roughnessFactor": 0.1}},
        {"name": "ribbon", "pbrMetallicRoughness": {
            "baseColorFactor": [0.85, 0.12, 0.18, 1.0],
            "metallicFactor": 0.0, "roughnessFactor": 0.3}},
    ]
    return write_glb(path, prims, [base, mr], materials,
                     generator="tpu_raytracer_torch procgen figure")


def write_truffle_glb(path: str, nu: int = 96, tex_size: int = 256) -> str:
    """Gift-wrapped chocolate: dark truffle + bright ribbon + bow.

    Base colors straddle the luminance threshold of the truffle scene's
    material rewrite (scenes.rs:393-411): chocolate luma < 0.25 (becomes
    ultra-gloss), ribbon luma > 0.25 (becomes satin)."""
    fu, fv = _grid(tex_size)
    swirl = 0.5 + 0.5 * np.sin(2 * np.pi * (fu * 9 + 0.3 * np.sin(
        2 * np.pi * fv * 4)))
    # near-white modulation detail: the CHOCOLATE COLOR lives in the
    # baseColorFactor below, because the scene's luminance rewrite reads
    # the factor (scenes.rs:393-411) - like the real asset's dark factor
    base = _u8(np.stack([0.70 + 0.30 * swirl, 0.72 + 0.26 * swirl,
                         0.75 + 0.22 * swirl], -1))
    ball = lathe(sphere_profile(0.20, 32), nu=nu)
    ball["material"] = 0
    band = lathe(np.stack([[0.202, -0.04], [0.206, 0.0], [0.202, 0.04]], 0),
                 nu=nu)
    band_y = place(band, material=1)                      # around equator
    band_z = place(band, rot=_rot_x(np.pi / 2), material=1)
    bow = [place(lathe(sphere_profile(0.045, 10), nu=14),
                 pos=(sx * 0.05, 0.215, sz * 0.05), material=1)
           for sx, sz in ((-1, -1), (1, 1), (-1, 1), (1, -1))]
    knot = place(lathe(sphere_profile(0.035, 8), nu=12),
                 pos=(0, 0.22, 0), material=1)
    # the truffle scene wrapper lifts by 0.7 and scales by 4
    # (scenes.rs:431); center the ball at +0.025 so its world bottom
    # (0.7 + 4*(0.025 - 0.2) = 0) rests on the obsidian table
    prims = [place(p, pos=(0.0, 0.025, 0.0), material=p["material"])
             for p in [ball, band_y, band_z, knot] + bow]
    materials = [
        {"name": "chocolate", "pbrMetallicRoughness": {
            # BT.601 luma 0.215 < 0.25: the truffle rewrite's dark branch
            "baseColorFactor": [0.30, 0.19, 0.12, 1.0],
            "baseColorTexture": {"index": 0},
            "metallicFactor": 0.0, "roughnessFactor": 0.6}},
        {"name": "ribbon", "pbrMetallicRoughness": {
            "baseColorFactor": [0.88, 0.25, 0.30, 1.0],
            "metallicFactor": 0.0, "roughnessFactor": 0.5}},
    ]
    return write_glb(path, prims,
                     [png.encode_rgb(base)], materials,
                     generator="tpu_raytracer_torch procgen truffle")


_WRITERS = {
    "avocado": write_avocado_glb,
    "helmet": write_helmet_glb,
    "figure": write_figure_glb,
    "truffle": write_truffle_glb,
}

# Raised when a generator's output changes: a cached .glb from an older
# generator is stale and is written again.
ASSET_VERSION = 1


def asset_path(name: str) -> str:
    """Where the named stand-in is cached: a file of the port's own."""
    return os.path.join(MODELS_DIR, f"torch_procedural_{name}.glb")


def ensure_asset(name: str) -> str:
    """Generate the named stand-in at its defaults if it is missing or
    stale; returns its path."""
    return ensure_written(asset_path(name), _WRITERS[name], ASSET_VERSION)
