"""The upstream app's default scene: the chocolate-truffle studio of
fast-raytracing-wgpu (src/scene/scenes.rs:367-504, which src/state.rs:
57-58 opens at start). An obsidian-table floor 50x wide, a glTF
gift-wrapped chocolate lifted by 0.7, turned by 0.5 rad about y and
scaled by 4, its materials rewritten by luminance (:393-411), and a
studio of three emissive sphere lights: warm key x80, red rim x40, blue
fill x10.

The downloaded asset is not in the repository, so the generated stand-in
of `tpu_raytracer_torch/models/procedural_assets.py:write_truffle_glb`
takes its place: a dark chocolate ball, two ribbon bands, a knot and four
bow loops, with a 256^2 base-colour texture; 23,258 world triangles at
its defaults. Its mesh and texels are a frozen copy of that generator.

The program's scene definition applies the rewrite to the materials it
loads; this description hands the program a file, which its loader reads
as it is, so the file carries the rewrite's result in its material
factors: the dark chocolate at roughness 0.02, metallic 0, the bright
ribbon at roughness 0.25. The reference takes the same content as
operations (`TruffleAsset.expand`), the texture resized to 1024^2 by its
own Lanczos resize (`reference/resample.py`).
"""

from __future__ import annotations

import os

import numpy as np

from ..reference import tables
from ..reference.math3d import rotation_y, scale, translation
from ..reference.resample import resize_lanczos
from . import SceneDesc, glb, shapes

CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_cache")
# raised when the asset's content changes: a cached file of another
# version is written again
ASSET_VERSION = 1

# the stand-in's chocolate and ribbon: base colours (BT.601 luma 0.215,
# under the rewrite's threshold of 0.25, and 0.444 over it) and the factors
# the rewrite leaves them (the generator writes roughness 0.6 and 0.5)
BASE_COLORS = ((0.30, 0.19, 0.12, 1.0), (0.88, 0.25, 0.30, 1.0))
REWRITTEN = ({"roughness": 0.02, "metallic": 0.0},
             {"roughness": 0.25, "metallic": 0.0})
# the camera's default height over the app's (`describe`)
POSE_LIFT = 0.05


def _lathe(profile, nu: int):
    """A polyline profile [(r, y), ...] (bottom to top) revolved about
    +y: pos, nrm, uv, tan, idx, with the seam column doubled."""
    prof = np.asarray(profile, np.float64)
    nv = prof.shape[0]
    r, y = prof[:, 0], prof[:, 1]
    dr, dy = np.gradient(r), np.gradient(y)
    ln = np.maximum(np.hypot(dy, dr), 1e-12)
    n_rad, n_y = dy / ln, -dr / ln
    theta = np.arange(nu + 1, dtype=np.float64) * (2.0 * np.pi / nu)
    ct, st = np.cos(theta)[None, :], np.sin(theta)[None, :]
    px, pz = r[:, None] * ct, r[:, None] * st
    py = np.broadcast_to(y[:, None], px.shape)
    pole = np.abs(r[:, None]) < 1e-9
    nx = np.where(pole, 0.0, n_rad[:, None] * ct)
    nz = np.where(pole, 0.0, n_rad[:, None] * st)
    ny = np.broadcast_to(n_y[:, None], nx.shape)
    uu = (theta / (2.0 * np.pi))[None, :].repeat(nv, 0)
    seg = np.concatenate([[0.0], np.cumsum(np.hypot(np.diff(r),
                                                    np.diff(y)))])
    vv = (seg / max(seg[-1], 1e-12))[:, None].repeat(nu + 1, 1)
    nrm = np.stack([nx, ny, nz], -1)
    nrm /= np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-12)
    tan = np.stack([-st.repeat(nv, 0), np.zeros_like(px.reshape(nv, -1)),
                    ct.repeat(nv, 0)], -1).reshape(-1, 3)
    cols = nu + 1
    ii, jj = np.meshgrid(np.arange(nv - 1), np.arange(nu), indexing="ij")
    a, b = ii * cols + jj, ii * cols + jj + 1
    c, d = (ii + 1) * cols + jj + 1, (ii + 1) * cols + jj
    idx = np.concatenate([np.stack([a, c, b], -1).reshape(-1, 3),
                          np.stack([a, d, c], -1).reshape(-1, 3)], 0)
    return {"pos": np.stack([px, py, pz], -1).reshape(-1, 3)
            .astype(np.float32),
            "nrm": nrm.reshape(-1, 3).astype(np.float32),
            "uv": np.stack([uu, vv], -1).reshape(-1, 2).astype(np.float32),
            "tan": np.concatenate([tan, np.ones((tan.shape[0], 1))], -1)
            .astype(np.float32),
            "idx": idx.reshape(-1).astype(np.uint32)}


def _sphere_profile(radius: float, n: int):
    phi = np.linspace(np.pi, 0.0, n)
    return np.stack([radius * np.sin(phi), radius * np.cos(phi)], -1)


def _place(part, material: int, rot=None, pos=(0.0, 0.0, 0.0)):
    """A part turned by `rot` (normals and tangents too) and moved."""
    r = np.eye(3) if rot is None else np.asarray(rot, np.float64)
    t = part["tan"][:, :3].astype(np.float64) @ r.T
    return {**part,
            "pos": (part["pos"].astype(np.float64) @ r.T
                    + np.asarray(pos)).astype(np.float32),
            "nrm": (part["nrm"].astype(np.float64) @ r.T).astype(np.float32),
            "tan": np.concatenate([t, part["tan"][:, 3:4].astype(np.float64)],
                                  -1).astype(np.float32),
            "material": material}


def truffle_prims(nu: int) -> list:
    """The stand-in's 8 primitives in file order: the ball (material 0),
    then the two bands, the knot and the four bow loops (material 1)."""
    c, s = np.cos(np.pi / 2), np.sin(np.pi / 2)
    rot_x = np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float64)
    band = _lathe(np.stack([[0.202, -0.04], [0.206, 0.0], [0.202, 0.04]], 0),
                  nu)
    parts = [_place(_lathe(_sphere_profile(0.20, 32), nu), 0),
             _place(band, 1), _place(band, 1, rot=rot_x),
             _place(_lathe(_sphere_profile(0.035, 8), 12), 1,
                    pos=(0, 0.22, 0))]
    parts += [_place(_lathe(_sphere_profile(0.045, 10), 14), 1,
                     pos=(sx * 0.05, 0.215, sz * 0.05))
              for sx, sz in ((-1, -1), (1, 1), (-1, 1), (1, -1))]
    # the ball's bottom on the table: 0.7 + 4 (0.025 - 0.2) = 0
    return [_place(p, p["material"], pos=(0.0, 0.025, 0.0)) for p in parts]


def truffle_texture(size: int) -> np.ndarray:
    """The base colour, RGB uint8 [size, size, 3]: a near-white swirl (the
    chocolate's colour is in its factor)."""
    y, x = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    fu, fv = x / size, y / size
    swirl = 0.5 + 0.5 * np.sin(2 * np.pi * (fu * 9 + 0.3 * np.sin(
        2 * np.pi * fv * 4)))
    rgb = np.stack([0.70 + 0.30 * swirl, 0.72 + 0.26 * swirl,
                    0.75 + 0.22 * swirl], -1)
    return np.clip(rgb * 255.0 + 0.5, 0, 255).astype(np.uint8)


def prepared_texture(img: np.ndarray) -> np.ndarray:
    """A colour image at another size as the scene's texture array holds
    it (the published app's PIL path): decoded from sRGB, truncated to
    8 bits, Lanczos-resized to 1024^2 and scaled to [0, 1]. Linear
    already, so the texture array takes it as it is."""
    lin = tables._srgb_to_linear(np.asarray(img)[:, :, :3])
    u8 = (np.clip(lin, 0, 1) * 255).astype(np.uint8)
    size = tables.TEXTURE_SIZE
    return resize_lanczos(u8, size, size).astype(np.float32) / 255.0


class TruffleAsset:
    """The stand-in as a glTF file with the rewrite's factors (`path`, for
    the program) and as scene operations (`expand`, for the reference),
    placed by `transform`."""

    def __init__(self, transform, nu: int, texture_size: int):
        self.transform = np.asarray(transform, np.float32)
        self.nu, self.texture_size = nu, texture_size
        self.path = os.path.join(CACHE_DIR,
                                 f"truffle_{nu}_{texture_size}.glb")

    def ensure(self) -> str:
        """Write the .glb unless this version of it is there; its path."""
        stamp = self.path + ".version"
        try:
            with open(stamp) as f:
                fresh = f.read().strip() == str(ASSET_VERSION)
        except OSError:
            fresh = False
        if not (fresh and os.path.exists(self.path)):
            materials = [
                {"name": name, "pbrMetallicRoughness": {
                    "baseColorFactor": list(color),
                    **({"baseColorTexture": {"index": 0}} if i == 0
                       else {}),
                    "metallicFactor": f["metallic"],
                    "roughnessFactor": f["roughness"]}}
                for i, (name, color, f) in enumerate(zip(
                    ("chocolate", "ribbon"), BASE_COLORS, REWRITTEN))]
            glb.write_glb(self.path, truffle_prims(self.nu),
                          [glb.encode_rgb(truffle_texture(
                              self.texture_size))], materials)
            with open(stamp, "w") as f:
                f.write(str(ASSET_VERSION))
        return self.path

    def expand(self) -> list:
        """The asset as scene operations, in the order a glTF loader
        registers it after the floor: the base colour (colour texture 3),
        the chocolate and ribbon materials (1, 2), the 8 meshes (2-9) and
        an instance of each."""
        ops = [("color_texture",
                prepared_texture(truffle_texture(self.texture_size)), True)]
        for i, (color, f) in enumerate(zip(BASE_COLORS, REWRITTEN)):
            ops.append(("material", {"base_color": color, **f,
                                     **({"tex_id": 3} if i == 0 else {})}))
        prims = truffle_prims(self.nu)
        for p in prims:
            nrm = p["nrm"].astype(np.float32)
            nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True),
                              1e-12)
            ops.append(("mesh", {"positions": p["pos"], "oct_normals":
                                 shapes.oct_encode_np(nrm), "uvs": p["uv"],
                                 "tangents": p["tan"], "indices": p["idx"]}))
        ops += [("instance", 2 + i, 1 + p["material"], self.transform)
                for i, p in enumerate(prims)]
        return ops


def describe(config: dict) -> SceneDesc:
    """The studio in the definition's order of registration. The floor's
    `.roughness(0.1).metallic(0.8)`: the fluent `metallic(r)` sets
    metallic 1 and roughness r (material.rs), so it is metallic at
    roughness 0.8.

    The camera is the app's default pose, (0, 0, 3) looking down -z,
    raised by POSE_LIFT: the app's eye sits 0.01 above the table top,
    and a start pose drawn up to 0.05 below it (`drive.POSE_JITTER`)
    would look from under the table."""
    ops = [("mesh", shapes.create_plane()), ("mesh", shapes.create_sphere(4)),
           ("material", {"base_color": (0.02, 0.02, 0.02, 1.0),
                         "roughness": 0.8, "metallic": 1.0}),
           ("instance", 0, 0, translation([0, -0.01, 0]) @ scale(50.0)),
           ("gltf", TruffleAsset(
               translation([0, 0.7, 0]) @ rotation_y(0.5) @ scale(4.0),
               config["asset_nu"], config["texture_size"])),
           ("sphere_light", 1, translation([8.0, 4.0, 2.0]) @ scale(2.0),
            [1.0, 0.95, 0.8], 80.0),
           ("sphere_light", 1, translation([-3.0, 2.0, -4.0]) @ scale(2.0),
            [1.0, 0.05, 0.01], 40.0),
           ("sphere_light", 1, translation([-3.0, 1.0, 3.0]) @ scale(1.0),
            [0.01, 0.05, 0.2], 10.0)]
    return SceneDesc(ops, {"position": [0.0, POSE_LIFT, 3.0],
                           "yaw": float(np.radians(-90.0)), "pitch": 0.0})
