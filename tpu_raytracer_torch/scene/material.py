"""Material model.

Mirrors the reference's 64-byte GPU material (src/scene/material.rs:1-28) but
keeps logical fields unpacked: texture ids are plain int32 lanes in a SoA
material table. Host-side numpy, as `tpu_raytracer/scene/material.py`, with
the fluent setters the ported scenes use.

Texture id sentinel: ``NO_TEXTURE`` (= 0xFFFF, material.rs:41-44).
"""

from __future__ import annotations

import dataclasses

import numpy as np

NO_TEXTURE = 0xFFFF


@dataclasses.dataclass
class Material:
    """Fluent builder matching material.rs:31-161 semantics."""

    base_color: tuple = (1.0, 1.0, 1.0, 1.0)
    emissive_factor: tuple = (0.0, 0.0, 0.0)
    roughness_: float = 0.5
    metallic_: float = 0.0
    transmission_: float = 0.0
    ior_: float = 1.0
    light_index_: int = -1
    tex_id: int = NO_TEXTURE               # base color   (color array)
    normal_tex_id: int = NO_TEXTURE        # normal map   (data array)
    occlusion_tex_id: int = NO_TEXTURE     # occlusion    (data array)
    emissive_tex_id: int = NO_TEXTURE      # emissive     (color array)
    metallic_roughness_tex_id: int = NO_TEXTURE  # MR      (data array)

    # --- fluent builders (material.rs:49-111,158-161) ---
    def light_index(self, index: int) -> "Material":
        self.light_index_ = index
        return self

    def metallic(self, roughness: float) -> "Material":
        self.metallic_ = 1.0
        self.roughness_ = roughness
        return self

    def roughness(self, roughness: float) -> "Material":
        self.roughness_ = roughness
        return self

    def glass(self, ior: float) -> "Material":
        self.metallic_ = 0.0
        self.roughness_ = 0.0
        self.ior_ = ior
        self.transmission_ = 1.0
        return self

    def emissive(self, factor) -> "Material":
        self.emissive_factor = tuple(factor)
        return self

    def texture(self, tex_id: int) -> "Material":
        self.tex_id = int(tex_id)
        return self

    def normal_texture(self, tex_id: int) -> "Material":
        self.normal_tex_id = int(tex_id)
        return self

    def occlusion_texture(self, tex_id: int) -> "Material":
        self.occlusion_tex_id = int(tex_id)
        return self

    def emissive_texture(self, tex_id: int) -> "Material":
        self.emissive_tex_id = int(tex_id)
        return self

    def metallic_roughness_texture(self, tex_id: int) -> "Material":
        self.metallic_roughness_tex_id = int(tex_id)
        return self


def pack_materials(materials: list) -> dict:
    """Pack a material list into SoA numpy arrays (the device-side table).

    Layout replaces the reference's byte-packed struct with flat lanes:
      base_color [M,4] f32, emissive [M,3] f32, scalars [M] f32,
      light_index [M] i32, tex ids [M] i32 (NO_TEXTURE sentinel kept).
    """
    m = max(len(materials), 1)
    out = {
        "base_color": np.ones((m, 4), np.float32),
        "emissive_factor": np.zeros((m, 3), np.float32),
        "roughness": np.full((m,), 0.5, np.float32),
        "metallic": np.zeros((m,), np.float32),
        "transmission": np.zeros((m,), np.float32),
        "ior": np.ones((m,), np.float32),
        "light_index": np.full((m,), -1, np.int32),
        "tex_id": np.full((m,), NO_TEXTURE, np.int32),
        "normal_tex_id": np.full((m,), NO_TEXTURE, np.int32),
        "occlusion_tex_id": np.full((m,), NO_TEXTURE, np.int32),
        "emissive_tex_id": np.full((m,), NO_TEXTURE, np.int32),
        "metallic_roughness_tex_id": np.full((m,), NO_TEXTURE, np.int32),
    }
    for i, mat in enumerate(materials):
        out["base_color"][i] = mat.base_color
        out["emissive_factor"][i] = mat.emissive_factor
        out["roughness"][i] = mat.roughness_
        out["metallic"][i] = mat.metallic_
        out["transmission"][i] = mat.transmission_
        out["ior"][i] = mat.ior_
        out["light_index"][i] = mat.light_index_
        out["tex_id"][i] = mat.tex_id
        out["normal_tex_id"][i] = mat.normal_tex_id
        out["occlusion_tex_id"][i] = mat.occlusion_tex_id
        out["emissive_tex_id"][i] = mat.emissive_tex_id
        out["metallic_roughness_tex_id"][i] = mat.metallic_roughness_tex_id
    return out
