"""glTF 2.0 loader (src/scene/loader.rs; `tpu_raytracer/scene/loader.py`).

Reads .gltf (JSON with external or data-URI buffers and images) and .glb
(binary container): one Mesh per primitive with positions, oct-encoded
normals, uvs and tangents, accessors with byte strides and normalised
integer components, indices widened to u32 (a primitive without indices
takes 0..N-1), and PBR metallic-roughness materials with base-color,
normal, occlusion, emissive and MR texture indices plus the
KHR_materials_transmission and KHR_materials_ior extensions. Images
decode to RGBA uint8 through `utils/png.py` or `utils/jpeg.py`, the two
formats core glTF 2.0 allows, chosen by the stream's magic bytes.

Returns (meshes, materials, images, material_indices) as the reference
does; texture ids in the materials index `images` and are remapped to
the scene's texture arrays by `models/scenes.py:add_gltf_to_builder`.
"""

from __future__ import annotations

import base64
import json
import os
import struct

import numpy as np

from ..utils import jpeg, png
from .geometry import Mesh, oct_encode_np
from .material import Material

_COMPONENT_DTYPE = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16,
    5123: np.uint16, 5125: np.uint32, 5126: np.float32,
}
_TYPE_SIZE = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}
_GLB_MAGIC = 0x46546C67
_JSON, _BIN = 0x4E4F534A, 0x004E4942


def _load_glb(path: str):
    with open(path, "rb") as f:
        magic, _version, _length = struct.unpack("<III", f.read(12))
        if magic != _GLB_MAGIC:
            raise ValueError(f"{path} is not a .glb file")
        gltf = None
        buffers = []
        while True:
            header = f.read(8)
            if len(header) < 8:
                break
            chunk_len, chunk_type = struct.unpack("<II", header)
            data = f.read(chunk_len)
            if chunk_type == _JSON:
                gltf = json.loads(data.decode("utf-8"))
            elif chunk_type == _BIN:
                buffers.append(data)
    if gltf is None:
        raise ValueError(f"{path} has no JSON chunk")
    return gltf, buffers


def _uri_bytes(uri: str, base_dir: str) -> bytes:
    if uri.startswith("data:"):
        return base64.b64decode(uri.split(",", 1)[1])
    with open(os.path.join(base_dir, uri), "rb") as f:
        return f.read()


def _load_buffers(gltf: dict, base_dir: str, glb_buffers: list) -> list:
    return [glb_buffers[i] if buf.get("uri") is None
            else _uri_bytes(buf["uri"], base_dir)
            for i, buf in enumerate(gltf.get("buffers", []))]


def _read_accessor(gltf: dict, buffers: list, accessor_idx: int) -> np.ndarray:
    acc = gltf["accessors"][accessor_idx]
    view = gltf["bufferViews"][acc["bufferView"]]
    dtype = _COMPONENT_DTYPE[acc["componentType"]]
    ncomp = _TYPE_SIZE[acc["type"]]
    count = acc["count"]
    offset = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
    data = buffers[view["buffer"]]
    item = np.dtype(dtype).itemsize * ncomp
    stride = view.get("byteStride") or item
    raw = np.frombuffer(data, np.uint8, count * stride - (stride - item),
                        offset)
    if stride == item:
        arr = raw.view(dtype).reshape(count, ncomp)
    else:
        arr = np.lib.stride_tricks.as_strided(
            raw, (count, item), (stride, 1)
        ).copy().view(dtype).reshape(count, ncomp)
    if acc.get("normalized") and dtype != np.float32:
        arr = arr.astype(np.float32) / np.iinfo(dtype).max
    return np.array(arr)


def decode_image(data: bytes) -> np.ndarray:
    """PNG or JPEG bytes -> RGBA uint8 [H, W, 4], the decoder chosen by
    the magic bytes; ValueError naming anything else."""
    if data[:4] == b"\x89PNG":
        return png.decode(data)
    if data[:2] == b"\xff\xd8":
        return jpeg.decode(data)
    raise ValueError(f"image stream starting {bytes(data[:8])!r} is neither "
                     f"PNG nor JPEG")


def _decode_image(gltf: dict, buffers: list, base_dir: str,
                  image_idx: int) -> np.ndarray:
    img = gltf["images"][image_idx]
    if "uri" in img:
        return decode_image(_uri_bytes(img["uri"], base_dir))
    view = gltf["bufferViews"][img["bufferView"]]
    off = view.get("byteOffset", 0)
    return decode_image(
        buffers[view["buffer"]][off:off + view["byteLength"]])


def _tex_image(gltf: dict, tex_idx: int) -> int:
    return gltf["textures"][tex_idx]["source"]


def load_gltf(path: str):
    """Returns (meshes, materials, images, material_indices): one Mesh per
    glTF primitive; material_indices[i] is primitive i's material slot
    (loader.rs:9-12)."""
    base_dir = os.path.dirname(path)
    if path.endswith(".glb"):
        gltf, glb_buffers = _load_glb(path)
    else:
        with open(path) as f:
            gltf = json.load(f)
        glb_buffers = []
    buffers = _load_buffers(gltf, base_dir, glb_buffers)

    # materials (loader.rs:59-99); texture ids point into `images`
    materials = []
    for m in gltf.get("materials", [{}]):
        pbr = m.get("pbrMetallicRoughness", {})
        mat = Material(tuple(pbr.get("baseColorFactor", [1.0, 1.0, 1.0, 1.0])))
        mat.roughness_ = float(pbr.get("roughnessFactor", 1.0))
        mat.metallic_ = float(pbr.get("metallicFactor", 1.0))
        mat.emissive_factor = tuple(m.get("emissiveFactor", [0, 0, 0]))
        ext = m.get("extensions", {})
        if "KHR_materials_transmission" in ext:
            mat.transmission_ = float(ext["KHR_materials_transmission"].get(
                "transmissionFactor", 0.0))
        if "KHR_materials_ior" in ext:
            mat.ior_ = float(ext["KHR_materials_ior"].get("ior", 1.5))
        if "baseColorTexture" in pbr:
            mat.texture(_tex_image(gltf, pbr["baseColorTexture"]["index"]))
        if "metallicRoughnessTexture" in pbr:
            mat.metallic_roughness_texture(
                _tex_image(gltf, pbr["metallicRoughnessTexture"]["index"]))
        if "normalTexture" in m:
            mat.normal_texture(_tex_image(gltf, m["normalTexture"]["index"]))
        if "occlusionTexture" in m:
            mat.occlusion_texture(
                _tex_image(gltf, m["occlusionTexture"]["index"]))
        if "emissiveTexture" in m:
            mat.emissive_texture(
                _tex_image(gltf, m["emissiveTexture"]["index"]))
        materials.append(mat)

    images = [_decode_image(gltf, buffers, base_dir, i)
              for i in range(len(gltf.get("images", [])))]

    # meshes: one Mesh per primitive (loader.rs:106-177)
    meshes, mat_indices = [], []
    for gmesh in gltf.get("meshes", []):
        for prim in gmesh.get("primitives", []):
            attrs = prim["attributes"]
            positions = _read_accessor(gltf, buffers, attrs["POSITION"]
                                       ).astype(np.float32)
            count = len(positions)
            if "NORMAL" in attrs:
                normals = _read_accessor(gltf, buffers, attrs["NORMAL"])
            else:
                normals = np.tile([0.0, 1.0, 0.0], (count, 1))
            normals = normals.astype(np.float32)
            normals /= np.maximum(
                np.linalg.norm(normals, axis=1, keepdims=True), 1e-12)
            if "TEXCOORD_0" in attrs:
                uvs = _read_accessor(gltf, buffers, attrs["TEXCOORD_0"]
                                     ).astype(np.float32)[:, :2]
            else:
                uvs = np.zeros((count, 2), np.float32)
            if "TANGENT" in attrs:
                tangents = _read_accessor(gltf, buffers, attrs["TANGENT"]
                                          ).astype(np.float32)
            else:
                tangents = np.tile([1.0, 0.0, 0.0, 1.0], (count, 1)
                                   ).astype(np.float32)
            if "indices" in prim:
                indices = _read_accessor(gltf, buffers, prim["indices"]
                                         ).reshape(-1).astype(np.uint32)
            else:   # non-indexed: sequential (loader.rs:170-176)
                indices = np.arange(count, dtype=np.uint32)
            meshes.append(Mesh(positions=positions[:, :3],
                               oct_normals=oct_encode_np(normals),
                               uvs=uvs, tangents=tangents, indices=indices))
            mat_indices.append(prim.get("material", 0))

    return meshes, materials, images, mat_indices
