"""The program's scene from a description: each operation made on the
program's `SceneBuilder`, and a glTF asset loaded by the program's own
loader (`scene/loader.py:load_gltf`, `models/scenes.py:
add_gltf_to_builder`)."""

from __future__ import annotations

import numpy as np


def build(desc, device, kernel: str, brute_max=None, incull: bool = False):
    from tpu_raytracer_torch.models.scenes import add_gltf_to_builder
    from tpu_raytracer_torch.scene.builder import SceneBuilder
    from tpu_raytracer_torch.scene.geometry import Mesh
    from tpu_raytracer_torch.scene.loader import load_gltf
    from tpu_raytracer_torch.scene.material import Material

    fields = {"roughness": "roughness_", "metallic": "metallic_",
              "transmission": "transmission_", "ior": "ior_",
              "light_index": "light_index_"}
    b = SceneBuilder()
    for op in desc.ops:
        kind, args = op[0], op[1:]
        if kind == "mesh":
            b.add_mesh(Mesh(**args[0]))
        elif kind == "material":
            b.add_material(Material(**{fields.get(k, k): v
                                       for k, v in args[0].items()}))
        elif kind == "instance":
            b.add_instance(args[0], args[1], np.asarray(args[2], np.float32))
        elif kind == "quad_light":
            b.register_quad_light(args[0], np.asarray(args[1], np.float32),
                                  *args[2:])
        elif kind == "sphere_light":
            b.register_sphere_light(args[0], np.asarray(args[1], np.float32),
                                    *args[2:])
        elif kind == "color_texture":
            b.add_color_texture(args[0], srgb=args[1])
        elif kind == "data_texture":
            b.add_data_texture(args[0])
        elif kind == "gltf":
            asset = args[0]
            meshes, materials, images, mat_indices = load_gltf(asset.ensure())
            add_gltf_to_builder(b, meshes, materials, images, mat_indices,
                                asset.transform)
        else:
            raise ValueError(f"unknown scene operation {kind!r}")
    return b.build(device, kernel=kernel, incull=incull, brute_max=brute_max)
