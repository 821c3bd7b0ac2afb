"""Scene descriptions: the inputs of a configuration, made by this
package from a frozen copy of the published scene definition and handed
to both sides: to the program through its `SceneBuilder` (`port.py`) and
to the reference (`rtbench/reference/tables.py`).

A description is an ordered list of the operations a definition makes on
a scene builder, so ids come out the same on both sides:

  ("mesh", {positions, oct_normals, uvs, tangents, indices})
  ("material", {base_color, roughness, ...: `tables.MATERIAL_DEFAULTS`})
  ("instance", mesh id, material id, 4x4 transform)
  ("quad_light" | "sphere_light", mesh id, 4x4 transform, rgb, intensity)
  ("color_texture", uint8 image, srgb) / ("data_texture", uint8 image)
  ("gltf", asset): an asset file the program loads with its glTF loader;
      `asset.expand()` gives the same content as operations.

A configuration file names its scene (`"scene"`); the module of that name
here defines `describe(config) -> SceneDesc`.
"""

from __future__ import annotations

import dataclasses
import importlib


@dataclasses.dataclass
class SceneDesc:
    ops: list
    # the camera's default pose: position [3], yaw and pitch in radians
    camera: dict


def describe(config: dict) -> SceneDesc:
    """The description of the configuration's scene, found by name."""
    module = importlib.import_module(f"{__name__}.{config['scene']}")
    return module.describe(config)
