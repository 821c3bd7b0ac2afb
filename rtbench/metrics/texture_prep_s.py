"""texture_prep_s: host seconds the program's scene builder spent in
set-up preparing the scene's textures (`SceneBuilder.add_color_texture`
and `add_data_texture`: the sRGB decode, and the Lanczos resize of an
image that is not 1024^2), summed over the run's process, as the program
records it (`tpu_raytracer_torch/utils/profiling.py:SETUP`). None where
the program keeps no such record. Layer: scene set-up. Moves setup_s."""


def read(run):
    try:
        from tpu_raytracer_torch.utils import profiling
    except ImportError:
        return None
    value = getattr(profiling, "SETUP", {}).get("texture_prep")
    return None if value is None else float(value)
