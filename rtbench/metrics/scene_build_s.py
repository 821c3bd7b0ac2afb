"""scene_build_s: seconds of the scene's construction in set-up (the
harness's clock around the description and `SceneBuilder.build`, the
glTF loader's read included). Layer: scene set-up. Moves setup_s."""


def read(run):
    return run.spans.get("scene_build_s")
