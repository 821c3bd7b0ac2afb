"""Nothing the benchmark runs loads JAX or the JAX package, by the
top-level name of each module compared whole."""

import subprocess
import sys

from rtbench import run


def test_top_level_names_compared_whole():
    assert run.forbidden_modules(["tpu_raytracer_torch.ops.trace_api",
                                  "numpy", "rtbench.run"]) == []
    assert run.forbidden_modules(["tpu_raytracer.ops"]) == ["tpu_raytracer"]
    assert run.forbidden_modules(["jaxlib.xla_client", "jax",
                                  "flax.linen"]) == ["flax", "jax", "jaxlib"]
    assert run.forbidden_modules(["jaxtyping", "tpu_raytracer_x"]) == []


def test_a_run_loads_no_jax():
    """Every module a run imports, in a fresh process."""
    code = (
        "import sys\n"
        "import rtbench.run, rtbench.check, rtbench.profile\n"
        "import rtbench.scenes.port, rtbench.scenes.cornell\n"
        "import rtbench.scenes.knot, rtbench.reference.lower\n"
        "from rtbench import cells\n"
        "import json\n"
        "bench = json.load(open('BENCHMARK.json'))\n"
        "[cells.metric_reader(m['name']) for m in bench['per_layer']]\n"
        "import tpu_raytracer_torch.render.graph\n"
        "import tpu_raytracer_torch.scene.loader\n"
        "import tpu_raytracer_torch.models.scenes\n"
        "import tpu_raytracer_torch.render.renderer\n"
        "import tpu_raytracer_torch.render.camera\n"
        "print(rtbench.run.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=_root())
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


def _root():
    import os
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
