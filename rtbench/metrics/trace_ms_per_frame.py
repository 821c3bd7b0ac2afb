"""trace_ms_per_frame: device milliseconds a frame of the traversal
kernels K1/K2, K3, K4, K5, K6 and K8 (`csrc/trace*.cu`), by kernel name.
Layer: trace. Moves fps."""

import re

NAMES = re.compile(r"\b(closest_hit|any_hit|stream|inst|vpu|mxu|bvh)"
                   r"_kernel\b")


def read(run):
    t = run.trace
    if t is None or t.frames == 0:
        return None
    ms = sum(b - a for n, _, a, b in t.kernels if NAMES.search(n)) * 1e3
    return ms / t.frames if ms > 0 else None
