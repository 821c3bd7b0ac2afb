"""shade_ms_per_frame: device milliseconds a frame of every kernel that
is none of the port's own K1-K8 (PyTorch's elementwise, reduction, index
and sort kernels of the G-buffer, ReSTIR, the path tracer, post and the
refit). Layer: frame pipeline. Moves fps."""

import re

PORT = re.compile(r"\b(closest_hit|any_hit|stream|inst|vpu|mxu|bvh|gather)"
                  r"_kernel\b")


def read(run):
    t = run.trace
    if t is None or t.frames == 0:
        return None
    ms = sum(b - a for n, _, a, b in t.kernels if not PORT.search(n)) * 1e3
    return ms / t.frames if ms > 0 else None
