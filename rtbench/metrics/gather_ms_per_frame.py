"""gather_ms_per_frame: device milliseconds a frame of the table gather
K7 (`csrc/gather.cu`), by kernel name. Layer: table gather. Moves fps."""

import re

NAMES = re.compile(r"\bgather_kernel\b")


def read(run):
    t = run.trace
    if t is None or t.frames == 0:
        return None
    ms = sum(b - a for n, _, a, b in t.kernels if NAMES.search(n)) * 1e3
    return ms / t.frames if ms > 0 else None
