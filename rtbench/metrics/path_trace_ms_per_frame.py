"""path_trace_ms_per_frame: device milliseconds a frame of the stage
"path_trace", the path tracer (`ops/path_trace.py:trace_path`), both of
the frame's calls: the temporal candidates and the spatial winners'
replay, summed over the cards: every kernel and copy from the program's
mark `tpurt_mark_path_trace` to the next mark (`rtbench/stages.py`).
Layer: frame pipeline. Moves fps."""

from rtbench import stages


def read(run):
    return stages.stage_ms(run.trace, "path_trace")
