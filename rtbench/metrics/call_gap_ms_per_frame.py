"""call_gap_ms_per_frame: idle milliseconds a frame of the busiest card
outside every frame's interval while one of the program's host spans
(`tpu_raytracer_torch/utils/profiling.py:SPANS`: the camera's update and
upload, the frame call's inputs, replays and outputs) was open, the
spans moved onto the trace's clock by the offset that puts every replay
span around its graph launch (`rtbench/stages.py`). What is left of the
idle after this and graph_gap_ms_per_frame is the caller's own time.
Layer: frame graph. Moves fps."""

from rtbench import stages


def read(run):
    if run.trace is None:
        return None
    return stages.call_gap_ms(run.trace, stages.program_spans())
