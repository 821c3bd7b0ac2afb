"""graph_gap_ms_per_frame: idle milliseconds a frame inside the
replayed frames on the busiest card: each frame's interval, from its
first stage mark to the `end` mark that closes its `state_copy`, less
the union of its kernels and copies (`rtbench/stages.py`). The gaps
between the graph's own nodes. Layer: frame graph. Moves fps."""

from rtbench import stages


def read(run):
    return stages.graph_gap_ms(run.trace)
