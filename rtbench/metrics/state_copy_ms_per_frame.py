"""state_copy_ms_per_frame: device milliseconds a frame of the stage
"state_copy", the captured copy of the new frame state into the graph's
static state (`render/graph.py`, `parallel/tiles.py`), summed over the
cards: every kernel and copy from the program's mark
`tpurt_mark_state_copy` to the next mark (`rtbench/stages.py`). Layer:
frame pipeline. Moves fps."""

from rtbench import stages


def read(run):
    return stages.stage_ms(run.trace, "state_copy")
