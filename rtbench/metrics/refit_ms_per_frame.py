"""refit_ms_per_frame: device milliseconds a frame of the stage "refit",
the in-place refit of the moved instances inside the graph
(`ops/refit.py:update_instances_`), summed over the cards: every kernel
and copy from the program's mark `tpurt_mark_refit` to the next mark
(`rtbench/stages.py`). Layer: frame pipeline. Moves fps."""

from rtbench import stages


def read(run):
    return stages.stage_ms(run.trace, "refit")
