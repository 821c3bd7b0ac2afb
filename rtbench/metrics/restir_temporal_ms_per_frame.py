"""restir_temporal_ms_per_frame: device milliseconds a frame of the stage
"restir_temporal", ReSTIR's candidates and temporal reuse
(`ops/restir.py:restir_temporal`, with its halo view), less its path
trace, summed over the cards: every kernel and copy from the program's
mark `tpurt_mark_restir_temporal` to the next mark
(`rtbench/stages.py`). Layer: frame pipeline. Moves fps."""

from rtbench import stages


def read(run):
    return stages.stage_ms(run.trace, "restir_temporal")
