"""restir_spatial_ms_per_frame: device milliseconds a frame of the stage
"restir_spatial", ReSTIR's spatial reuse: the G-buffer and reservoir
packs, the taps and their visibility, the finalize
(`ops/restir.py:restir_spatial`), less its path trace, summed over the
cards: every kernel and copy from the program's mark
`tpurt_mark_restir_spatial` to the next mark (`rtbench/stages.py`).
Layer: frame pipeline. Moves fps."""

from rtbench import stages


def read(run):
    return stages.stage_ms(run.trace, "restir_spatial")
