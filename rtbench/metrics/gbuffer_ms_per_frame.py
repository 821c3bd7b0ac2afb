"""gbuffer_ms_per_frame: device milliseconds a frame of the stage
"gbuffer", the G-buffer: the primary rays' trace and hit, or with
gb_reuse last frame's rows unpacked (`render/pipeline.py:_gb_for_band`),
summed over the cards: every kernel and copy from the program's mark
`tpurt_mark_gbuffer` to the next mark (`rtbench/stages.py`). Layer:
frame pipeline. Moves fps."""

from rtbench import stages


def read(run):
    return stages.stage_ms(run.trace, "gbuffer")
