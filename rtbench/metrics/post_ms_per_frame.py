"""post_ms_per_frame: device milliseconds a frame of the stage "post", post
(`ops/post.py:post_process`: accumulation, tonemap), the reservoirs'
last pack and the ray count, summed over the cards: every kernel and
copy from the program's mark `tpurt_mark_post` to the next mark
(`rtbench/stages.py`). Layer: frame pipeline. Moves fps."""

from rtbench import stages


def read(run):
    return stages.stage_ms(run.trace, "post")
