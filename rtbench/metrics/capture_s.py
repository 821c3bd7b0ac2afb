"""capture_s: seconds from the frame graph's construction to the end of
set-up's frames, in which every graph the window reaches is captured
(each after its eager warm-up frames). Layer: frame graph. Moves
setup_s."""


def read(run):
    return run.spans.get("capture_s")
