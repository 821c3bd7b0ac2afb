"""host_launches_per_frame: the host's calls that hand the device work
(graph launches, kernel launches, copies and sets) in the traced frames,
over the frames. Layer: frame graph. Moves fps."""


def read(run):
    if run.trace is None or run.trace.frames == 0:
        return None
    return len(run.trace.launches) / run.trace.frames
