"""device_idle_pct: 100 less the union of kernel, copy and set intervals
over the traced window, on the busiest device, in %. Layer: device.
Moves fps."""

from rtbench import profile


def read(run):
    if run.trace is None:
        return None
    return profile.busiest_idle_share(run.trace)
