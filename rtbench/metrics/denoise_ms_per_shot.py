"""denoise_ms_per_shot: device milliseconds of the screenshot's denoise
(`app/screenshot.py:denoised_screenshot`: the G-buffer unpack and the
a-trous levels of `ops/denoise.py`) in the traced stretch's one shot:
every kernel and copy on the card after the shot's frame was waited for
and before the device-to-host copy of the image. The shot's frame is
traced frame `phase` of the traffic's `screenshot` schedule; it ends at
the `tpurt_mark_end` that closes its `state_copy` (`rtbench/stages.py`),
and it was waited for when the first synchronize call of the host that
ends after that returned. Only the harness's trace is read: its marks,
its runtime calls and its operations. Layer: screenshot. Moves
screenshot_s."""

from rtbench import stages

SYNC = "Synchronize"
TO_HOST = "DtoH"


def shot_ops(trace, phase: int):
    """(device, [(start, end)]) of the denoise's operations, or None."""
    if not stages.has_marks(trace) or phase >= trace.frames:
        return None
    for dev in trace.devices():
        owned, frames = stages.walk(trace, dev)
        if len(frames) > phase:
            break
    else:
        return None
    lo = frames[phase][1]
    waited = [b for name, _, b in trace.host if SYNC in name and b >= lo]
    if waited:
        lo = min(waited)
    ops = sorted((a, b, n) for n, d, a, b in trace.kernels + trace.copies
                 if d == dev and a >= lo)
    for i, (a, _, name) in enumerate(ops):
        if TO_HOST in name:
            return dev, [(x, y) for x, y, _ in ops[:i]]
    return None


def read(run):
    shot = run.cell.traffic.get("screenshot")
    if run.trace is None or shot is None:
        return None
    found = shot_ops(run.trace, shot["phase"])
    if not found or not found[1]:
        return None
    return 1e3 * sum(b - a for a, b in found[1])
