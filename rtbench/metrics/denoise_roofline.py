"""denoise_roofline: the screenshot denoise's share of its bytes roofline,
in %: the least time the denoise's bytes need at the card's memory
bandwidth (`rtbench/peaks.py`), over denoise_ms_per_shot.

The bytes are the work's, whatever kernels do it: each pixel's inputs
read once (HDR 3 f32, albedo 3 f32, octahedral normal 2 f32, world
position 3 f32) and its denoised RGB (3 f32) written once, 56 bytes a
pixel. Layer: screenshot. Moves screenshot_s."""

from rtbench import peaks

PIXEL_BYTES = 4 * (3 + 3 + 2 + 3) + 4 * 3


def denoise_bytes(width: int, height: int) -> float:
    """Bytes a shot's denoise must move at the least."""
    return float(width * height * PIXEL_BYTES)


def read(run):
    from rtbench.cells import metric_reader
    ms = metric_reader("denoise_ms_per_shot")(run)
    peak = peaks.hbm_bytes_per_s(run.device_kind)
    t = run.cell.traffic
    if ms is None or peak is None:
        return None
    bound_s = denoise_bytes(t["width"], t["height"]) / peak
    return 100.0 * bound_s / (ms * 1e-3)
