"""png_save_s: host seconds from `ScreenshotSaver.submit` returning to the
saver's thread finishing the file (sRGB, the PNG's zlib, the write),
median over the run's screenshots but set-up's (`rtbench/shots.py`).
Layer: screenshot. Moves screenshot_s."""


def read(run):
    return run.spans.get("png_save_s")
