"""Screenshots: the asynchronous saver and the denoised screenshot
(`tpu_raytracer/app/screenshot.py`).

`ScreenshotSaver` mirrors the reference app's background saver thread
(state.rs:40-45, screenshot.rs): the render loop hands a frame to a queue
and keeps rendering, and a daemon thread converts it to u8 (numpy) and
writes `<out_dir>/<label>_<timestamp>.png` through the port's own PNG
encoder. `denoised_screenshot` runs the a-trous denoiser (the OIDN
analogue, ops/denoise.py) on the device before the handoff, over the
whole frame in one piece.
"""

from __future__ import annotations

import datetime
import os
import queue
import threading
import time

import numpy as np
import torch

from ..ops import denoise, gbuffer
from ..utils.image import linear_to_srgb_u8, save_png


class ScreenshotSaver:
    """Daemon worker; `submit` does not block (it drops the frame when the
    queue is full, as the reference's one-in-flight staging buffer
    does)."""

    def __init__(self, out_dir: str = "output", max_pending: int = 2):
        self.out_dir = out_dir
        self.queue: "queue.Queue" = queue.Queue(maxsize=max_pending)
        self.thread = threading.Thread(target=self._worker, daemon=True)
        self.saved = 0
        self.thread.start()

    def submit(self, img, label: str = "screenshot") -> bool:
        """img: [H, W, 3] linear HDR in [0, 1], a numpy array or a tensor
        on any device. Returns False if the queue is full (frame
        dropped)."""
        if isinstance(img, torch.Tensor):
            img = img.detach().cpu().numpy()
        try:
            self.queue.put_nowait((np.asarray(img), label))
            return True
        except queue.Full:
            return False

    def _worker(self):
        while True:
            img, label = self.queue.get()
            t0 = time.time()
            u8 = linear_to_srgb_u8(img)
            ts = datetime.datetime.now().strftime("%Y%m%d_%H%M%S_%f")
            path = os.path.join(self.out_dir, f"{label}_{ts}.png")
            save_png(path, u8)
            self.saved += 1
            print(f"saved {path} in {time.time() - t0:.3f}s")
            self.queue.task_done()

    def flush(self, timeout: float = 30.0):
        deadline = time.time() + timeout
        while not self.queue.empty() and time.time() < deadline:
            time.sleep(0.05)
        self.queue.join()


def denoised_screenshot(gb_rows, hdr_flat, width: int, height: int,
                        iterations: int = 4):
    """The screenshot path's denoise (config 5): the packed G-buffer rows
    (state["gb"], [H*W, 14]) and the frame's HDR [H*W, 3] -> [H, W, 3]
    denoised linear HDR, on their device."""
    gb = gbuffer.unpack_gb(gb_rows)
    hdr = hdr_flat.reshape(height, width, 3)
    albedo = gb["albedo"].reshape(height, width, 3)
    octn = gb["oct_normal"].reshape(height, width, 2)
    pos = gb["pos"].reshape(height, width, 3)
    return denoise.atrous_denoise(hdr, albedo, octn, pos, iterations)
