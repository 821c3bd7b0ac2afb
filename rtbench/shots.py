"""The app's screenshot step (`tpu_raytracer_torch/app/interactive.py:run`
with `--denoise`), driven on a schedule and timed.

After the wait of each frame the schedule names, the step does what the
app does when a screenshot is asked for: the frame's packed G-buffer
rows and its HDR through `app/screenshot.py:denoised_screenshot` (the
a-trous denoiser, on the device), then `ScreenshotSaver.submit`, which
copies the image to the host and queues it for the saver's thread
(sRGB, PNG, the file written). The saver writes under a temporary
directory in TMPDIR, which `close` deletes.

A traffic mix's `screenshot` sets:
  every, phase        a shot follows window frame j where
                      j % every == phase
  denoise_iterations  the a-trous levels (`--denoise-iterations`)
  check_within        the checked shot is drawn from the seed among the
                      window's first `check_within` shots

Each shot is timed on the host clock: from the start of the step to its
return (`submit` returned), and to the saver's thread finishing the file
(its queue's `task_done`, stamped by a wrapper on the queue object; the
saver's code is the program's). A shot the saver drops (queue full) or
does not finish by the end of `wait` counts as failed.
"""

from __future__ import annotations

import glob
import os
import shutil
import statistics
import tempfile
import time

import numpy as np

# seconds past the end of the run that `wait` gives the saver
WAIT_S = 60.0


class Shots:
    def __init__(self, traffic: dict):
        from tpu_raytracer_torch.app.screenshot import ScreenshotSaver

        self.cfg = traffic["screenshot"]
        self.width, self.height = traffic["width"], traffic["height"]
        self.dir = tempfile.mkdtemp(prefix="rtbench_shots_")
        self.saver = ScreenshotSaver(self.dir)
        self.written = []      # the saver's finished files, host clock
        done = self.saver.queue.task_done

        def stamped():
            self.written.append(time.perf_counter())
            done()
        self.saver.queue.task_done = stamped
        # per shot: frame (window frame, None in set-up), label, start,
        # returned, queued (not dropped)
        self.taken = []
        self.check_index = None
        self.checked = None    # the checked shot's inputs and outputs
        self.waited = False

    def pick(self, seed: int) -> None:
        """Draw the checked shot from the seed."""
        rng = np.random.default_rng([seed, 1])
        self.check_index = int(rng.integers(0, self.cfg["check_within"]))

    def check_frame(self) -> int:
        """The window frame the checked shot follows."""
        return self.cfg["phase"] + self.check_index * self.cfg["every"]

    def denoise(self, gb_rows, hdr):
        from tpu_raytracer_torch.app.screenshot import denoised_screenshot
        return denoised_screenshot(gb_rows, hdr, self.width, self.height,
                                   self.cfg["denoise_iterations"])

    def submit(self, img, label: str) -> bool:
        return self.saver.submit(img, label)

    def take(self, frame, out) -> None:
        """The screenshot step on a frame's outputs (record, ldr, hdr,
        state, aux) once the frame has been waited for."""
        k = len(self.taken)
        label = f"shot{k:04d}"
        hdr, state = out[2], out[3]
        t0 = time.perf_counter()
        img = self.denoise(state["gb"], hdr)
        queued = self.submit(img, label)
        t1 = time.perf_counter()
        self.taken.append({"frame": frame, "label": label, "start": t0,
                           "returned": t1, "queued": queued})
        if frame is not None and frame == self.check_frame():
            self.checked = {"gb": state["gb"].clone(), "hdr": hdr.clone(),
                            "img": img, "label": label}

    def warm(self, out) -> None:
        """An untimed shot in set-up, waited for: the window's first shot
        then finds the denoiser's memory and the saver's thread warm."""
        self.take(None, out)
        self._wait_for(len(self._queued()), time.perf_counter() + WAIT_S)

    def after_frame(self, j: int, out) -> None:
        if j % self.cfg["every"] == self.cfg["phase"]:
            self.take(j, out)

    def _queued(self) -> list:
        return [s for s in self.taken if s["queued"]]

    def _wait_for(self, n: int, deadline: float) -> None:
        while len(self.written) < n and time.perf_counter() < deadline:
            time.sleep(0.01)

    def wait(self) -> None:
        """Wait for every queued shot's file, at most WAIT_S; give each
        queued shot its time written (None if not by then) and read the
        checked shot's file. Waits once; a later call returns at once."""
        if self.waited:
            return
        self.waited = True
        queued = self._queued()
        self._wait_for(len(queued), time.perf_counter() + WAIT_S)
        for s, t in zip(queued, self.written):
            s["written"] = t
        if self.checked is not None:
            shot = next(s for s in self.taken
                        if s["label"] == self.checked["label"])
            self.checked["png"] = None
            if shot.get("written") is not None:
                found = glob.glob(os.path.join(
                    self.dir, self.checked["label"] + "_*.png"))
                if len(found) == 1:
                    with open(found[0], "rb") as f:
                        self.checked["png"] = f.read()

    def failed(self) -> int:
        """Shots dropped or not written."""
        return sum(1 for s in self.taken if s.get("written") is None)

    def screenshot_s(self, frames_in_window: int):
        """Median host seconds from the step's start to the file written,
        over the shots that began inside the window (after one of its
        frames but the last) and were written; None if none was."""
        xs = [s["written"] - s["start"] for s in self.taken
              if s["frame"] is not None and s["frame"] < frames_in_window - 1
              and s.get("written") is not None]
        return statistics.median(xs) if xs else None

    def png_save_s(self):
        """Median host seconds from `submit` returning to the file
        written, over the run's written shots but set-up's."""
        xs = [s["written"] - s["returned"] for s in self.taken
              if s["frame"] is not None and s.get("written") is not None]
        return statistics.median(xs) if xs else None

    def close(self) -> None:
        shutil.rmtree(self.dir, ignore_errors=True)
