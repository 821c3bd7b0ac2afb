"""Checkpoint / resume for long progressive accumulations
(`tpu_raytracer/render/checkpoint.py`, less its orbax backend).

The state that resumes a render - camera pose, frame_count, the
accumulation buffer, the packed G-buffer and ReSTIR reservoirs - is a
dict of arrays, saved as a compressed .npz in the reference's format: a
`meta` JSON (packed-row layout, frame count, camera) and the arrays
`gb`, `res` and `accum`. Either package loads the other's file.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..ops.gbuffer import GB_COLS
from ..ops.restir import RES_COLS

FORMAT = {"gb_cols": GB_COLS, "res_cols": RES_COLS}


def save(path: str, state: dict, frame_count: int,
         camera_state: dict) -> None:
    """Write the frame state (tensors on any device, or numpy arrays),
    the frame count and the camera pose.

    camera_state: {"position": [3], "yaw": f, "pitch": f,
                   "prev_view_proj": [4,4] or None}
    """
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    meta = {
        "format": FORMAT,
        "frame_count": int(frame_count),
        "camera": {
            "position": np.asarray(camera_state["position"]).tolist(),
            "yaw": float(camera_state["yaw"]),
            "pitch": float(camera_state["pitch"]),
            "prev_view_proj": (
                None if camera_state.get("prev_view_proj") is None
                else np.asarray(camera_state["prev_view_proj"]).tolist()),
        },
    }
    arrays = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                  else np.asarray(v)) for k, v in state.items()}
    np.savez_compressed(path, meta=json.dumps(meta), **arrays)


def load(path: str) -> tuple:
    """Returns (state dict of numpy arrays, frame_count, camera_state).

    Raises ValueError on a checkpoint whose packed-row layout is not this
    build's (e.g. 8-column reservoirs from before the reference's dedup),
    rather than let a clamped slice surface later as an unrelated shape
    error."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        state = {k: z[k] for k in z.files if k != "meta"}
    fmt = meta.get("format")
    if fmt != FORMAT:
        raise ValueError(
            f"checkpoint {path!r} has packed-row format {fmt} but this "
            f"build expects {FORMAT} - it was written by an incompatible "
            "version; re-render rather than resuming")
    cam = meta["camera"]
    camera_state = {
        "position": np.asarray(cam["position"], np.float32),
        "yaw": cam["yaw"],
        "pitch": cam["pitch"],
        "prev_view_proj": (None if cam["prev_view_proj"] is None
                           else np.asarray(cam["prev_view_proj"], np.float32)),
    }
    return state, meta["frame_count"], camera_state
