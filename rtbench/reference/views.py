"""Neighbour reads of the whole image (`tpu_raytracer/parallel/views.py`
on one device): the passes that read other pixels (temporal
reprojection, spatial ReSTIR taps, the history's bilinear taps) read
rows of a flat [height * width, C] array at pixel coordinates. A read
outside the image clamps to its edge and reports invalid, and the caller
drops that reuse."""

from __future__ import annotations

import torch


def read_cols(flat, width: int, height: int, gy, gx):
    """Rows of `flat` at pixels (gy, gx) [R], as a list of C [R] columns,
    and valid [R] (inside the image)."""
    valid = (gy >= 0) & (gy < height) & (gx >= 0) & (gx < width)
    idx = (torch.clamp(gy, 0, height - 1).to(torch.int64) * width
           + torch.clamp(gx, 0, width - 1).to(torch.int64))
    return list(flat[idx].unbind(1)), valid
