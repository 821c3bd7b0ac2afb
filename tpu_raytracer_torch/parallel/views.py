"""Neighbor-readable views of flat image arrays
(`tpu_raytracer/parallel/views.py`, single-device views only).

A view covers the whole image (no halo); a read at global pixel coords
(gy, gx) returns the rows there and a mask that is False outside the
image, where the caller drops reuse for that lane.
"""

from __future__ import annotations

import dataclasses

import torch


def _index(view, gy, gx):
    """Global (gy, gx) -> (clamped flat index, inside-image mask)."""
    valid = (gy >= 0) & (gy < view.height) & (gx >= 0) & (gx < view.width)
    idx = (torch.clamp(gy, 0, view.height - 1).to(torch.int64) * view.width
           + torch.clamp(gx, 0, view.width - 1).to(torch.int64))
    return idx, valid


@dataclasses.dataclass
class View:
    """Flat [height * width, C] rows of one image-space array."""
    data: torch.Tensor
    width: int
    height: int

    def read(self, gy, gx):
        """-> (rows [R, C], valid [R])."""
        idx, valid = _index(self, gy, gx)
        return self.data[idx], valid

    def read_cols(self, gy, gx):
        """`read`, as a list of C [R] columns."""
        rows, valid = self.read(gy, gx)
        return list(rows.unbind(1)), valid

    def planes(self, channels):
        """Channels of the image as [height, width] planes."""
        img = self.data.reshape(self.height, self.width, -1)
        return [img[:, :, k] for k in channels]


@dataclasses.dataclass
class PairView:
    """A View over `cat([a, b], -1)` that never builds the concatenation."""
    a: torch.Tensor
    b: torch.Tensor
    width: int
    height: int

    def read_cols(self, gy, gx):
        idx, valid = _index(self, gy, gx)
        return list(self.a[idx].unbind(1)) + list(self.b[idx].unbind(1)), \
            valid


def trivial_view(flat, width: int, height: int) -> View:
    return View(data=flat, width=width, height=height)


def trivial_pair_view(a, b, width: int, height: int) -> PairView:
    return PairView(a=a, b=b, width=width, height=height)
