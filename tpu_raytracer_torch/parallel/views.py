"""Band/halo views: the addressing layer that makes every render pass
work the same on one device or on row bands over several
(`tpu_raytracer/parallel/views.py`).

The screen is split into horizontal row bands (row-major flat arrays
split on the leading axis are contiguous bands). Passes that read
NEIGHBOUR pixels (temporal reprojection, spatial ReSTIR taps, post
stencils, history bilinear taps) read through a `BandView`: a flat array
covering rows [y0 - halo, y0 + band_h + halo) of the full image plus the
global geometry that masks reads outside that coverage.

One device is the trivial view (y0 = 0, halo = 0, band = the whole
image), so every pass has one implementation. A read outside the halo
(a reprojection farther than the halo under fast motion) reports
invalid and the caller drops reuse for that lane: the halo-clamp policy.
"""

from __future__ import annotations

import dataclasses

import torch


def _band_index(view, gy, gx):
    """Global (gy, gx) -> (flat index into view data, valid): the one
    owner of the coverage and clamping arithmetic of both view kinds.
    `valid` is False outside the image or outside the band's coverage."""
    cover = view.band_h + 2 * view.halo
    local_row = gy - view.y0 + view.halo
    in_cover = (local_row >= 0) & (local_row < cover)
    in_image = (gy >= 0) & (gy < view.height) & (gx >= 0) & (gx < view.width)
    idx = (torch.clamp(local_row, 0, cover - 1).to(torch.int64) * view.width
           + torch.clamp(gx, 0, view.width - 1).to(torch.int64))
    return idx, in_cover & in_image


@dataclasses.dataclass
class BandView:
    """Flat neighbour-readable view of one image-space array.

    data: [(band_h + 2 * halo) * width, C] rows, top halo first; y0: the
    global row of the band's first (non-halo) row."""
    data: torch.Tensor
    y0: int
    width: int
    height: int
    band_h: int
    halo: int

    def read(self, gy, gx):
        """Rows at global pixel coords (gy, gx) [R] -> (rows [R, C],
        valid [R])."""
        idx, valid = _band_index(self, gy, gx)
        return self.data[idx], valid

    def read_cols(self, gy, gx):
        """`read`, as a list of C [R] columns."""
        rows, valid = self.read(gy, gx)
        return list(rows.unbind(1)), valid

    def as_2d(self):
        """[band_h + 2 * halo, width, C] image-shaped view."""
        return self.data.reshape(self.band_h + 2 * self.halo, self.width,
                                 *self.data.shape[1:])


@dataclasses.dataclass
class PairBandView:
    """A BandView over `cat([a, b], -1)` that never builds the
    concatenation: for bands so large that the combined G-buffer and
    reservoir copies would not fit, at one more row gather per tap."""
    a: torch.Tensor
    b: torch.Tensor
    y0: int
    width: int
    height: int
    band_h: int
    halo: int

    def read(self, gy, gx):
        idx, valid = _band_index(self, gy, gx)
        return torch.cat([self.a[idx], self.b[idx]], dim=-1), valid

    def read_cols(self, gy, gx):
        idx, valid = _band_index(self, gy, gx)
        return list(self.a[idx].unbind(1)) + list(self.b[idx].unbind(1)), \
            valid


def trivial_view(flat, width: int, height: int) -> BandView:
    """One device: the full image, no halo."""
    return BandView(data=flat, y0=0, width=width, height=height,
                    band_h=height, halo=0)


def trivial_pair_view(a, b, width: int, height: int) -> PairBandView:
    return PairBandView(a=a, b=b, y0=0, width=width, height=height,
                        band_h=height, halo=0)


def halo_exchange(flat_local, width: int, band_h: int, halo: int, exchange,
                  y0: int) -> BandView:
    """A BandView of one band's flat array [band_h * width, C] with
    `halo` rows of each neighbour band around it.

    exchange: the band's link to its neighbours (`parallel/tiles.py`):
    `exchange.n` bands in all, and `exchange(top_rows, bottom_rows) ->
    (from_above, from_below)`, where this band's top rows go to band
    d - 1's bottom halo and its bottom rows to band d + 1's top halo,
    and edge bands receive zeros (masked by the coverage checks anyway).
    Every band must call it, in the same order."""
    n = exchange.n
    if halo == 0 or n == 1:
        return BandView(data=flat_local, y0=y0, width=width,
                        height=band_h * n, band_h=band_h, halo=0)
    trailing = flat_local.shape[1:]
    img = flat_local.reshape(band_h, width, *trailing)
    from_above, from_below = exchange(img[:halo], img[-halo:])
    ext = torch.cat([from_above, img, from_below], dim=0)
    return BandView(data=ext.reshape(-1, *trailing), y0=y0, width=width,
                    height=band_h * n, band_h=band_h, halo=halo)
