"""Screen-tile data parallelism: the frame over row bands on several
devices (`tpu_raytracer/parallel/tiles.py`).

The pixel grid is split into horizontal row bands, one per entry of a
`Mesh` (a list of torch devices; a device may repeat, so four bands can
share one card or the CPU):

  * scene data (triangles, materials, lights, textures) is replicated,
    one copy per distinct device;
  * per-pixel state (G-buffer, reservoirs, accumulation) lives on its
    band's device for the whole frame, as a list of band states;
  * the passes that read neighbour pixels (temporal reprojection, the
    spatial ReSTIR taps, the post stencils, the history taps) read
    through halo views (parallel/views.py): each band posts its edge
    rows and copies its neighbours' (a peer copy between cards);
  * the LDR and HDR frames are gathered onto the first device for
    display and screenshots, and the ray count is summed.

Every band runs the same `pipeline.render_band` in a thread of its own
(one program over all bands, as the reference's shard_map runs it); the
halo exchanges meet at a barrier, and the threads take turns on the
host between exchanges. Reprojection or tap reach beyond the
halo drops reuse for that lane, as on the reference.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import warnings

import torch

from ..ops import restir as restir_ops
from ..ops import trace_api
from ..render import pipeline as pipeline_mod
from . import views as views_mod

# Halo must cover the spatial-ReSTIR disk radius (10 px) and post stencils
# (2 px); bands shorter than the halo clamp it, which drops long-range
# taps - use images with height >= 16 * bands in production.
DEFAULT_HALO = 16
# seconds a band waits at a halo exchange for the others before the frame
# fails: a band that never arrives is a fault, not a slow frame
BARRIER_TIMEOUT_S = 120.0


@dataclasses.dataclass
class Mesh:
    """The devices of the row bands, top band first."""
    devices: list

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(devices) -> Mesh:
    """A mesh over an explicit list of torch devices (repeats allowed)."""
    return Mesh([torch.device(d) for d in devices])


def _to(tree, device):
    """`tree` (tensors in dicts and dataclasses: a scene, a camera) with
    every tensor on `device`."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _to(getattr(tree, f.name), device)
            for f in dataclasses.fields(tree) if f.init})
    return tree


class Replicated(dict):
    """One copy of a tree per distinct device of a mesh."""


def replicate(tree, mesh: Mesh) -> Replicated:
    return Replicated({d: _to(tree, d) for d in dict.fromkeys(mesh.devices)})


def _on(tree, device):
    return tree[device] if isinstance(tree, Replicated) else _to(tree, device)


def shard_state(state: dict, mesh: Mesh) -> list:
    """Frame state -> one state per band: the leading (pixel) axis split
    into contiguous row bands, each on its band's device."""
    n = mesh.size
    return [{k: v.chunk(n)[i].to(dev) for k, v in state.items()}
            for i, dev in enumerate(mesh.devices)]


def gather_state(state: list) -> dict:
    """Band states -> one frame state on the first band's device (for the
    checkpoint and the screenshot)."""
    dev = next(iter(state[0].values())).device
    return {k: torch.cat([s[k].to(dev) for s in state]) for k in state[0]}


class _Hub:
    """The bands' mailbox: one slot per band for its edge rows, and a
    barrier that a failing band aborts so that the others fail too.

    The bands take turns on the host (a baton passed at every exchange):
    threads that all dispatch small ops at once hand the GIL to each
    other on every op, which costs more than the ops (5x on four H100s,
    PERF.md); a card still runs one band's queued kernels while the next
    band dispatches."""

    def __init__(self, n: int, timeout: float):
        self.n = n
        self.slots = [None] * n
        self.barrier = threading.Barrier(n, timeout=timeout)
        self.baton = threading.Lock()

    def wait(self):
        """Wait at the barrier for every band, the baton put down."""
        self.baton.release()
        try:
            self.barrier.wait()
        finally:
            self.baton.acquire()


@dataclasses.dataclass
class _Exchange:
    """Band d's side of the halo exchange (views.halo_exchange)."""
    hub: _Hub
    d: int
    device: torch.device

    @property
    def n(self) -> int:
        return self.hub.n

    def __call__(self, top_rows, bottom_rows):
        hub, d = self.hub, self.d
        hub.slots[d] = (top_rows, bottom_rows)
        hub.wait()                           # every band has posted
        from_above = (hub.slots[d - 1][1].to(self.device) if d > 0
                      else torch.zeros_like(bottom_rows))
        from_below = (hub.slots[d + 1][0].to(self.device) if d < hub.n - 1
                      else torch.zeros_like(top_rows))
        hub.wait()                           # every band has its rows
        return from_above, from_below


def run_bands(mesh: Mesh, fn, timeout: float = BARRIER_TIMEOUT_S) -> list:
    """fn(d, device, exchange) on every band at once, one thread each,
    under its device; returns the results in band order. A band that
    raises breaks the barrier, and its exception is raised here."""
    hub = _Hub(mesh.size, timeout)
    out = [None] * mesh.size
    errors = [None] * mesh.size

    def band(d, dev):
        ctx = (torch.cuda.device(dev) if dev.type == "cuda"
               else contextlib.nullcontext())
        hub.baton.acquire()
        try:
            with ctx:
                out[d] = fn(d, dev, _Exchange(hub, d, dev))
        except BaseException as e:        # noqa: BLE001 - re-raised below
            errors[d] = e
            hub.barrier.abort()
        finally:
            hub.baton.release()

    if any(dev.type == "cuda" for dev in mesh.devices):
        trace_api.load_kernels()          # one nvcc build, before threads
    threads = [threading.Thread(target=band, args=(d, dev), daemon=True)
               for d, dev in enumerate(mesh.devices)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    first = next((e for e in errors
                  if e is not None
                  and not isinstance(e, threading.BrokenBarrierError)),
                 next((e for e in errors if e is not None), None))
    if first is not None:
        raise first
    return out


def make_render_frame_tiled(mesh: Mesh, width: int, height: int,
                            halo: int = DEFAULT_HALO):
    """The frame over the mesh's row bands at a fixed resolution.

    Returns call(scene, camera, frame_count, state, static_ok=False,
    gb_reuse=False) -> (ldr_full, hdr_full, new_state, aux), the shape of
    pipeline.render_frame (with gb_reuse each band reuses its own
    G-buffer rows): `state` is a list of band states
    (`shard_state`) and stays on the bands across frames; ldr and hdr are
    gathered onto mesh.devices[0]; aux["rays"] sums the bands' counts
    and aux["band_launches"] lists each band's kernel launches.
    scene and camera may be `replicate`d; otherwise each band copies
    them to its device."""
    n_dev = mesh.size
    if height % n_dev:
        raise ValueError(f"height {height} must divide evenly into "
                         f"{n_dev} row bands")
    band_h = height // n_dev
    if band_h < halo:
        warnings.warn(
            f"row bands of {band_h} px are shorter than the {halo} px halo "
            f"({n_dev} devices x {height} px): spatial-ReSTIR taps and post "
            "stencils beyond the band drop their reuse for those lanes. "
            f"Use height >= {halo * n_dev} for full-quality output.",
            stacklevel=2)
    halo = min(halo, band_h)

    def call(scene, camera, frame_count, state, static_ok=False,
             gb_reuse=False):
        def per_band(d, dev, exchange):
            y0 = d * band_h
            ctx = restir_ops.make_ctx(width, height, dev, y0=y0,
                                      band_h=band_h)

            def make_view(flat):
                return views_mod.halo_exchange(flat, width, band_h, halo,
                                               exchange, y0)

            with trace_api.thread_launches() as launches:
                out = pipeline_mod.render_band(
                    _on(scene, dev), _on(camera, dev), frame_count,
                    state[d], ctx, make_view, static_ok=static_ok,
                    gb_reuse=gb_reuse)
            return (*out, launches)

        bands = run_bands(mesh, per_band)
        dev0 = mesh.devices[0]
        ldr = torch.cat([b[0].to(dev0) for b in bands])
        hdr = torch.cat([b[1].to(dev0) for b in bands])
        aux = {}
        for b in bands:
            for k, v in b[3].items():
                aux[k] = aux[k] + v.to(dev0) if k in aux else v.to(dev0)
        aux["band_launches"] = [b[4] for b in bands]
        return ldr, hdr, [b[2] for b in bands], aux

    return call
