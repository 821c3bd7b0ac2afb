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
halo drops reuse for that lane, as on the reference. At an exchange
each band posts its edge rows, and the last band to arrive copies them
into the neighbours' fixed receive buffers (`_Links.fill`).

On CUDA devices `TiledFrameGraph` replays the same frame from CUDA
graphs, the counterpart of the reference's one jitted shard_map: each
band's frame is captured in segments that end at its halo exchanges,
and the host runs the same fill between segments.
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
from ..utils import profiling
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


class _Links:
    """Halo rows exchanged through fixed buffers: for exchange k and band
    d, the rows the band posted (`posted[k][d]`: top, bottom) and the
    buffers it receives its neighbours' rows in (`recv[k][d]`: from
    above, from below), made at the band's first post and kept; the edge
    bands' outer buffers stay zeros. `fill(k)` copies exchange k's posted
    rows into the neighbours' buffers: a peer copy between cards, which
    Tensor.copy_ orders after the work queued on both cards' current
    streams and before the work queued after it."""

    def __init__(self, n: int):
        self.n = n
        self.posted, self.recv = [], []

    def post(self, d: int, k: int, top_rows, bottom_rows):
        """Band d's rows of exchange k -> its receive buffers."""
        while len(self.posted) <= k:
            self.posted.append([None] * self.n)
            self.recv.append([None] * self.n)
        self.posted[k][d] = (top_rows, bottom_rows)
        if self.recv[k][d] is None:
            self.recv[k][d] = (torch.zeros_like(bottom_rows),
                               torch.zeros_like(top_rows))
        return self.recv[k][d]

    def fill(self, k: int) -> None:
        posted, recv = self.posted[k], self.recv[k]
        for d in range(self.n):
            if d > 0:
                recv[d][0].copy_(posted[d - 1][1])
            if d < self.n - 1:
                recv[d][1].copy_(posted[d + 1][0])


class _Hub:
    """The bands' meeting point: the halo rows (`links`), and a barrier
    that a failing band aborts so that the others fail too. The last
    band to reach an exchange fills every band's receive buffers (the
    barrier's action) before any band goes on.

    The bands take turns on the host (a baton passed at every exchange):
    threads that all dispatch small ops at once hand the GIL to each
    other on every op, which costs more than the ops (5x on four H100s,
    PERF.md); a card still runs one band's queued kernels while the next
    band dispatches."""

    def __init__(self, n: int, timeout: float, links: _Links):
        self.n = n
        self.links, self.round = links, 0
        self.barrier = threading.Barrier(n, action=self._fill,
                                         timeout=timeout)
        self.baton = threading.Lock()

    def _fill(self):
        self.links.fill(self.round)
        self.round += 1

    def wait(self):
        """Wait at the barrier for every band, the baton put down."""
        self.baton.release()
        try:
            self.barrier.wait()
        finally:
            self.baton.acquire()


@dataclasses.dataclass
class _Exchange:
    """Band d's side of the halo exchange (views.halo_exchange): post the
    band's rows, wait for every band and the fill, hand back the receive
    buffers."""
    hub: _Hub
    d: int
    k: int = 0

    @property
    def n(self) -> int:
        return self.hub.n

    def __call__(self, top_rows, bottom_rows):
        recv = self.hub.links.post(self.d, self.k, top_rows, bottom_rows)
        self.k += 1
        self.hub.wait()              # every band posted; the buffers filled
        return recv


def run_bands(mesh: Mesh, fn, timeout: float = BARRIER_TIMEOUT_S,
              links: _Links | None = None) -> list:
    """fn(d, device, exchange) on every band at once, one thread each,
    under its device; returns the results in band order. A band that
    raises breaks the barrier, and its exception is raised here. The
    bands exchange halo rows through `links` (a `_Links` kept across
    calls keeps its receive buffers), or through new ones."""
    hub = _Hub(mesh.size, timeout,
               _Links(mesh.size) if links is None else links)
    out = [None] * mesh.size
    errors = [None] * mesh.size

    def band(d, dev):
        ctx = (torch.cuda.device(dev) if dev.type == "cuda"
               else contextlib.nullcontext())
        hub.baton.acquire()
        try:
            with ctx:
                out[d] = fn(d, dev, _Exchange(hub, d))
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


def _bands(mesh: Mesh, height: int, halo: int) -> tuple:
    """(band height, halo clamped to it) of the mesh's row bands."""
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
            stacklevel=3)
    return band_h, min(halo, band_h)


def _gather(outs: list, dev0) -> tuple:
    """The bands' (ldr, hdr, aux) -> ldr and hdr on dev0, aux summed."""
    ldr = torch.cat([o[0].to(dev0) for o in outs])
    hdr = torch.cat([o[1].to(dev0) for o in outs])
    aux = {}
    for o in outs:
        for k, v in o[2].items():
            aux[k] = aux[k] + v.to(dev0) if k in aux else v.to(dev0)
    return ldr, hdr, aux


def make_render_frame_tiled(mesh: Mesh, width: int, height: int,
                            halo: int = DEFAULT_HALO,
                            tap_batch: bool = False):
    """The frame over the mesh's row bands at a fixed resolution.

    Returns call(scene, camera, frame_count, state, static_ok=False,
    gb_reuse=False) -> (ldr_full, hdr_full, new_state, aux), the shape of
    pipeline.render_frame (with gb_reuse each band reuses its own
    G-buffer rows): `state` is a list of band states
    (`shard_state`) and stays on the bands across frames; ldr and hdr are
    gathered onto mesh.devices[0]; aux["rays"] sums the bands' counts
    and aux["band_launches"] lists each band's kernel launches.
    scene and camera may be `replicate`d; otherwise each band copies
    them to its device. The bands exchange halo rows through receive
    buffers kept across frames, filled by copies between exchanges, as
    `TiledFrameGraph`'s replays do. tap_batch: each band batches its
    spatial taps (`restir.tap_batch_on`, gated on the band's lanes)."""
    band_h, halo = _bands(mesh, height, halo)
    links = _Links(mesh.size)

    def call(scene, camera, frame_count, state, static_ok=False,
             gb_reuse=False):
        def per_band(d, dev, exchange):
            y0 = d * band_h
            ctx = restir_ops.make_ctx(width, height, dev, y0=y0,
                                      band_h=band_h, tap_batch=tap_batch)

            def make_view(flat):
                return views_mod.halo_exchange(flat, width, band_h, halo,
                                               exchange, y0)

            with trace_api.thread_launches() as launches:
                out = pipeline_mod.render_band(
                    _on(scene, dev), _on(camera, dev), frame_count,
                    state[d], ctx, make_view, static_ok=static_ok,
                    gb_reuse=gb_reuse)
            return (*out, launches)

        bands = run_bands(mesh, per_band, links=links)
        ldr, hdr, aux = _gather([(b[0], b[1], b[3]) for b in bands],
                                mesh.devices[0])
        aux["band_launches"] = [b[4] for b in bands]
        return ldr, hdr, [b[2] for b in bands], aux

    return call


class _Segments:
    """Band d's exchange while its frame is captured (`pool` given) or
    warmed up: each call ends the segment being captured, posts the
    band's rows to `links` and begins the next segment, in the band's
    pool on the same stream. `graphs` holds the band's segments."""

    def __init__(self, links: _Links, d: int, pool=None):
        self.links, self.d, self.pool = links, d, pool
        self.k, self.graphs, self.capturing = 0, [], False
        self._begin()

    @property
    def n(self) -> int:
        return self.links.n

    def _begin(self):
        if self.pool is not None:
            self.graphs.append(torch.cuda.CUDAGraph())
            self.graphs[-1].capture_begin(pool=self.pool)
            self.capturing = True

    def end(self):
        """End the segment being captured, if one is."""
        if self.capturing:
            self.capturing = False
            self.graphs[-1].capture_end()

    def __call__(self, top_rows, bottom_rows):
        self.end()
        recv = self.links.post(self.d, self.k, top_rows, bottom_rows)
        self.k += 1
        self._begin()
        return recv


class TiledFrameGraph:
    """The frame over the mesh's row bands on CUDA devices, replayed from
    CUDA graphs: `make_render_frame_tiled`'s frame, as the reference runs
    its shard_map as one jitted program.

    Each band's frame is captured in segments that end at its halo
    exchanges (a 512^2 `render_band` makes 5: 6 segments), into a memory
    pool of the band's. Nothing runs while a graph is captured, so the
    bands are captured one after another in the calling thread with no
    barrier: an exchange ends the band's segment, keeps the rows it
    posted and hands back fixed receive buffers (`_Links`). A replay runs
    segment k of every band on its device's current stream, copies the
    posted rows into the receive buffers (`_Links.fill`), then runs
    segment k + 1; ldr and hdr are gathered onto the first device and
    the bands' aux summed, as `make_render_frame_tiled` does.

    Static inputs: the camera uniform, one per distinct device,
    frame_count, a 0-dim int64 tensor a band, and the band states
    (`state`, a list as `shard_state` makes it), into which each band's
    last segment copies its new state. One set of graphs per (static_ok,
    reuse of the G-buffer), each captured on first use after one warm-up
    frame on a scratch state (its halos the receive buffers as they
    stand: it only initialises what must not initialise in a capture).
    tap_batch: each band batches its spatial taps, as
    `make_render_frame_tiled(tap_batch=True)` does; one graph set holds
    one mode. Each band's frame captures its stage marks
    (`utils/profiling.py:stage`) into its segments, with a stamp row of
    its own: `stage_ms` reads the last replay's. Nothing falls back: a
    capture error raises."""

    def __init__(self, mesh: Mesh, scene, width: int, height: int,
                 halo: int = DEFAULT_HALO, tap_batch: bool = False):
        if any(dev.type != "cuda" for dev in mesh.devices):
            raise ValueError(f"TiledFrameGraph captures CUDA graphs; "
                             f"{mesh.devices} are not all CUDA devices")
        self.mesh, self.width, self.height = mesh, width, height
        self.band_h, self.halo = _bands(mesh, height, halo)
        self.scene = (scene if isinstance(scene, Replicated)
                      else replicate(scene, mesh))
        self.state = [{k: v.clone() for k, v in band.items()}
                      for band in shard_state(pipeline_mod.init_state(
                          width, height, mesh.devices[0]), mesh)]
        self.frame_count = [torch.zeros((), dtype=torch.int64, device=dev)
                            for dev in mesh.devices]
        self.camera = None
        self._ctx = [restir_ops.make_ctx(width, height, dev,
                                         y0=d * self.band_h,
                                         band_h=self.band_h,
                                         tap_batch=tap_batch)
                     for d, dev in enumerate(mesh.devices)]
        self._pools = []
        for dev in mesh.devices:
            with torch.cuda.device(dev):
                self._pools.append(torch.cuda.graph_pool_handle())
        # (static_ok, reuse) -> (segments a band, links, outputs a band,
        # launches a band, stamps a band)
        self._graphs = {}
        self._last = None       # the key of the last replay
        self.segments = None    # a band's segments, once captured

    def load_state(self, state) -> None:
        """Copy a frame state (one dict, or a list of band states) into
        the static band states."""
        if isinstance(state, dict):
            state = shard_state(
                {k: torch.as_tensor(v) for k, v in state.items()}, self.mesh)
        for band, src in zip(self.state, state):
            for k, v in band.items():
                v.copy_(src[k])

    def _band(self, d: int, state: dict, key, exchange):
        """Band d's frame from the static inputs: render_band's (ldr, hdr,
        new state, aux)."""
        dev = self.mesh.devices[d]

        def make_view(flat):
            return views_mod.halo_exchange(flat, self.width, self.band_h,
                                           self.halo, exchange,
                                           d * self.band_h)

        static_ok, reuse = key
        return pipeline_mod.render_band(
            self.scene[dev], self.camera[dev], self.frame_count[d], state,
            self._ctx[d], make_view, static_ok=static_ok, gb_reuse=reuse)

    def _capture(self, key):
        trace_api.load_kernels()
        links = _Links(self.mesh.size)
        segments, outs, launches, stamps = [], [], [], []
        for d, dev in enumerate(self.mesh.devices):
            with torch.cuda.device(dev):
                side = torch.cuda.Stream(dev)
                side.wait_stream(torch.cuda.current_stream(dev))
                with torch.cuda.stream(side):
                    # the warm-up launches for real, so it renders a
                    # scratch copy of the state
                    scratch = {k: v.clone() for k, v in self.state[d].items()}
                    with profiling.marking(dev):
                        self._band(d, scratch, key, _Segments(links, d))
                    del scratch
                    torch.cuda.synchronize(dev)
                    stamps.append(profiling.Stamps(dev))
                    seg = _Segments(links, d, self._pools[d])
                    try:
                        with trace_api.captured_launches() as launched, \
                                profiling.marking(dev, stamps[-1]):
                            ldr, hdr, new_state, aux = self._band(
                                d, self.state[d], key, seg)
                            with profiling.stage("state_copy"):
                                for k, v in self.state[d].items():
                                    v.copy_(new_state[k])
                    except BaseException:
                        seg.end()     # leave capture mode, then re-raise
                        raise
                    seg.end()
                torch.cuda.current_stream(dev).wait_stream(side)
            segments.append(seg.graphs)
            outs.append((ldr, hdr, aux))
            launches.append(dict(launched))
        if len({len(g) for g in segments}) != 1:
            raise RuntimeError(f"the bands' frames split into "
                               f"{[len(g) for g in segments]} segments: "
                               f"every band must reach each exchange")
        self.segments = len(segments[0])
        self._graphs[key] = (segments, links, outs, launches, stamps)

    def __call__(self, camera: dict, frame_count, static_ok: bool = False,
                 gb_reuse: bool = False):
        """One frame: camera a device uniform (or `replicate`d),
        frame_count a Python int or a 0-dim int64 tensor, static_ok and
        gb_reuse as `make_render_frame_tiled`'s call takes them. Returns
        (ldr, hdr, state, aux) as that call does; `state` is the static
        band states, ldr, hdr and aux are new tensors."""
        with profiling.span("frame.call"):
            return self._call(camera, frame_count, static_ok, gb_reuse)

    def _call(self, camera, frame_count, static_ok, gb_reuse):
        with profiling.span("frame.inputs"):
            if self.camera is None:
                self.camera = {dev: {k: v.to(dev, copy=True)
                                     for k, v in _on(camera, dev).items()}
                               for dev in self.scene}
            else:
                for dev, cam in self.camera.items():
                    src = camera[dev] if isinstance(camera, Replicated) \
                        else camera
                    for k, v in cam.items():
                        v.copy_(src[k])
            for fc in self.frame_count:
                if isinstance(frame_count, torch.Tensor):
                    fc.copy_(frame_count)
                else:
                    fc.fill_(frame_count)
        key = (bool(static_ok), bool(gb_reuse and static_ok))
        if key not in self._graphs:
            self._capture(key)
        segments, links, outs, launches, _ = self._graphs[key]
        for k in range(self.segments):
            for d, dev in enumerate(self.mesh.devices):
                with profiling.span("frame.replay", card=d, segment=k), \
                        torch.cuda.device(dev):
                    segments[d][k].replay()
            if k + 1 < self.segments:
                with profiling.span("band.fill", segment=k):
                    links.fill(k)
        self._last = key
        for counts in launches:
            trace_api.add_launches(counts)
        with profiling.span("frame.outputs"):
            ldr, hdr, aux = _gather(outs, self.mesh.devices[0])
        aux["band_launches"] = [dict(c) for c in launches]
        return ldr, hdr, self.state, aux

    def stage_ms(self) -> list:
        """The last replay's device ms of each stage, from each band's
        stamps (`profiling.Stamps.ms`): one dict a band, in band order;
        [] before the first replay. A stage's time runs from its mark to
        the next, so it holds the band's waits for its neighbours inside
        the stage. Reads the devices: call it once the frame has been
        waited for."""
        if self._last is None:
            return []
        return [s.ms() for s in self._graphs[self._last][4]]
