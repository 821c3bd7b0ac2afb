"""What the row bands replayed as CUDA graphs need, on the CPU
(`parallel/tiles.py:TiledFrameGraph`, and config 4's refit inside
`render/graph.py:FrameGraph`). Both capture only on a card
(`chip_smoke.py` phase 26 holds their replays to the eager frames bit for
bit); here they must refuse the CPU.

A replayed band frame exchanges its halo rows through fixed receive
buffers that the host fills from the rows each band posted, between
segments (`_Links`). The threaded frame runs the same exchange, the last
band at each barrier filling the buffers, so on 4 CPU bands that
protocol is held to the one-device frame (and, in
tests/test_torch_tiles.py, to the reference's ppermute bit for bit).

Tolerances, each with its measured value:
  - 4 threaded bands through the fixed buffers against render_frame:
    ldr, hdr, every state word and rays EQUAL (the same rows reach the
    same ops), with a static camera (the G-buffer reused, as the app
    renders) and with the camera moved at frame 2;
  - `_Links.fill`: every received row EQUAL to the neighbour's posted
    row, the edge bands' outer buffers zeros.
"""

import sys

import numpy as np
import pytest
import torch

from tpu_raytracer_torch.models import scenes
from tpu_raytracer_torch.ops import restir
from tpu_raytracer_torch.parallel import tiles, views
from tpu_raytracer_torch.render import camera as camera_mod
from tpu_raytracer_torch.render import graph as graph_mod
from tpu_raytracer_torch.render import pipeline, renderer

W = H = 32
BANDS = 4
# render_band's halo exchanges: the two comb views of ReSTIR, then hdr,
# the packed G-buffer and accum for post (render/pipeline.py)
EXCHANGES = 5

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def cornell():
    return scenes.create_cornell_box("cpu")


def _bits(x):
    return np.ascontiguousarray(x.numpy()).view(np.uint8)


def _sequence(scene, render, frames, move_at=None, gb_reuse=False):
    """The camera sequence of tests/test_torch_tiles.py:_run through
    render(u, frame_count, static_ok, gb_reuse) -> (ldr, hdr, state dict,
    aux): per frame, ldr, hdr, every state tensor and the rays."""
    cam = camera_mod.CameraController()
    out, fc = [], 0
    for i in range(frames):
        if i == move_at:
            cam.press("w")
            cam.update(0.05)
            cam.release("w")
            fc = 0
        u = renderer.camera_to_device(cam.uniform(W / H, fc, scene.num_lights),
                                      "cpu")
        ldr, hdr, state, aux = render(u, fc, fc > 0, gb_reuse)
        out.append(([ldr, hdr, *state.values()], float(aux["rays"])))
        fc += 1
    return out


def _banded(scene):
    mesh = tiles.make_mesh(["cpu"] * BANDS)
    with pytest.warns(UserWarning, match="halo"):
        tiled = tiles.make_render_frame_tiled(mesh, W, H)
    state = tiles.shard_state(pipeline.init_state(W, H, "cpu"), mesh)

    def render(u, fc, static_ok, gb_reuse):
        nonlocal state
        ldr, hdr, state, aux = tiled(scene, u, fc, state, static_ok,
                                     gb_reuse=gb_reuse)
        return ldr, hdr, tiles.gather_state(state), aux
    return render


def _one_device(scene):
    state = pipeline.init_state(W, H, "cpu")

    def render(u, fc, static_ok, gb_reuse):
        nonlocal state
        out = pipeline.render_frame(scene, u, fc, state, W, H,
                                    static_ok=static_ok, gb_reuse=gb_reuse)
        state = out[2]
        return out
    return render


@pytest.mark.parametrize("frames, move_at, gb_reuse",
                         [(3, None, True), (4, 2, False)],
                         ids=["static", "moving"])
def test_bands_through_fixed_halos_equal_one_device(cornell, monkeypatch,
                                                    frames, move_at,
                                                    gb_reuse):
    """4 CPU bands exchanging through fixed receive buffers that the host
    fills between segments: EXCHANGES fills a frame, into the same
    buffers every frame, and every frame equal, word for word, to the
    one-device frame."""
    fills, fill = [], tiles._Links.fill

    def spy(links, k):
        fill(links, k)
        fills.append((k, [b.data_ptr() for pair in links.recv[k]
                          for b in pair]))
    monkeypatch.setattr(tiles._Links, "fill", spy)
    got = _sequence(cornell, _banded(cornell), frames, move_at, gb_reuse)
    assert [k for k, _ in fills] == list(range(EXCHANGES)) * frames
    assert all(ptrs == fills[k][1] for k, ptrs in fills)
    want = _sequence(cornell, _one_device(cornell), frames, move_at,
                     gb_reuse)
    for (g, g_rays), (w, w_rays) in zip(got, want):
        assert len(g) == len(w) == 5
        for a, b in zip(g, w):
            assert np.array_equal(_bits(a), _bits(b))
        assert g_rays == w_rays > 0


def test_links_fill_copies_neighbour_rows():
    """_Links: the receive buffers of an exchange are made once and kept
    across frames; fill puts band d - 1's bottom rows above band d and
    band d + 1's top rows below it; the edges stay zeros."""
    links = tiles._Links(BANDS)
    rng = np.random.default_rng(7)
    kept = None
    for frame in range(2):
        posted = [tuple(torch.from_numpy(rng.standard_normal(
            (3, 5, 2)).astype(np.float32)) for _ in range(2))
            for _ in range(BANDS)]
        recv = [links.post(d, 0, *posted[d]) for d in range(BANDS)]
        ptrs = [(a.data_ptr(), b.data_ptr()) for a, b in recv]
        assert kept is None or ptrs == kept
        kept = ptrs
        links.fill(0)
        for d, (above, below) in enumerate(recv):
            want_above = posted[d - 1][1] if d > 0 else torch.zeros(3, 5, 2)
            want_below = (posted[d + 1][0] if d < BANDS - 1
                          else torch.zeros(3, 5, 2))
            assert torch.equal(above, want_above), (frame, d)
            assert torch.equal(below, want_below), (frame, d)


def test_band_frame_splits_into_six_segments(cornell):
    """A band's render_band reaches its exchange 5 times, in the same
    order on every band, so a captured band frame is 6 segments: the
    exchange of a warm-up (`_Segments` without a pool) counts them and
    makes each band's receive buffers in the halo's shape."""
    mesh = tiles.make_mesh(["cpu"] * BANDS)
    with pytest.warns(UserWarning, match="halo"):
        band_h, halo = tiles._bands(mesh, H, tiles.DEFAULT_HALO)
    links = tiles._Links(BANDS)
    u = renderer.camera_to_device(camera_mod.CameraController().uniform(
        1.0, 0, cornell.num_lights), "cpu")
    state = tiles.shard_state(pipeline.init_state(W, H, "cpu"), mesh)
    for d in range(BANDS):
        seg = tiles._Segments(links, d)
        ctx = restir.make_ctx(W, H, "cpu", y0=d * band_h, band_h=band_h)

        def make_view(flat, d=d, seg=seg):
            return views.halo_exchange(flat, W, band_h, halo, seg,
                                       d * band_h)
        pipeline.render_band(cornell, u, 0, state[d], ctx, make_view)
        seg.end()
        assert seg.k == EXCHANGES and seg.graphs == []
    assert len(links.recv) == EXCHANGES
    for k in range(EXCHANGES):
        shapes = {tuple(b.shape) for pair in links.recv[k] for b in pair}
        assert len(shapes) == 1
        assert shapes.pop()[:2] == (halo, W)


def test_halo_fill_that_fails_fails_the_call():
    """A fill that raises (rows of another shape) breaks the barrier in
    every band, and its error reaches the caller: no band goes on with
    buffers left unfilled."""
    mesh = tiles.make_mesh(["cpu"] * BANDS)

    def band(d, dev, exchange):
        rows = torch.zeros(1, 2 + (d == 2))
        return exchange(rows, rows)

    with pytest.raises(RuntimeError):
        tiles.run_bands(mesh, band, timeout=60.0)


def test_halo_exchanges_fill_in_order():
    """Over 3 exchanges of 4 threads with a short switch interval, each
    band receives exactly its neighbours' rows of that exchange."""
    mesh = tiles.make_mesh(["cpu"] * BANDS)

    def band(d, dev, exchange):
        got = []
        for k in range(3):
            mine = torch.full((2, 3), float(10 * k + d))
            above, below = exchange(mine, mine + 0.5)
            got.append((float(above[0, 0]), float(below[0, 0])))
        return got

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        out = tiles.run_bands(mesh, band, timeout=60.0)
    finally:
        sys.setswitchinterval(switch)
    for d, got in enumerate(out):
        for k, (above, below) in enumerate(got):
            assert above == (10 * k + d - 1 + 0.5 if d > 0 else 0.0)
            assert below == (10 * k + d + 1 if d < BANDS - 1 else 0.0)


def test_frame_graph_refit_refuses_the_cpu(cornell):
    """FrameGraph captures config 4's refit with its frame only on a
    card: on the CPU it raises, whatever it refits, and nothing falls
    back to an eager frame."""
    for changed in ((6,), "all"):
        with pytest.raises(ValueError, match="not a CUDA device"):
            graph_mod.FrameGraph(cornell, W, H, "cpu", refit_changed=changed)


def test_tiled_frame_graph_refuses_the_cpu(cornell):
    """TiledFrameGraph captures CUDA graphs only: CPU bands, or a mesh
    with one CPU band, raise; nothing falls back to the threaded frame."""
    for devices in (["cpu"] * BANDS, ["cuda:0", "cpu"]):
        with pytest.raises(ValueError, match="not all CUDA devices"):
            tiles.TiledFrameGraph(tiles.make_mesh(devices), cornell, W, H)
