"""The port's row bands (`parallel/views.py`, `parallel/tiles.py`) against
the reference's (`tpu_raytracer/parallel/`) and against the port's own
one-device frame, mirroring tests/test_tiles.py.

The port's bands run as threads over `make_mesh(["cpu"] * 8)`, where the
reference's run under shard_map on the conftest's 8 virtual CPU devices.

Tolerances, each with its measured value:
  - BandView / PairBandView reads and halo_exchange: EXACT against the
    reference's (values and masks);
  - a band's primary rays: EXACT against the same rows of the full
    frame's;
  - the 8-band frames against the port's render_frame: LDR max abs
    <= 1e-5 (the reference's bound; measured 0.0) and rays within 1e-3
    (measured 0);
  - the 16x128 8-band frame against the reference's 8-band frame: PSNR
    >= FLOOR_DB, the port's CPU floor of tests/test_torch_frame.py
    (measured 125.6 dB), rays within 1% (measured equal);
  - the denoised screenshot of the gathered 8-band state against the
    one-device screenshot: max abs <= 1e-5 (measured 0.0).
"""

import sys
import threading
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from tpu_raytracer.models import scenes as ref_scenes
from tpu_raytracer.parallel import tiles as ref_tiles
from tpu_raytracer.parallel import views as ref_views
from tpu_raytracer.render import camera as camera_mod
from tpu_raytracer.render import pipeline as ref_pipeline
from tpu_raytracer.render import renderer as ref_renderer
from tpu_raytracer.utils.image import psnr
from tpu_raytracer_torch import convert
from tpu_raytracer_torch.app.screenshot import denoised_screenshot
from tpu_raytracer_torch.models import scenes
from tpu_raytracer_torch.ops import gbuffer
from tpu_raytracer_torch.parallel import tiles, views
from tpu_raytracer_torch.render import pipeline, renderer

FLOOR_DB = 49.0
BANDS = 8

torch.set_num_threads(1)


def _ref_view(cls, arrays, y0, **geo):
    return cls(*(jnp.asarray(a) for a in arrays), y0=jnp.int32(y0), **geo)


@pytest.mark.parametrize("pair", [False, True], ids=["band", "pair"])
@pytest.mark.parametrize("halo", [0, 4])
def test_band_view_reads_equal_reference(halo, pair):
    """read and read_cols at random global coords inside and outside the
    band's coverage and the image, bit for bit with the reference."""
    rng = np.random.default_rng(11 + halo)
    width, height, band_h, y0 = 13, 40, 8, 16
    rows = (band_h + 2 * halo) * width
    arrays = [rng.standard_normal((rows, 5)).astype(np.float32)]
    if pair:
        arrays.append(rng.standard_normal((rows, 3)).astype(np.float32))
    geo = dict(width=width, height=height, band_h=band_h, halo=halo)
    gy = rng.integers(y0 - halo - 4, y0 + band_h + halo + 4, 400)
    gy[:4] = [-1, 0, height - 1, height]
    gx = rng.integers(-3, width + 3, 400).astype(np.int32)
    gy = gy.astype(np.int32)
    ref_cls, cls = ((ref_views.PairBandView, views.PairBandView) if pair
                    else (ref_views.BandView, views.BandView))
    ref = _ref_view(ref_cls, arrays, y0, **geo)
    port = cls(*(torch.from_numpy(a) for a in arrays), y0=y0, **geo)
    want, want_ok = ref.read(jnp.asarray(gy), jnp.asarray(gx))
    got, got_ok = port.read(torch.from_numpy(gy), torch.from_numpy(gx))
    assert np.array_equal(got_ok.numpy(), np.asarray(want_ok))
    assert 0 < got_ok.sum() < len(gy)
    assert np.array_equal(got.numpy(), np.asarray(want))
    want_c, _ = ref.read_cols(jnp.asarray(gy), jnp.asarray(gx))
    got_c, _ = port.read_cols(torch.from_numpy(gy), torch.from_numpy(gx))
    assert len(got_c) == len(want_c)
    for g, w in zip(got_c, want_c):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_trivial_views_cover_the_image():
    data = torch.arange(12.0).reshape(6, 2)
    v = views.trivial_view(data, 3, 2)
    assert (v.y0, v.band_h, v.halo) == (0, 2, 0)
    assert v.as_2d().shape == (2, 3, 2)
    p = views.trivial_pair_view(data, data, 3, 2)
    assert (p.y0, p.band_h, p.halo) == (0, 2, 0)


@pytest.mark.parametrize("halo", [0, 1, 3])
def test_halo_exchange_equals_reference(halo):
    """8 CPU bands against the reference's ppermute exchange under
    shard_map on 8 virtual devices: every band's view data, y0 and
    geometry equal."""
    width, band_h = 5, 4
    n = BANDS
    data = np.random.default_rng(3).standard_normal(
        (n * band_h * width, 3)).astype(np.float32)

    ref_mesh = ref_tiles.make_mesh()
    assert ref_mesh.devices.size == n

    def per(flat):
        y0 = jax.lax.axis_index(ref_tiles.AXIS).astype(jnp.int32) * band_h
        return ref_views.halo_exchange(flat, width, band_h, halo,
                                       ref_tiles.AXIS, y0).data

    want = np.asarray(jax.jit(jax.shard_map(
        per, mesh=ref_mesh, in_specs=(P(ref_tiles.AXIS),),
        out_specs=P(ref_tiles.AXIS), check_vma=False))(jnp.asarray(data)))

    mesh = tiles.make_mesh(["cpu"] * n)
    chunks = torch.from_numpy(data).chunk(n)

    def band(d, dev, exchange):
        return views.halo_exchange(chunks[d], width, band_h, halo, exchange,
                                   d * band_h)

    got = tiles.run_bands(mesh, band)
    for d, v in enumerate(got):
        assert (v.y0, v.height, v.band_h, v.halo) == (
            d * band_h, n * band_h, band_h, halo)
    assert np.array_equal(torch.cat([v.data for v in got]).numpy(), want)


def test_band_rays_equal_full_frame_rows():
    scene = scenes.create_cornell_box("cpu")
    cam = camera_mod.CameraController()
    u = renderer.camera_to_device(cam.uniform(0.5, 0, scene.num_lights),
                                  "cpu")
    w, h = 16, 32
    full_o, full_d = gbuffer.generate_primary_rays(u, w, h)
    o, d = gbuffer.generate_primary_rays(u, w, h, y0=12, band_h=4)
    rows = slice(12 * w, 16 * w)
    for a, b in zip((*o, *d), (*full_o, *full_d)):
        assert torch.equal(a, b[rows])


def test_shard_and_gather_state_round_trip():
    mesh = tiles.make_mesh(["cpu"] * 4)
    state = pipeline.init_state(4, 8, "cpu")
    state["accum"] = torch.rand(32, 3)
    bands = tiles.shard_state(state, mesh)
    assert len(bands) == 4 and bands[1]["accum"].shape == (8, 3)
    back = tiles.gather_state(bands)
    for k in state:
        assert torch.equal(back[k], state[k]), k


def test_replicate_copies_per_distinct_device():
    mesh = tiles.make_mesh(["cpu"] * 3)
    rep = tiles.replicate({"a": torch.ones(2)}, mesh)
    assert list(rep) == [torch.device("cpu")]


def test_failing_band_fails_the_call():
    """A band that raises aborts the barrier: the bands waiting at the
    exchange return, and the caller gets the band's own exception."""
    mesh = tiles.make_mesh(["cpu"] * 4)

    def band(d, dev, exchange):
        if d == 2:
            raise KeyError("band 2")
        return exchange(torch.zeros(1), torch.zeros(1))

    with pytest.raises(KeyError, match="band 2"):
        tiles.run_bands(mesh, band, timeout=60.0)


def test_band_that_never_arrives_times_out():
    mesh = tiles.make_mesh(["cpu"] * 2)

    def band(d, dev, exchange):
        if d == 0:
            return None
        return exchange(torch.zeros(1), torch.zeros(1))

    with pytest.raises(threading.BrokenBarrierError):
        tiles.run_bands(mesh, band, timeout=0.5)


def test_launch_counts_are_exact_across_threads():
    """The band threads' kernel launches: LAUNCHES counts every one under
    a lock, and thread_launches counts each thread's apart."""
    from tpu_raytracer_torch.ops import trace_api

    trace_api.reset_launch_counts()
    own = [None] * BANDS

    def band(d):
        with trace_api.thread_launches() as counts:
            for _ in range(2000 + d):
                trace_api.count_launch("closest_hit")
        own[d] = counts["closest_hit"]

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)       # switch threads inside the counter
    try:
        threads = [threading.Thread(target=band, args=(d,))
                   for d in range(BANDS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert own == [2000 + d for d in range(BANDS)]
    assert trace_api.LAUNCHES["closest_hit"] == sum(own)
    trace_api.reset_launch_counts()


def test_short_band_halo_clamp_warns():
    mesh = tiles.make_mesh(["cpu"] * BANDS)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        tiles.make_render_frame_tiled(mesh, 32, 8 * BANDS)
    assert any("halo" in str(w.message) for w in rec), (
        [str(w.message) for w in rec])


def _run(scene, w, h, frames, tiled: bool, move_at=None):
    """Port frames of the reference camera's sequence; returns (ldr,
    hdr, state, aux) of the last frame, the state gathered."""
    mesh = tiles.make_mesh(["cpu"] * BANDS)
    cam = camera_mod.CameraController()
    num_lights = scene.num_lights
    state = pipeline.init_state(w, h, "cpu")
    if tiled:
        state = tiles.shard_state(state, mesh)
        render = tiles.make_render_frame_tiled(mesh, w, h)
        scene = tiles.replicate(scene, mesh)
    else:
        def render(scene, u, f, state):
            return pipeline.render_frame(scene, u, f, state, w, h)
    frame_count = 0
    for i in range(frames):
        if i == move_at:       # move: resets accumulation (state.rs:151)
            cam.press("w")
            cam.update(0.05)
            cam.release("w")
            frame_count = 0
        u = renderer.camera_to_device(
            cam.uniform(w / h, frame_count, num_lights), "cpu")
        ldr, hdr, state, aux = render(scene, u, frame_count, state)
        frame_count += 1
    return ldr, hdr, tiles.gather_state(state) if tiled else state, aux


def _assert_tiled_equals_single(tiled, single):
    ldr, _, _, aux = tiled
    ldr1, _, _, aux1 = single
    assert not torch.isnan(ldr).any()
    assert float(aux["rays"]) > 0
    assert (ldr - ldr1).abs().max().item() <= 1e-5
    assert abs(float(aux["rays"]) - float(aux1["rays"])) < 1e-3


@pytest.fixture(scope="module")
def cornell_32():
    scene = scenes.create_cornell_box("cpu")
    return (_run(scene, 32, 32, 2, True), _run(scene, 32, 32, 2, False))


def test_tiled_matches_single_device(cornell_32):
    _assert_tiled_equals_single(*cornell_32)


def test_denoised_screenshot_on_gathered_state(cornell_32):
    """The app's screenshot under --tiles: denoised_screenshot of the
    gathered G-buffer and the gathered HDR, as on one device."""
    (_, hdr, state, _), (_, hdr1, state1, _) = cornell_32
    got = denoised_screenshot(state["gb"], hdr, 32, 32)
    want = denoised_screenshot(state1["gb"], hdr1, 32, 32)
    assert not torch.isnan(got).any()
    assert (got - want).abs().max().item() <= 1e-5


def test_tiled_matches_single_device_full_halo():
    """Bands of 16 rows >= the 16-row halo > the 10 px tap radius: the
    spatial taps cross band borders through the exchanged rows. Also held
    to the reference's 8-band frame."""
    w, h = 16, 128
    assert h // BANDS >= tiles.DEFAULT_HALO
    ref_scene = ref_scenes.create_cornell_box()
    scene = convert.scene_from_reference(
        jax.tree_util.tree_map(np.asarray, ref_scene), "cpu")
    tiled = _run(scene, w, h, 2, True)
    _assert_tiled_equals_single(tiled, _run(scene, w, h, 2, False))

    mesh = ref_tiles.make_mesh()
    state = ref_tiles.shard_state(ref_pipeline.init_state(w, h), mesh)
    scene_r = ref_tiles.replicate(ref_scene, mesh)
    render = ref_tiles.make_render_frame_tiled(mesh, w, h)
    cam = camera_mod.CameraController()
    for f in range(2):
        u = ref_tiles.replicate(ref_renderer.camera_to_device(
            cam.uniform(w / h, f, ref_scene.num_lights)), mesh)
        ref_ldr, _, state, ref_aux = render(scene_r, u, jnp.uint32(f), state)
    p = psnr(tiled[0].numpy(), np.asarray(ref_ldr, np.float32))
    assert p >= FLOOR_DB, f"PSNR vs the reference's bands = {p:.2f} dB"
    assert abs(float(tiled[3]["rays"]) - float(ref_aux["rays"])) \
        <= 0.01 * float(ref_aux["rays"])


def test_tiled_matches_single_device_with_motion():
    """Camera motion at frame 2: temporal reprojection reads across band
    borders through the halo."""
    scene = scenes.create_cornell_box_diffuse("cpu")
    _assert_tiled_equals_single(_run(scene, 32, 32, 4, True, move_at=2),
                                _run(scene, 32, 32, 4, False, move_at=2))
