"""The port's screenshot path against the reference's: the a-trous
denoiser (`ops/denoise.py`), `resolve_tonemap`, the image helpers
(`utils/image.py`) and the screenshot module (`app/screenshot.py`).

Tolerances, each with its reason:
  - atrous_denoise and denoised_screenshot: DENOISE_RTOL relative to the
    image's peak. XLA:CPU has its own exp and pow (`max(dot, 0) ** 12`)
    and, jitted (`_denoised_jit`), contracts the weighted sums into FMAs;
    eager PyTorch does neither, so each weight differs by ulps and the
    normalised sum by a few more. atrous_denoise is compared with the
    reference run op by op, as tests/test_render.py runs it (measured max
    1.4e-7 over 1-4 levels); denoised_screenshot with the jitted
    `_denoised_jit` (measured 3.0e-7).
  - resolve_tonemap, psnr and linear_to_srgb_u8: exact (the same IEEE
    operations in the same order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_raytracer.app import screenshot as ref_screenshot
from tpu_raytracer.ops import denoise as ref_denoise
from tpu_raytracer.ops import post as ref_post
from tpu_raytracer.utils import image as ref_image
from tpu_raytracer_torch import convert
from tpu_raytracer_torch.app import screenshot
from tpu_raytracer_torch.models import scenes
from tpu_raytracer_torch.ops import denoise, post
from tpu_raytracer_torch.render import camera, pipeline, renderer
from tpu_raytracer_torch.utils import image, png

DENOISE_RTOL = 1e-5
H, W = 32, 48          # not square: an H/W swap shows

# The tests run in several worker processes at once: one torch thread each
# keeps them from oversubscribing the cores.
torch.set_num_threads(1)


def _guides(seed, h=H, w=W):
    """Random HDR and G-buffer planes with structure for the edge stops:
    two albedo regions, normals from a smooth field and a few steps in
    position."""
    g = np.random.default_rng(seed)
    hdr = g.gamma(1.0, 0.5, (h, w, 3)).astype(np.float32)
    albedo = np.where(np.arange(w)[None, :, None] < w // 3, 0.8, 0.2)
    albedo = (albedo * g.uniform(0.9, 1.0, (h, w, 3))).astype(np.float32)
    albedo[::7, ::5] = 0.0          # black texels: the 1e-3 clamp
    yy, xx = np.meshgrid(np.linspace(-1, 1, h), np.linspace(-1, 1, w),
                         indexing="ij")
    octn = np.stack([0.6 * np.sin(3 * xx), 0.6 * np.cos(2 * yy)], -1)
    octn[h // 2:, :, 0] *= -1.3      # a crease, and folded normals
    pos = np.stack([xx, yy, np.where(xx > 0.3, 1.0, 0.0)], -1)
    pos += g.normal(0, 0.01, pos.shape)
    return (hdr, albedo, octn.astype(np.float32), pos.astype(np.float32))


def _assert_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < DENOISE_RTOL, err


@pytest.mark.parametrize("iterations", [1, 2, 3, 4])
def test_atrous_denoise_matches_reference(iterations):
    args = _guides(iterations)
    want = ref_denoise.atrous_denoise(*map(jnp.asarray, args), iterations)
    got = denoise.atrous_denoise(*map(torch.from_numpy, args), iterations)
    assert got.shape == (H, W, 3)
    _assert_close(got, want)


def test_resolve_tonemap_matches_reference():
    c = np.random.default_rng(5).gamma(1.0, 2.0, (H, W, 3)).astype(
        np.float32)
    want = np.asarray(ref_post.resolve_tonemap(jnp.asarray(c)))
    got = post.resolve_tonemap(torch.from_numpy(c)).numpy()
    assert np.array_equal(got, want)
    assert got.max() < 1.0


def test_denoiser_reduces_noise():
    """tests/test_render.py::test_denoiser_reduces_noise on the port: a
    flat grey plane plus noise loses 80% of its error."""
    h = w = 32
    rng = np.random.default_rng(0)
    clean = np.tile([[0.5, 0.4, 0.3]], (h * w, 1)).astype(np.float32)
    noisy = clean + rng.normal(0, 0.3, clean.shape).astype(np.float32)
    albedo = np.ones((h, w, 3), np.float32)
    octn = np.zeros((h, w, 2), np.float32)   # all normals = +Z
    pos = np.zeros((h, w, 3), np.float32)    # flat plane
    out = denoise.atrous_denoise(
        torch.from_numpy(noisy.reshape(h, w, 3)), torch.from_numpy(albedo),
        torch.from_numpy(octn), torch.from_numpy(pos)).numpy()
    err_before = np.abs(noisy - clean).mean()
    err_after = np.abs(out - clean.reshape(h, w, 3)).mean()
    assert err_after < err_before * 0.2


def test_denoised_screenshot_matches_reference():
    """A port frame's packed G-buffer and HDR at 32^2, carried to the
    reference by convert.state_to_numpy, through the reference's
    `_denoised_jit` and the port's `denoised_screenshot`."""
    size = 32
    scene = scenes.create_cornell_box("cpu")
    cam = camera.CameraController()
    state = pipeline.init_state(size, size, "cpu")
    u = renderer.camera_to_device(cam.uniform(1.0, 0, scene.num_lights),
                                  "cpu")
    _, hdr, state, _ = pipeline.render_frame(scene, u, 0, state, size, size)
    rows = convert.state_to_numpy(state)["gb"]
    want = ref_screenshot._denoised_jit(jnp.asarray(rows),
                                        jnp.asarray(hdr.numpy()), size,
                                        size, 4)
    got = screenshot.denoised_screenshot(state["gb"], hdr, size, size)
    assert got.shape == (size, size, 3)
    _assert_close(got, want)
    # the filter moved the image: a wrong unpack would leave it be
    assert np.abs(got.numpy() - hdr.reshape(size, size, 3).numpy()).max() \
        > 1e-3


def test_image_helpers_match_reference():
    g = np.random.default_rng(6)
    img = g.uniform(-0.2, 1.3, (H, W, 3)).astype(np.float32)
    assert np.array_equal(image.linear_to_srgb_u8(img),
                          ref_image.linear_to_srgb_u8(img))
    other = img + g.normal(0, 0.01, img.shape).astype(np.float32)
    assert image.psnr(img, other) == ref_image.psnr(img, other)
    assert image.psnr(img, other, peak=2.0) == ref_image.psnr(img, other,
                                                              peak=2.0)
    assert image.psnr(img, img) == float("inf")


def test_screenshot_saver_writes_png(tmp_path):
    """The saver's PNG decodes back to the u8 image it encoded; a tensor
    is taken as well as an array."""
    img = np.random.default_rng(7).uniform(0, 1, (H, W, 3)).astype(
        np.float32)
    saver = screenshot.ScreenshotSaver(str(tmp_path))
    assert saver.submit(torch.from_numpy(img), label="shot")
    saver.flush()
    (path,) = tmp_path.glob("shot_*.png")
    assert saver.saved == 1
    back = png.decode(path.read_bytes())
    assert back.shape == (H, W, 4)
    assert np.array_equal(back[..., :3], image.linear_to_srgb_u8(img))
    assert (back[..., 3] == 255).all()
