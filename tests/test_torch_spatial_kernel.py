"""K11, ReSTIR's spatial reuse (`csrc/spatial.cu`), built with g++ under
the host emulation `csrc/host/emulation/cuda_runtime.h`, driven through
one `restir.run_k11` call a case (its 7 launches with the plain tap
any-hit calls and the plain replay between them) and held to
`restir_spatial_plain` on the CPU.

The libm is taken out of the comparison: K11 is built with
-DTPURT_EMU_ROUNDED_LIBM (sinf and cosf rounded from double) and the
plain version runs under torch.sin, torch.cos and torch.sqrt rounded from
double the same way (its replay's too). Every output word is then equal:
the output reservoir (seed bits included), the HDR rows, ray_count and
diag; so are each tap's shadow rays as the any-hit call gets them and the
RNG word after each launch. That holds K11's f32 arithmetic, operation
order, constants, view addressing and RNG draws to the eager version's
exactly. Where a case's inputs hold a NaN, NaNs must fall on the same
words; their payloads are the host's and are not compared. A mutant of
K11 for each of these comparisons shows that the comparison catches it.
On the card K11 meets PyTorch's CUDA kernels, which call the same sinf,
cosf and sqrtf as its own; chip_smoke.py holds it to the eager route
there.
"""

import contextlib
import ctypes
from unittest import mock

import numpy as np
import pytest
import torch

from test_torch_kernel_emulation import _build
from tpu_raytracer_torch.models import scenes
from tpu_raytracer_torch.models.procedural_assets import write_truffle_glb
from tpu_raytracer_torch.ops import gbuffer, restir, trace_api
from tpu_raytracer_torch.parallel.views import BandView, PairBandView
from tpu_raytracer_torch.render import camera, pipeline, renderer
from tpu_raytracer_torch.utils import rng
from tpu_raytracer_torch.utils.vec3 import V3

SIZE = 32               # 32 x 32 lanes a frame
LAUNCHES = ["spatial_tap"] * restir.TAPS + ["spatial_close",
                                            "spatial_finish"]
BANDS, HALO = 4, 3      # a band's halo well under the taps' radius of 10
CASES = ("cornell_static", "cornell_moving", "truffle", "band_top",
         "band_mid", "pair_view", "edges")
COMPARISONS = ("reservoir", "hdr", "rays", "rng", "ray_count", "diag")
# (name, the comparison it must fail, the source text, its replacement)
MUTANTS = (
    ("rescale_bound", "reservoir",
     "if (m > MAX_M_SPATIAL) {", "if (m > MAX_M_SPATIAL + 10) {"),
    ("hdr_unweighted", "hdr", "hdr = mul(rad, w);", "hdr = rad;"),
    ("t_max_factor", "rays", "dist * F32(0.999)", "dist * F32(0.99)"),
    ("p_hat_zero_taken", "rays", "ok = ok && nb_p_hat > 0.0f;",
     "ok = ok && nb_p_hat >= 0.0f;"),
    ("r2_always_drawn", "rng",
     "const float r2 = it_active ? draw_lcg(st) : 0.0f;",
     "const float r2 = draw_lcg(st);"),
    ("ray_count_short", "ray_count", "for (int t = 0; t < TAPS; ++t)",
     "for (int t = 1; t < TAPS; ++t)"),
    ("cached_as_lanes", "diag", "*a.cached = F32(a.counts[C_CACHED]);",
     "*a.cached = F32(a.counts[C_LANES]);"),
)

# The tests run in several worker processes at once: one torch thread each
# keeps them from oversubscribing the cores.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return _build(tmp_path_factory.mktemp("k11_rounded"), ("spatial",),
                  defines=("TPURT_EMU_ROUNDED_LIBM",))


def _rounded(fn):
    return lambda x: fn(x.double()).float()


@contextlib.contextmanager
def _rounded_libm():
    """torch.sin, cos and sqrt rounded from double, as the rounded build's
    sinf, cosf and (IEEE) sqrtf give them."""
    with mock.patch.object(torch, "sin", _rounded(torch.sin)), \
            mock.patch.object(torch, "cos", _rounded(torch.cos)), \
            mock.patch.object(torch, "sqrt", _rounded(torch.sqrt)):
        yield


def _spatial_calls(scene, moves):
    """The restir_spatial arguments of each of len(moves) eager frames of
    `scene` at SIZE^2: a frame that moves the camera resets the counter
    and renders with static_ok off, as the app does; the others count up
    with static_ok on."""
    cam = camera.CameraController()
    state = pipeline.init_state(SIZE, SIZE, "cpu")
    real, calls = restir.restir_spatial, []

    def spy(*args):
        calls.append(args)
        return real(*args)

    fc = 0
    with mock.patch.object(restir, "restir_spatial", spy):
        for i, move in enumerate(moves):
            if move:
                cam.press("d")
                cam.update(0.05)
                cam.release("d")
                fc = 0
            uniform = renderer.camera_to_device(
                cam.uniform(1.0, fc, scene.num_lights), "cpu")
            _, _, state, _ = pipeline.render_frame(
                scene, uniform, fc, state, SIZE, SIZE,
                static_ok=i > 0 and not move)
            fc += 1
    return calls


@pytest.fixture(scope="module")
def cornell():
    """(scene, [the static frame's call, the moving frame's call])."""
    scene = scenes.create_cornell_box("cpu")
    calls = _spatial_calls(scene, (False, False, True))
    return scene, calls[1:]


@pytest.fixture(scope="module")
def truffle(tmp_path_factory):
    """The app's truffle scene on a small stand-in of its asset, and its
    second frame's call."""
    path = write_truffle_glb(str(tmp_path_factory.mktemp("truffle")
                                 / "truffle.glb"), nu=24, tex_size=32)
    scene = scenes.create_chocolate_truffle_scene("cpu", path=path)
    return scene, _spatial_calls(scene, (False, False))[1]


def _band_args(args, band, pair=False):
    """restir_spatial arguments of band `band` of BANDS, halo HALO, cut
    from a one-device call's: the comb view halo_exchange gives (zero
    rows outside the image; a PairBandView of its two tables with
    `pair`), the band's G-buffer and reservoir rows."""
    scene, gb, view, res, cam, fc, ctx = args
    width, height = ctx["width"], ctx["height"]
    band_h = height // BANDS
    y0 = band * band_h
    rows = view.data.reshape(height, width, -1)
    ext = rows.new_zeros((band_h + 2 * HALO, width, rows.shape[2]))
    lo, hi = max(y0 - HALO, 0), min(y0 + band_h + HALO, height)
    ext[lo - y0 + HALO:hi - y0 + HALO] = rows[lo:hi]
    ext = ext.reshape(-1, rows.shape[2])
    if pair:
        v = PairBandView(ext[:, :gbuffer.GB_COLS].clone(),
                         ext[:, gbuffer.GB_COLS:].clone(), y0, width, height,
                         band_h, HALO)
    else:
        v = BandView(ext, y0, width, height, band_h, HALO)
    own = slice(y0 * width, (y0 + band_h) * width)

    def cut(x):
        return V3(*(c[own] for c in x)) if isinstance(x, V3) else x[own]
    return (scene, {k: cut(x) for k, x in gb.items()}, v,
            {k: cut(x) for k, x in res.items()}, cam, fc,
            dict(ctx, y0=y0, band_h=band_h))


def _edges(args):
    """The static Cornell call with the lanes the frames do not show:
    invalid G-buffer lanes, neighbour rows with p_hat 0, NaN position and
    NaN first-vertex words in neighbour rows, own reservoirs of M over
    MAX_M_SPATIAL (the w_sum rescale), and cached lanes of zero radiance
    (p_hat 0 at the finalize); frame_count as a 0-dim tensor."""
    scene, gb, view, res, cam, fc, ctx = args
    g = np.random.default_rng(26)
    n = SIZE * SIZE

    def lanes(p):
        return torch.from_numpy(g.uniform(size=n) < p)
    gb = dict(gb, valid=gb["valid"] & ~lanes(0.1))
    data = view.data.clone()
    res_c = gbuffer.GB_COLS
    data[lanes(0.15), res_c + 4] = 0.0                       # p_hat
    data[lanes(0.05), gbuffer.GB_POS.start] = float("nan")
    data[lanes(0.05), res_c + 6] = float("nan")              # s_path.y
    view = BandView(data, view.y0, view.width, view.height, view.band_h,
                    view.halo)
    over = lanes(0.2)
    m = torch.where(over, torch.from_numpy(g.integers(21, 60, n)).int(),
                    res["M"])
    zero = lanes(0.1)
    rad = V3(*(torch.where(zero, 0.0, c) for c in res["rad"]))
    res = dict(res, M=m, rad=rad, rad_ok=res["rad_ok"] | zero)
    return (scene, gb, view, res, cam, torch.tensor(fc), ctx)


def _case(name, cornell, truffle):
    static, moving = cornell[1]
    if name == "cornell_static":
        return static
    if name == "cornell_moving":
        return moving
    if name == "truffle":
        return truffle[1]
    if name == "band_top":
        return _band_args(static, 0)
    if name == "band_mid":
        return _band_args(moving, 2)
    if name == "pair_view":
        return _band_args(moving, 1, pair=True)
    return _edges(static)


class _Recorder:
    """A K11 library whose launches go to `lib` and then record the lanes'
    RNG words (csrc/spatial.cu: SpatialArgs.rng)."""

    def __init__(self, lib):
        self.lib, self.rng = lib, []

    def _after(self, fn):
        def call(args, *rest):
            err = fn(args, *rest)
            a = restir.SpatialArgs.from_address(args)
            words = (ctypes.c_uint32 * a.R).from_address(a.rng)
            self.rng.append(np.array(words, dtype=np.int64))
            return err
        return call

    def __getattr__(self, name):
        fn = getattr(self.lib, name)
        return self._after(fn) if name != "tpurt_spatial_finish" else fn


@contextlib.contextmanager
def _spied():
    """Records each tap's shadow rays (o, d [3, R], t_max, active) as the
    any-hit call gets them, and the raw-LCG state after each of the
    plain version's draws."""
    rays, states = [], []
    occluded, draw = restir.scene_occluded, rng.rand_lcg_if

    def occ(scene, o, d, t_min, t_max, active=None, reorder="none"):
        assert t_min == 1e-3
        rays.append((torch.stack(list(o)).clone(),
                     torch.stack(list(d)).clone(), t_max.clone(),
                     active.clone()))
        return occluded(scene, o, d, t_min, t_max, active=active,
                        reorder=reorder)

    def lcg(state, mask):
        out = draw(state, mask)
        states.append(out[0].clone())
        return out
    with mock.patch.object(restir, "scene_occluded", occ), \
            mock.patch.object(rng, "rand_lcg_if", lcg):
        yield rays, states


def _run(lib, args):
    """Both routes on `args`: (plain outputs, its tap rays, its RNG states
    after each launch's last draw), and the same of K11."""
    with _rounded_libm():
        with _spied() as (rays, states):
            want = restir.restir_spatial_plain(*args)
        # launch t ends after tap t's two draws (and tap t - 1's merge
        # draw), close after tap 4's merge draw
        want_rng = [states[k] for k in (1, 4, 7, 10, 13, 14)]
        rec, names = _Recorder(lib), []
        with _spied() as (k_rays, k_states):
            got = restir.run_k11(rec, None, names.append, *args)
    assert names == LAUNCHES
    assert not k_states
    return (want, rays, want_rng), (got, k_rays, rec.rng)


def _same(got, want):
    """Every word equal, NaNs on the same words."""
    if got.shape != want.shape or got.dtype != want.dtype:
        return False
    if got.dtype == torch.float32:
        nan = torch.isnan(want)
        if not torch.equal(torch.isnan(got), nan):
            return False
        return torch.equal(got.view(torch.int32)[~nan],
                           want.view(torch.int32)[~nan])
    return torch.equal(got, want)


def _failures(plain, k11):
    """The comparisons of COMPARISONS that K11's run fails."""
    (want, rays, want_rng), (got, k_rays, got_rng) = plain, k11
    (w_res, w_hdr, w_rays, w_diag), (g_res, g_hdr, g_rays, g_diag) = want, got
    bad = set()
    if set(g_res) != set(w_res) or not all(
            _same(g, w) for k in w_res
            for g, w in (zip(g_res[k], w_res[k]) if isinstance(w_res[k], V3)
                         else [(g_res[k], w_res[k])])):
        bad.add("reservoir")
    if not _same(g_hdr, w_hdr):
        bad.add("hdr")
    if len(k_rays) != len(rays) or not all(
            _same(g, w) for gt, wt in zip(k_rays, rays)
            for g, w in zip(gt, wt)):
        bad.add("rays")
    if len(got_rng) != len(want_rng) or not all(
            np.array_equal(g, w.numpy()) for g, w in zip(got_rng, want_rng)):
        bad.add("rng")
    if not _same(g_rays, w_rays):
        bad.add("ray_count")
    if set(g_diag) != set(w_diag) or not all(
            _same(g_diag[k], w_diag[k]) for k in w_diag):
        bad.add("diag")
    return bad


def _read_cols_seen(view):
    """Wraps the view's read_cols to record each read's (gy, valid)."""
    seen, real = [], view.read_cols

    def spy(gy, gx):
        out = real(gy, gx)
        seen.append((gy.clone(), out[1].clone()))
        return out
    view.read_cols = spy
    return seen


def _check_case(name, args, plain):
    """The case holds what it is there for."""
    scene, gb, view, res, _, _, ctx = args
    want, rays, _ = plain
    assert float(want[2]) > 0 and bool(want[3]["lanes"] > 0)
    active = torch.stack([r[3] for r in rays])
    assert active.any(1).all()                  # every tap traced rays
    mat = scene.mat_table[gb["mat_id"].long()]
    if name == "cornell_static":
        assert res["rad_ok"].any() and float(want[3]["cached"]) > 0
    if name == "truffle":
        valid = gb["valid"]
        specular = (mat[:, 7] < 0.1) | (mat[:, 8] > 0.9)
        assert (valid & specular).any() and (valid & ~specular).any()
        assert (valid & (mat[:, 8] > 0.8)).any()
    if name in ("band_top", "band_mid", "pair_view"):
        assert view.halo == HALO and ctx["band_h"] == SIZE // BANDS
    if name == "edges":
        assert (~gb["valid"]).any() and (res["M"] > restir.MAX_M_SPATIAL).any()
        assert torch.isnan(torch.stack([r[1] for r in rays])).any()
        assert (want[0]["rad_ok"] & (want[0]["p_hat"] == 0)).any()


@pytest.mark.parametrize("case", CASES)
def test_k11_against_plain(lib, cornell, truffle, case):
    args = _case(case, cornell, truffle)
    plain, k11 = _run(lib, args)
    _check_case(case, args, plain)
    assert not _failures(plain, k11), (case, _failures(plain, k11))


def test_k11_band_reads_outside_coverage(lib, cornell):
    """A band's taps read its halo rows and fall outside its coverage
    where they reach past the halo inside the image; K11 reads them as
    the view does."""
    args = _band_args(cornell[1][0], 1)
    view = args[2]
    seen = _read_cols_seen(view)
    plain, k11 = _run(lib, args)
    assert not _failures(plain, k11)
    gy = torch.cat([s[0] for s in seen])
    valid = torch.cat([s[1] for s in seen])
    y0, band_h = args[6]["y0"], args[6]["band_h"]
    in_halo = ((gy < y0) & (gy >= y0 - HALO)) \
        | ((gy >= y0 + band_h) & (gy < y0 + band_h + HALO))
    assert (in_halo & valid).any()
    outside = ((gy < y0 - HALO) | (gy >= y0 + band_h + HALO)) \
        & (gy >= 0) & (gy < SIZE)
    assert outside.any() and not (outside & valid).any()


def test_k11_every_comparison_has_a_mutant():
    assert sorted({m[1] for m in MUTANTS}) == sorted(COMPARISONS)


@pytest.mark.parametrize("mutant", MUTANTS, ids=[m[0] for m in MUTANTS])
def test_k11_mutant_is_caught(tmp_path, cornell, mutant):
    """Each comparison catches a mutant of K11 aimed at it."""
    name, comparison, old, new = mutant
    lib = _build(tmp_path, ("spatial",), defines=("TPURT_EMU_ROUNDED_LIBM",),
                 edits={"spatial": (old, new)})
    plain, k11 = _run(lib, _edges(cornell[1][0]))
    assert comparison in _failures(plain, k11), name


def test_k11_dispatch_cpu_plain(cornell, monkeypatch):
    """CPU tensors take the plain route, and launch nothing."""
    args = cornell[1][0]

    def refuse(*a, **k):
        raise AssertionError("restir_spatial_kernel on CPU tensors")

    trace_api.reset_launch_counts()
    want = restir.restir_spatial_plain(*args)
    monkeypatch.setattr(restir, "restir_spatial_kernel", refuse)
    got = restir.restir_spatial(*args)
    assert _same(got[1], want[1]) and _same(got[2], want[2])
    assert not any(trace_api.LAUNCHES[k] for k in set(LAUNCHES))


class _NoLib:
    """A library whose K11 must not be reached."""

    def __getattr__(self, name):
        raise AssertionError("K11 launched on inputs it does not take")


def _misuse(kind, args):
    scene, gb, view, res, cam, fc, ctx = args
    if kind == "view_type":
        view = view.data
    elif kind == "view_dtype":
        view = BandView(view.data.double(), view.y0, view.width,
                        view.height, view.band_h, view.halo)
    elif kind == "view_cols":
        view = BandView(view.data[:, :20], view.y0, view.width, view.height,
                        view.band_h, view.halo)
    elif kind == "view_rows":   # the view's geometry is not its rows'
        view = BandView(view.data, view.y0, view.width, view.height,
                        view.band_h, 2)
    elif kind == "view_stride":  # columns not adjacent
        view = BandView(view.data.t().contiguous().t(), view.y0, view.width,
                        view.height, view.band_h, view.halo)
    elif kind == "pair_cols":
        c = gbuffer.GB_COLS
        view = PairBandView(view.data[:, :c - 1], view.data[:, c:], view.y0,
                            view.width, view.height, view.band_h, view.halo)
    elif kind == "device":
        res = dict(res, w_sum=res["w_sum"].to("meta"))
    elif kind == "gb_dtype":
        gb = dict(gb, mat_id=gb["mat_id"].long())
    elif kind == "frame_dtype":
        fc = torch.tensor(fc, dtype=torch.int32)
    elif kind == "band_h":      # the G-buffer is not the context's band
        ctx = dict(ctx, band_h=ctx["band_h"] - 1)
    return scene, gb, view, res, cam, fc, ctx


@pytest.mark.parametrize("kind", ("view_type", "view_dtype", "view_cols",
                                  "view_rows", "view_stride", "pair_cols",
                                  "device", "gb_dtype", "frame_dtype",
                                  "band_h"))
def test_k11_refuses_misuse(cornell, kind):
    """Inputs K11 does not take raise before any launch: the CUDA route
    never falls back to the eager version."""
    with pytest.raises(ValueError):
        restir.run_k11(_NoLib(), None, None, *_misuse(kind, cornell[1][0]))


def test_k11_wants_cuda(cornell):
    with pytest.raises(ValueError, match="CUDA"):
        restir.restir_spatial_kernel(*cornell[1][0])
