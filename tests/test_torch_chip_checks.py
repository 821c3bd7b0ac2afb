"""The comparators `chip_smoke.py` holds the kernels to on the card, on CPU
tensors: each reads equal inputs as no difference, and one flipped ulp,
triangle id, state word or occluded lane as a difference. A comparator
that read every input as equal would pass every check on the card that
uses it.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as smoke  # noqa: E402

# The tests run in several worker processes at once: one torch thread each
# keeps them from oversubscribing the cores.
torch.set_num_threads(1)

R = 64      # lanes


def _f32(seed, *shape):
    g = np.random.default_rng(seed)
    return torch.from_numpy(g.uniform(0.1, 5.0, shape).astype(np.float32))


def _nudged(x, index, ulps=1):
    """x with the word at `index` moved by `ulps` ulps."""
    bits = x.clone().view(torch.int32)
    bits[index] += ulps
    return bits.view(torch.float32)


def _hits(seed=0):
    """A closest-hit answer: tri (-1 a miss), inst and t, with lane 0 a
    hit and lane 1 a miss."""
    g = np.random.default_rng(seed)
    tri = g.integers(-1, 50, R).astype(np.int32)
    tri[0], tri[1] = 7, -1
    return {"tri": torch.from_numpy(tri), "inst": torch.from_numpy(tri // 4),
            "t": _f32(seed + 1, R)}


def _with(res, **fields):
    return {**{k: v.clone() for k, v in res.items()}, **fields}


def _flipped_tri(res, lanes):
    tri = res["tri"].clone()
    tri[lanes] = tri[lanes] + 1 + (tri[lanes] < 0).to(torch.int32)
    return _with(res, tri=tri)


def _ulps():
    a = _f32(0, R).numpy()
    assert not smoke._ulps(a, a.copy()).any()
    b = _nudged(torch.from_numpy(a), 5).numpy()
    diff = smoke._ulps(b, a)
    assert diff[5] == 1 and np.count_nonzero(diff) == 1


def _check_closest():
    want = _hits()
    assert smoke._check_closest("case", _with(want), want) == 0
    assert smoke._check_closest("case", _with(
        want, t=_nudged(want["t"], 0)), want) == 1
    with pytest.raises(AssertionError, match="ulps"):
        smoke._check_closest("case", _with(
            want, t=_nudged(want["t"], 0, smoke.T_ULPS + 1)), want)
    with pytest.raises(AssertionError, match="tri differs on 1 lanes"):
        smoke._check_closest("case", _flipped_tri(want, [0]), want)
    inst = want["inst"].clone()
    inst[0] += 1
    with pytest.raises(AssertionError, match="inst differs on 1 lanes"):
        smoke._check_closest("case", _with(want, inst=inst), want,
                             ("tri", "inst"))


def _compare_plain():
    want = _hits()
    same = smoke._compare(_with(want), want)
    assert same["hit"] == same["tri"] == 1.0
    assert same["hit_diff"] == same["tri_diff"] == 0
    assert same["max"] == same["median"] == same["abs"] == 0.0
    smoke._check_plain("case", same, any_hit=False)
    moved = smoke._compare(_with(want, t=_nudged(want["t"], 0)), want)
    assert moved["max"] > 0.0 and moved["abs"] > 0.0
    missed = _with(want, tri=torch.where(torch.arange(R) == 0, -1,
                                         want["tri"]))
    assert smoke._compare(missed, want)["hit_diff"] == 1
    hit = torch.nonzero(want["tri"] >= 0).squeeze(1)
    assert smoke._compare(_flipped_tri(want, hit[:1]), want)["tri_diff"] == 1
    many = smoke._compare(_flipped_tri(want, hit[:smoke.PLAIN_DIFF + 1]),
                          want)
    with pytest.raises(AssertionError, match="outside tolerance"):
        smoke._check_plain("case", many, any_hit=False)


def _compare_agree():
    want = _hits()
    smoke._check_agree("case", smoke._compare(_with(want), want), False)
    missed = _with(want, tri=torch.full((R,), -1, dtype=torch.int32))
    with pytest.raises(AssertionError, match="outside tolerance"):
        smoke._check_agree("case", smoke._compare(missed, want), True)


def _occlusion_check():
    t_max = _f32(2, R)
    occluded = torch.arange(R) % 3 == 0
    got = {"tri": torch.where(occluded, 1, -1), "t": t_max.clone()}
    smoke._occlusion_check(torch, "case", got, occluded, t_max)
    flipped = occluded.clone()
    flipped[4] = ~flipped[4]
    with pytest.raises(AssertionError, match="on 1 lanes"):
        smoke._occlusion_check(torch, "case", got, flipped, t_max)
    with pytest.raises(AssertionError, match="t is not t_max"):
        smoke._occlusion_check(torch, "case", _with(
            got, t=_nudged(t_max, 0)), occluded, t_max)


def _word_gap():
    a = _f32(3, R)
    assert smoke._word_gap(torch, a, a.clone()) == (0.0, True)
    gap, same = smoke._word_gap(torch, _nudged(a, 9), a)
    assert gap > 0.0 and not same
    # equal values in other words: 0.0 and -0.0
    assert smoke._word_gap(torch, torch.zeros(R), -torch.zeros(R)) == \
        (0.0, False)
    n = torch.arange(R, dtype=torch.int32)
    assert smoke._word_gap(torch, n, n.clone())[1]
    assert not smoke._word_gap(torch, n + (n == 3).to(torch.int32), n)[1]


def _word_diff():
    def frame(seed):
        return (_f32(seed, R, 3), _f32(seed + 1, R, 3),
                {"accum": _f32(seed + 2, R, 3),
                 "seed": torch.arange(R, dtype=torch.int32)},
                {"rays": torch.tensor(float(R))})

    want = frame(4)
    assert smoke._word_diff(torch, frame(4), want) == (0, 0.0)
    got = frame(4)
    got[2]["seed"][7] += 1
    assert smoke._word_diff(torch, got, want) == (1, 1.0)
    got = frame(4)
    got = (_nudged(got[0], (2, 1)), *got[1:])
    diff, gap = smoke._word_diff(torch, got, want)
    assert diff == 1 and gap > 0.0


def _k9_diff():
    def outputs():
        return {"radiance": _f32(5, R, 3), "v1_pos": _f32(6, R, 3),
                "v1_normal": _f32(7, R, 3),
                "state": torch.arange(R, dtype=torch.int32),
                "valid_v1": torch.arange(R) % 2 == 0}

    want = outputs()
    for k, (lanes, n, err, ulps) in smoke._k9_diff(torch, outputs(),
                                                   want).items():
        assert (lanes, n, err, ulps) == (R, R, 0.0, 0), k
    got = outputs()
    got["radiance"] = _nudged(got["radiance"], (3, 2))
    got["state"][11] += 1
    got["valid_v1"][12] = ~got["valid_v1"][12]
    diff = smoke._k9_diff(torch, got, want)
    assert diff["radiance"][0] == R - 1 and diff["radiance"][3] == 1
    assert diff["radiance"][2] > 0.0
    assert diff["state"][0] == R - 1 and diff["valid_v1"][0] == R - 1
    assert diff["v1_pos"][0] == diff["v1_normal"][0] == R


def _k10_diff():
    want = (_f32(8, R, 3), _f32(9, R, 3))
    same = smoke._k10_diff(torch, tuple(x.clone() for x in want), want)
    assert same == [(3 * R, 3 * R, 0.0, 0)] * 2
    got = (want[0].clone(), _nudged(want[1], (0, 0)))
    ldr, accum = smoke._k10_diff(torch, got, want)
    assert ldr == (3 * R, 3 * R, 0.0, 0)
    assert accum[0] == 3 * R - 1 and accum[2] > 0.0 and accum[3] == 1


def _k11_diff():
    res = {"y": torch.arange(R, dtype=torch.int64), "w_sum": _f32(11, R),
           "s_path": tuple(_f32(12 + k, R) for k in range(3)),
           "rad_ok": torch.ones(R, dtype=torch.bool)}
    want = (res, _f32(15, R, 3), _f32(16), {"cached": _f32(17)})

    def copy(out):
        r, hdr, rays, diag = out
        return ({k: tuple(c.clone() for c in v) if isinstance(v, tuple)
                 else v.clone() for k, v in r.items()}, hdr.clone(),
                rays.clone(), {k: v.clone() for k, v in diag.items()})
    diff = smoke._k11_diff(torch, copy(want), want)
    assert all(d[0] == d[1] and d[2] == 0.0 for d in diff.values())
    got = copy(want)
    got[0]["s_path"] = (got[0]["s_path"][0], _nudged(got[0]["s_path"][1],
                                                     (3,)),
                        got[0]["s_path"][2])
    got[0]["y"][5] += 1
    diff = smoke._k11_diff(torch, got, want)
    assert diff["s_path.y"][:2] == (R - 1, R) and diff["s_path.y"][2] > 0.0
    assert diff["y"][:2] == (R - 1, R)
    assert all(d[0] == d[1] for k, d in diff.items()
               if k not in ("s_path.y", "y"))


def _psnr():
    a = _f32(10, 16, 16, 3).numpy() / 5.0
    assert smoke._psnr(a, a.copy()) == float("inf")
    b = a.copy()
    b[3, 4, 1] += 0.5
    assert np.isfinite(smoke._psnr(b, a))


CASES = {f.__name__.lstrip("_"): f for f in (
    _ulps, _check_closest, _compare_plain, _compare_agree, _occlusion_check,
    _word_gap, _word_diff, _k9_diff, _k10_diff, _k11_diff, _psnr)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_comparator_reads_one_word_off(case):
    CASES[case]()
