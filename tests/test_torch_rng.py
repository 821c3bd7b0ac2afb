"""The port's PCG streams against the reference's, bit for bit, over random
seeds and masks (the port runs them in int64 masked to 32 bits).

Only `random_unit_vector`'s x and y go through sin/cos, whose XLA:CPU and
PyTorch implementations differ by ulps: they are held to SINCOS_ULPS.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_raytracer.utils import rng as ref_rng
from tpu_raytracer_torch.utils import rng

SINCOS_ULPS = 4     # measured max 3 over 200k lanes


def _seeds(n=50000, seed=0):
    g = np.random.default_rng(seed)
    s = g.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    s[:4] = [0, 1, 0x7FFFFFFF, 0xFFFFFFFF]
    mask = g.uniform(size=n) > 0.4
    return s, mask


def _t(s):
    return torch.from_numpy(s.astype(np.int64))


def _u32(x):
    return np.asarray(x).astype(np.int64)


def test_pcg_hash_bit_equal():
    s, _ = _seeds()
    assert np.array_equal(rng.pcg_hash(_t(s)).numpy(),
                          _u32(ref_rng.pcg_hash(jnp.asarray(s))))


@pytest.mark.parametrize("name", ["rand", "rand_lcg"])
def test_stream_bit_equal(name):
    s, _ = _seeds(seed=1)
    state_p, state_r = _t(s), jnp.asarray(s)
    for _ in range(6):     # a chained stream, not one step
        state_p, v_p = getattr(rng, name)(state_p)
        state_r, v_r = getattr(ref_rng, name)(state_r)
        assert np.array_equal(state_p.numpy(), _u32(state_r))
        assert np.array_equal(v_p.numpy(), np.asarray(v_r))


@pytest.mark.parametrize("name", ["rand_if", "rand_lcg_if"])
def test_masked_stream_bit_equal(name):
    s, mask = _seeds(seed=2)
    g = np.random.default_rng(9)
    state_p, state_r = _t(s), jnp.asarray(s)
    for _ in range(6):
        m = mask & (g.uniform(size=mask.shape) > 0.3)
        state_p, v_p = getattr(rng, name)(state_p, torch.from_numpy(m))
        state_r, v_r = getattr(ref_rng, name)(state_r, jnp.asarray(m))
        assert np.array_equal(state_p.numpy(), _u32(state_r))
        assert np.array_equal(v_p.numpy(), np.asarray(v_r))
    assert (state_p.numpy() == s.astype(np.int64))[~mask].all()


def test_random_unit_vector_matches():
    s, _ = _seeds(seed=3)
    state_p, v_p = rng.random_unit_vector(_t(s))
    state_r, v_r = ref_rng.random_unit_vector(jnp.asarray(s))
    assert np.array_equal(state_p.numpy(), _u32(state_r))
    got, want = v_p.numpy(), np.asarray(v_r)
    assert np.array_equal(got[:, 2], want[:, 2])        # z: no sin/cos
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))
    assert ulps[:, :2].max() <= SINCOS_ULPS, ulps.max()


def test_halton_matches():
    for i in range(1, 40):
        for base in (2, 3):
            assert rng.halton(i, base) == ref_rng.halton(i, base)
