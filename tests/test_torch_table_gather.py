"""The port's table gather (`ops/table_gather.py`, kernel K7's plain
version) and the row fetches that go through it (`ops/hit.py:fetch_cols`)
against the reference's `ops/pallas_gather.py`.

Tolerance: exact, bit for bit. A gather is a copy, and integer columns
ride as their 32-bit patterns (`pack_table`), so any difference is a
fault. The port's tables are [M, C]; the reference's [C, T], so the port
gathers from the transposed table.

Kernel K7 itself runs only on the card (`chip_smoke.py` holds it to this
plain version there); `tests/test_torch_kernel_emulation.py` holds its
source to it under the host emulation.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from tpu_raytracer.ops import pallas_gather as ref_gather
from tpu_raytracer_torch.models import scenes
from tpu_raytracer_torch.ops import hit, table_gather, trace_api

# The tests run in several worker processes at once: one torch thread each
# keeps them from oversubscribing the cores.
torch.set_num_threads(1)


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _packed(seed, c, t):
    """pack_table of c - 1 float columns spanning many exponents and one
    int column (negative ids included), [C, Tp] with Tp % 128 == 0."""
    g = np.random.default_rng(seed)
    cols = [(g.standard_normal(t) * np.exp(g.uniform(-20, 20, t)))
            .astype(np.float32) for _ in range(c - 1)]
    cols.insert(c // 2, g.integers(-5, 1 << 30, t).astype(np.int32))
    return ref_gather.pack_table(cols)


@pytest.mark.parametrize("c,t,r", [(35, 1320, 1000), (17, 100, 4097),
                                   (15, 3, 130), (23, 1408, 4096 + 129)])
def test_plain_matches_reference(c, t, r):
    """Against the reference's `table_gather` (its CPU branch) at R not a
    multiple of 128 or 4,096, with negative indices and indices past the
    table's rows, which both clamp."""
    packed = _packed(c, c, t)
    tp = packed.shape[1]
    g = np.random.default_rng(t)
    idx = g.integers(-50, tp + 50, r).astype(np.int32)
    idx[:3] = (-1, tp, -(1 << 31))
    want = ref_gather.table_gather(jnp.asarray(packed), jnp.asarray(idx))
    got = table_gather.table_gather_plain(
        torch.from_numpy(packed.T.copy()), torch.from_numpy(idx))
    assert got.shape == (c, r) and got.is_contiguous()
    assert np.array_equal(_bits(got), _bits(want))
    assert np.array_equal(_bits(got)[:, 0], _bits(packed)[:, 0])
    assert np.array_equal(_bits(got)[:, 1], _bits(packed)[:, tp - 1])


def test_plain_matches_tpu_kernel_interpret():
    """Against `_gather_kernel` itself, run by `pl.pallas_call(...,
    interpret=True)` with its wrapper's specs (pallas_gather.py:99-111)
    at C = 35, T = 256, R = 4,096."""
    c, t, r = 35, 256, 4096
    packed = _packed(1, c, t)
    tp = packed.shape[1]
    idx = np.random.default_rng(2).integers(0, t, r).astype(np.int32)
    kernel = functools.partial(ref_gather._gather_kernel,
                               num_blocks=tp // ref_gather.BLOCK, num_cols=c)
    sub = ref_gather.RAY_TILE_SUBLANES
    out = pl.pallas_call(
        kernel,
        grid=(r // ref_gather.RAY_TILE,),
        in_specs=[
            pl.BlockSpec((c, tp // ref_gather.BLOCK, ref_gather.BLOCK),
                         lambda b: (0, 0, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((sub, 128), lambda b: (b, 0),
                         memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((sub, c, 128), lambda b: (b, 0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((r // 128, c, 128), jnp.float32),
        interpret=True,
    )(jnp.asarray(packed).reshape(c, tp // ref_gather.BLOCK,
                                  ref_gather.BLOCK),
      jnp.asarray(idx).reshape(r // 128, 128))
    want = jnp.moveaxis(out, 1, 0).reshape(c, r)
    got = table_gather.table_gather_plain(torch.from_numpy(packed.T.copy()),
                                          torch.from_numpy(idx))
    assert np.array_equal(_bits(got), _bits(want))


@pytest.fixture(scope="module")
def cornell():
    return scenes.create_cornell_box("cpu")


@pytest.fixture(scope="module")
def gallery():
    return scenes.create_instancing_gallery_scene("cpu", n=9, subdiv=2)


@pytest.mark.parametrize("which,name", [
    ("cornell", "tri_table"), ("cornell", "mat_table"),
    ("cornell", "light_table"), ("gallery", "inst_table"),
    ("gallery", "tri_table")])
def test_fetch_cols_values_and_layout(request, which, name):
    """fetch_cols on CPU returns the rows that plain indexing returned
    before it went through the gather, now as contiguous [R] columns."""
    table = getattr(request.getfixturevalue(which), name)
    m, c = table.shape
    idx = torch.from_numpy(np.random.default_rng(3).integers(
        0, m, 777).astype(np.int32))
    cols = hit.fetch_cols(table, idx)
    rows = table[idx.to(torch.int64)]
    assert len(cols) == c
    for k, col in enumerate(cols):
        assert col.shape == (777,) and col.is_contiguous()
        assert col.stride() == (1,)
        assert np.array_equal(_bits(col), _bits(rows[:, k]))


def test_cpu_gather_never_launches_and_checks_arguments(cornell):
    trace_api.reset_launch_counts()
    table = cornell.mat_table
    idx = torch.tensor([0, -3, 99], dtype=torch.int32)
    out = table_gather.table_gather(table, idx)
    assert out.shape == (table.shape[1], 3)
    assert torch.equal(out[:, 1], table[0]) and torch.equal(out[:, 2],
                                                            table[-1])
    assert trace_api.LAUNCHES["table_gather"] == 0
    empty = table_gather.table_gather(table, idx[:0])
    assert empty.shape == (table.shape[1], 0)
    with pytest.raises(ValueError, match="int32"):
        table_gather.table_gather(table, idx.to(torch.int64))
    with pytest.raises(ValueError, match="M >= 1"):
        table_gather.table_gather(table[:0], idx)
    with pytest.raises(ValueError, match="CUDA"):
        table_gather.table_gather_kernel(table, idx)
