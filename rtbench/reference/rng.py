"""Per-lane PCG hash streams (restir.wgsl:132-150, 781-786).

Bit-exact port of `tpu_raytracer/utils/rng.py`. Every lane carries one
uint32 state. PyTorch has no uint32 `+`, `>>` or `>`, so states live in
int64 tensors holding values in [0, 2^32), and every step is masked back
to 32 bits. Products stay below 2^62, so nothing overflows int64.

  - ``rand``:      state' = pcg_hash(state); value = state' / (2^32-1)
  - ``rand_lcg``:  state' = state * A + C;  value = pcg_output(state')

Conditional draws (`rand_if`) advance only the lanes where ``mask`` holds:
that keeps each lane's consumption order equal to the reference's, which
seed-replay ReSTIR depends on.
"""

from __future__ import annotations

import math

import torch

_MUL = 747796405
_INC = 2891336453
_OUT = 277803737
_MASK = 0xFFFFFFFF
_INV_U32_MAX = 1.0 / 4294967295.0


def u32(x: torch.Tensor) -> torch.Tensor:
    """Any integer tensor -> int64 holding its uint32 bit pattern."""
    return x.to(torch.int64) & _MASK


def _pcg_output(state):
    word = (((state >> ((state >> 28) + 4)) ^ state) * _OUT) & _MASK
    return (word >> 22) ^ word


def pcg_hash(x):
    """restir.wgsl:132-136: LCG step + output mix."""
    return _pcg_output((u32(x) * _MUL + _INC) & _MASK)


def to_unit(state):
    return state.to(torch.float32) * _INV_U32_MAX


def rand(state):
    """Advance per-lane state; return (new_state, uniform f32 in [0, 1])."""
    new_state = pcg_hash(state)
    return new_state, to_unit(new_state)


def rand_if(state, mask):
    """`rand` on the lanes where ``mask`` holds; others keep their state
    and read 0.0."""
    new_state, value = rand(state)
    return torch.where(mask, new_state, state), torch.where(mask, value, 0.0)


def rand_lcg(state):
    """restir.wgsl:781-786: raw-LCG state, hashed output."""
    new_state = (state * _MUL + _INC) & _MASK
    return new_state, to_unit(_pcg_output(new_state))


def rand_lcg_if(state, mask):
    new_state, value = rand_lcg(state)
    return torch.where(mask, new_state, state), torch.where(mask, value, 0.0)


def halton(index: int, base: int) -> float:
    """Host-side Halton sequence (camera.rs:183-192)."""
    f, r, i = 1.0, 0.0, int(index)
    while i > 0:
        f /= base
        r += f * (i % base)
        i //= base
    return r
