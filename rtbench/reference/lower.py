"""The controls' precision: float32 results of PyTorch operations rounded
to bfloat16, the step below the float32 the configurations state. Run
the reference under a control's mode (`CONTROLS`) and it computes its
frame in bfloat16 arithmetic, stored as float32.

  bf16           every operation of the frame, the scene's tables and
                 the camera uniform included
  bf16_shading   the shading alone: the scene's tables, the camera
                 uniform, the primary rays and every trace stay exact
                 float32 (`rays()` blocks), as a program that kept its
                 rays in float32 and shaded in bfloat16 would
"""

from __future__ import annotations

import contextlib

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                         _disable_current_modes,
                                         _get_current_dispatch_mode)
from torch.utils._pytree import tree_map


def _round(x):
    return x.to(torch.bfloat16).to(torch.float32)


class Bf16(TorchDispatchMode):
    """Rounds results to bfloat16: a new float32 tensor is replaced by
    its rounding, a float32 tensor written in place is rounded where it
    lies, and views are left alone (their base was rounded). With
    `rays=False`, `rays()` blocks run unrounded."""

    def __init__(self, rays: bool = True):
        super().__init__()
        self.rays = rays

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        schema = func._schema
        if any(r.alias_info is not None for r in schema.returns):
            for a, arg in zip(schema.arguments, args):
                if (a.alias_info is not None and a.alias_info.is_write
                        and isinstance(arg, torch.Tensor)
                        and arg.dtype == torch.float32):
                    arg.copy_(_round(arg))
            return out
        return tree_map(lambda x: _round(x) if isinstance(x, torch.Tensor)
                        and x.dtype == torch.float32 else x, out)


CONTROLS = {"bf16": Bf16, "bf16_shading": lambda: Bf16(rays=False)}


def exact():
    """A block that runs unrounded: the trace's box culling, which
    decides only which (ray, chunk) pairs are tested and must stay
    conservative at any precision."""
    return _disable_current_modes()


def rays():
    """A block of the scene's tables, the camera or the trace: unrounded
    under a control that rounds the shading alone."""
    mode = _get_current_dispatch_mode()
    if isinstance(mode, Bf16) and not mode.rays:
        return _disable_current_modes()
    return contextlib.nullcontext()
