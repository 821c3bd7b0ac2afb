"""Carry scenes and frame state from the JAX package into this one.

The reference's `CompiledScene` and `FrameState` arrive as numpy arrays
(convert each field with `np.asarray`); nothing here imports jax. Tests
use these to feed both packages the same scene and the same mid-run
state.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.trace_api import check_mode
from .ops.trace_mxu import mode_table
from .scene.resources import CompiledScene

_TABLES = ("tri_planes", "chunk_aabb", "tri_table", "mat_table",
           "light_table", "bvh_rec", "bvh_skip", "bvh_tri", "inst_table",
           "inst_aabb", "obj_group_aabb", "inst_group_span", "unit_inst",
           "unit_group",
           # the refit's tables (ops/refit.py)
           "bvh_left", "bvh_right", "bvh_depth", "bvh_tri_rows",
           "tri_table_local", "tri_inst", "tri_prim", "tri_local",
           "local_v0", "local_e1", "local_e2", "inst_mesh_id",
           "inst_transform", "inst_normal_mat")


def _tensor(x, device, dtype=None):
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":   # ml_dtypes bf16: exact through f32
        x, dtype = x.astype(np.float32), torch.bfloat16
    # np.array copies: arrays from jax are read-only
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)


def scene_from_reference(ref, device, kernel: str = "mxuf2",
                         incull: bool = False) -> CompiledScene:
    """A reference CompiledScene, flattened or instanced, whose array
    fields are numpy -> this package's CompiledScene on `device`, under
    the trace-kernel mode (kernel, incull) with the coefficient table K6
    reads built for it. The reference's 12-wide quad-packed texels
    [L, H, W, 12] keep their first texel, [..., :3]. The refit's tables
    come across with the rest; the fields the port does not read
    (coef48, whose place coef48_t takes, and inst_affine_inv, which
    inst_table holds) stay behind."""
    tables = {k: _tensor(getattr(ref, k), device) for k in _TABLES}
    return CompiledScene(
        **tables,
        materials={k: _tensor(v, device) for k, v in ref.materials.items()},
        lights={k: _tensor(v, device) for k, v in ref.lights.items()},
        color_tex=_tensor(np.asarray(ref.color_tex)[..., :3], device),
        data_tex=_tensor(np.asarray(ref.data_tex)[..., :3], device),
        num_lights=int(ref.num_lights),
        num_instances=int(ref.num_instances),
        bvh_max_depth=int(ref.bvh_max_depth),
        tex_channels=frozenset(ref.tex_channels),
        instanced=bool(ref.instanced),
        kernel=check_mode(kernel),
        incull=bool(incull),
        coef48_t=mode_table(tables["tri_planes"], kernel, incull,
                            bool(ref.instanced)),
    )


def state_from_reference(state: dict, device) -> dict:
    """Reference FrameState {"gb", "res", "accum"} (numpy) -> tensors.
    The packed layouts are shared, seed bit patterns included."""
    return {k: _tensor(np.asarray(state[k], np.float32), device)
            for k in ("gb", "res", "accum")}


def state_to_numpy(state: dict) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in state.items()}
