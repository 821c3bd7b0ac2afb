"""Row gather from a small table: out[c, r] = table[idx[r], c].

Port of `tpu_raytracer/ops/pallas_gather.py:table_gather`, which takes
the table as [C, T] and returns [C, R] with the ray axis minor. The port
keeps its tables in the builder's [M, C] layout (`scene.tri_table`,
`inst_table`, `mat_table`, `light_table`), so `table_gather(table, idx)`
here is the reference's `table_gather(table.T, idx)`: the same function,
with no second copy of any table. It feeds the shading loop's row
fetches (`ops/hit.py:fetch_cols`), which read each of the C rows of the
result as a contiguous [R] column.

  - CPU tensors: `table_gather_plain`, plain PyTorch indexing;
  - CUDA tensors: kernel K7 (`csrc/gather.cu:tpurt_table_gather`), or the
    call raises.

Indices are clamped to [0, M - 1] (the reference clamps into its
zero-padded width, :86-87); every caller clamps before it calls, so the
clamp only keeps a stray index inside the table. Words are copied as
they are, so a column holding integer bit patterns survives bit for bit.
"""

from __future__ import annotations

import torch

from .trace_api import _check, count_launch, load_kernels


def _check_args(table, idx) -> None:
    if table.dim() != 2 or table.dtype != torch.float32 \
            or table.shape[0] == 0:
        raise ValueError(f"table: want f32 [M, C] with M >= 1, got "
                         f"{table.dtype} {tuple(table.shape)}")
    if idx.dim() != 1 or idx.dtype != torch.int32:
        raise ValueError(f"idx: want int32 [R], got {idx.dtype} "
                         f"{tuple(idx.shape)}")


def table_gather_plain(table, idx):
    """table [M, C] f32, idx [R] int32 -> [C, R] f32 (contiguous),
    out[c, r] = table[clamp(idx[r], 0, M - 1), c]."""
    _check_args(table, idx)
    rows = idx.to(torch.int64).clamp(0, table.shape[0] - 1)
    return table[rows].T.contiguous()


def table_gather_kernel(table, idx):
    """K7 on CUDA tensors: table [M, C] f32 and idx [R] int32, contiguous
    on one CUDA device. Returns [C, R] f32. Raises on anything else."""
    device = table.device
    if device.type != "cuda":
        raise ValueError(f"table_gather_kernel needs CUDA tensors, got "
                         f"{device}")
    _check_args(table, idx)
    m, c = table.shape
    r = idx.shape[0]
    _check(table, "table", (m, c), torch.float32, device)
    _check(idx, "idx", (r,), torch.int32, device)
    if max(m, c, r) >= 2 ** 31:
        raise ValueError(f"table [{m}, {c}] or {r} rows exceed K7's int32 "
                         f"sizes")
    out = torch.empty((c, r), dtype=torch.float32, device=device)
    if r == 0 or c == 0:         # a grid of no blocks is a launch error
        return out
    lib = load_kernels()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.tpurt_table_gather(table.data_ptr(), idx.data_ptr(), m, c,
                                     r, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"table gather kernel launch failed: CUDA error "
                           f"{err}")
    count_launch("table_gather")
    return out


def table_gather(table, idx):
    """[C, R] rows of `table` [M, C] at `idx` [R] int32: the plain
    version for CPU tensors, K7 for CUDA tensors."""
    if table.device.type == "cpu" and idx.device.type == "cpu":
        return table_gather_plain(table, idx)
    return table_gather_kernel(table, idx)
