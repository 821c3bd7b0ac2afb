"""Ray-stream permutations: live-lane compaction and coherence binning
(`tpu_raytracer/ops/compaction.py`).

`scene_trace(..., reorder=)` permutes the ray stream of a sweep route
(K1/K2, K3, K5, K6) before the launch and restores the results after it:

  * "live" packs the live lanes to the front, so that the trailing
    128-ray blocks hold dead lanes only and leave the sweep at once;
  * "bins" also groups the live lanes by direction octant, so that a
    block's lanes share a narrow frustum and the union of the chunks its
    lanes pass (csrc/sweep.cuh's units) stays small.

Both are stable: lanes keep their order within a class. Permutation
contract, as in the reference: `src` and `dest` are int32 [R] and

    permuted = x[src]          (the stream in permuted order)
    restored = y[dest]         (a result back in the caller's order)

Every function here is made of device ops and reads nothing back to the
host, so a frame captured as a CUDA graph may hold it. The reference
computes the permutation with XLA ops, not in a kernel; these are its
PyTorch ops.
"""

from __future__ import annotations

import torch

NUM_BINS = 9      # 8 direction octants and a trailing bin of dead lanes


def _inverse(dest):
    """src with src[dest[i]] = i: the inverse of the permutation dest."""
    r = dest.shape[0]
    lanes = torch.arange(r, dtype=torch.int32, device=dest.device)
    return torch.empty_like(lanes).scatter_(0, dest.long(), lanes)


def partition_live(live):
    """Stable partition of a [R] bool: live lanes first. Returns (src,
    dest, n_live), n_live a 0-dim int32 tensor on live's device."""
    li = live.to(torch.int32)
    pref_live = torch.cumsum(li, 0, dtype=torch.int32)
    n_live = pref_live[-1]
    pref_dead = torch.cumsum(1 - li, 0, dtype=torch.int32)
    dest = torch.where(live, pref_live - 1, n_live + pref_dead - 1)
    return _inverse(dest), dest, n_live


def partition_bins(bin_id, num_bins: int):
    """Stable counting sort of a [R] integer key in [0, num_bins).
    Returns (src, dest): a stable sort's order is the counting sort's,
    whatever num_bins, which the reference's one-hot form needs."""
    src = torch.sort(bin_id.to(torch.int32), stable=True).indices
    src = src.to(torch.int32)
    return src, _inverse(src)


def direction_bins(d, live):
    """Coherence key of rays with direction components d = (dx, dy, dz),
    each [R]: the octant, the sign bits of (dx > 0, dy > 0, dz > 0), and
    the trailing bin 8 for dead lanes. Returns (key [R] int32, 9)."""
    b = ((d[0] > 0).to(torch.int32) + 2 * (d[1] > 0).to(torch.int32)
         + 4 * (d[2] > 0).to(torch.int32))
    return torch.where(live, b, NUM_BINS - 1), NUM_BINS


def permutation(reorder: str, d, t_max):
    """(src, dest) of mode `reorder` ("live" or "bins") for rays with
    direction components d and window ends t_max ([R]; t_max <= 0 marks
    a dead lane), as the reference's trace_brute_pallas takes them."""
    live = t_max > 0.0
    if reorder == "bins":
        return partition_bins(*direction_bins(d, live))
    if reorder == "live":
        return partition_live(live)[:2]
    raise ValueError(f"reorder={reorder!r}: want none, live or bins")
