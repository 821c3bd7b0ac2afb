"""Published peaks of the cards the benchmark runs on (NVIDIA's data
sheet of the H100 SXM, dense, at the full 700 W power limit; a card set
below it runs slower, so every roofline share is printed beside the
card's power limit)."""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                              "fp32_flop_per_s": 67e12},
}


def hbm_bytes_per_s(kind: str):
    """The card's memory bandwidth in bytes/s, or None for a card not in
    the table (its rooflines are then not read)."""
    entry = PEAKS.get(kind)
    return None if entry is None else entry["hbm_bytes_per_s"]
