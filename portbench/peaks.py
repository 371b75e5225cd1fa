"""The yardstick of the banded-DP kernel: the H100's published peaks and
the operations and bytes a DP call needs (copies of chip_smoke.py's
ops_per_cell and dp_bound, counted from sums over the launches of a
sample)."""

from __future__ import annotations

import math

# NVIDIA H100 SXM data sheet: float32 outside the tensor cores, HBM3
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12


def ops_per_cell(n_stats: int, local: bool, qual_pen: bool,
                 band: int = 16) -> int:
    """Float32 / integer arithmetic, compares and selects per DP cell
    (one band offset of one query row), tallied from the recurrence in
    midas_tpu_torch/csrc/banded_sw.cu; band shifts (shuffles) and their
    edge fills are data movement and not counted."""
    S = n_stats
    NP = S + 1 if S == 6 else S
    full = S == 6
    sub = 7 + (3 if qual_pen else 0)                 # match test, penalty
    diag = S + 2 + (3 if full else 0)                # start stats, T1
    ins = S + 2 + 3 + 2 + S + (3 if full else 0)     # open, gap costs, I
    pre = 2 + S + (S + 4 if local else 1)            # H_noD, clamp, scan key
    steps = int(math.log2(band))
    dele = steps * (NP + 2) + 2 + (3 if full else 0)  # Kogge-Stone, D value
    fin = 2 * (S + 2) + (S + 2 if local else 0)      # priority, clamp
    best = 9                                          # row max, first, improve
    return sub + diag + ins + pre + dele + fin + best


def dp_least_seconds(rows: int, pairs: int, n_stats: int, local: bool,
                     qual_pen: bool, band: int = 16) -> float:
    """The least time the card needs for DP calls over `pairs` pairs
    whose query rows sum to `rows` (each pair stops at its read length):
    the larger of the operations over the float32 peak and the bytes over
    the HBM rate. Each pair reads its query (and penalty) rows once, its
    reference window up to its last row plus the band, its length, and
    writes its outputs."""
    ops = rows * band * ops_per_cell(n_stats, local, qual_pen, band)
    n_out = 9 if n_stats == 6 else 4
    nbytes = (rows * (2 if qual_pen else 1) + rows + pairs * (band - 1)
              + 4 * pairs + 4 * pairs * n_out)
    return max(ops / PEAK_F32_OPS, nbytes / PEAK_BYTES)
