"""The benchmark's arithmetic: percentiles, rates and the SSD search's
roofline (a frozen copy of ``odometry_torch/tools/roofline.py``'s
``search_pairs``, ``search_work``, ``bound`` and peaks).

Peaks: one NVIDIA H100 SXM at 700 W, NVIDIA's data sheet: 67 TFLOP/s float32
outside the tensor cores, 3.35 TB/s HBM3.
"""

from __future__ import annotations

import math

import numpy as np

PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# One (x, xr) pair's SSD over the 8-point pattern: 8 subtractions, 1
# multiply and 7 fused multiply-adds counted as two operations each.
FLOPS_PER_PAIR = 24


def percentile(values, p: float) -> float:
    """The nearest-rank p-th percentile: the smallest value with at least p%
    of the values at or below it."""
    v = sorted(values)
    if not v:
        raise ValueError("percentile of no values")
    return v[max(0, math.ceil(p / 100.0 * len(v)) - 1)]


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of `flops` over the
    float32 peak and `nbytes` over the memory rate (seconds)."""
    return max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S)


def search_pairs(H, W, boundary, min_d, max_d) -> int:
    """(x, xr) pairs of one winner-map search: boundary <= xr, min_d <= x - xr
    <= max_d (None = the full search), for every row."""
    x = np.arange(W)
    lo = np.maximum(boundary, x - (W if max_d is None else max_d))
    hi = x - max(1, min_d or 1)
    return H * int(np.maximum(hi - lo + 1, 0).sum())


def search_work(H, W, boundary, min_d, max_d, lr) -> tuple[int, int]:
    """(operations, bytes) of one image's SSD search: FLOPS_PER_PAIR per
    (x, xr) pair scored once; two float32 images read once, each output map
    written once (best, match and, with `lr`, rmatch; 4 bytes each)."""
    flops = FLOPS_PER_PAIR * search_pairs(H, W, boundary, min_d, max_d)
    return flops, 4 * H * W * (2 + 2 + int(lr))
