"""The benchmark's arithmetic: tails, device busy time, the CCL's byte bound.

Pure functions of the records a run keeps, so that the tests can hold them
to hand-worked cases.
"""

from __future__ import annotations

import math

# One H100 SXM's HBM3 bandwidth (NVIDIA's data sheet), at its 700 W limit.
HBM_BYTES_PER_S = 3.35e12


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile (0 < q <= 100) over every value."""
    if not values:
        raise ValueError("no values")
    s = sorted(values)
    k = max(1, math.ceil(q / 100.0 * len(s)))
    return float(s[k - 1])


def union_seconds(intervals, lo: float, hi: float) -> float:
    """Length of the union of (start, end) intervals, clipped to [lo, hi]."""
    total = 0.0
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    out = []
    t = lo
    for s, e in sorted(intervals):
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(a, b) for a, b in out if b > a]


def idle_pct(busy_s: float, window_s: float) -> float:
    return 100.0 * (1.0 - busy_s / window_s)


def ccl_bytes(frames: int, height: int, width: int, decimate: int) -> int:
    """The least traffic of labelling a batch: one int8 read and one int32
    write per pixel of the decimated trinary map."""
    return frames * (height // decimate) * (width // decimate) * (1 + 4)


def roofline_pct(bytes_moved: int, device_s: float) -> float:
    """The share of the HBM roofline a kernel time reaches on ``bytes_moved``."""
    return 100.0 * (bytes_moved / HBM_BYTES_PER_S) / device_s
