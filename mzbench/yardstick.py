"""The benchmark's fixed arithmetic: the card's peaks, rates, roofline
shares and order statistics.  Per-layer metric readers and the loops take
their numbers from here, so that every cell counts alike."""

from __future__ import annotations

import math

# NVIDIA H100 SXM5 80GB data sheet: HBM3 bandwidth and L2 size.
HBM_BYTES_PER_S = 3.35e12
L2_BYTES = 50 * 10 ** 6


def gbps(n_bytes: float, seconds: float) -> float:
    """Decimal GB a second."""
    return n_bytes / seconds / 1e9


def roofline_pct(n_bytes: float, seconds: float) -> float | None:
    """The share, in %, of ``seconds`` that moving ``n_bytes`` once at the
    card's HBM bandwidth would take; None without a time to divide by."""
    if not seconds or seconds <= 0:
        return None
    return 100.0 * n_bytes / HBM_BYTES_PER_S / seconds


def nearest_rank(values, q: float) -> float:
    """The ``q`` quantile (0 < q <= 1) by nearest rank: the smallest value
    with at least ``q`` of all values at or below it."""
    vals = sorted(values)
    if not vals:
        raise ValueError("no values")
    return vals[max(0, math.ceil(q * len(vals)) - 1)]


def median(values) -> float:
    vals = sorted(values)
    if not vals:
        raise ValueError("no values")
    mid = len(vals) // 2
    return vals[mid] if len(vals) % 2 else (vals[mid - 1] + vals[mid]) / 2

