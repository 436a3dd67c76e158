"""Serving SLO percentiles -- the port's copy of the percentile helpers of
the reference ``repro.uvm.metrics`` (the serve rows' latency columns)."""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np


def sorted_percentiles(sorted_samples: np.ndarray,
                       qs: Sequence[float]) -> np.ndarray:
    """Percentiles of an *already sorted* 1-D float64 array.

    Bit-identical to ``np.percentile(a, q)`` (the default ``linear``
    method, including its symmetric lerp: ``a + (b-a)*t`` below the
    midpoint, ``b - (b-a)*(1-t)`` at or above it) but shares one sort
    across every requested percentile instead of re-partitioning the
    samples per call — the serve lanes ask for six percentiles over the
    same clock deltas on every row."""
    a = np.asarray(sorted_samples, dtype=np.float64)
    if a.ndim != 1:
        raise ValueError(f"expected a 1-D sample vector, got shape {a.shape}")
    if a.size == 0:
        raise ValueError("cannot take percentiles of an empty sample set")
    if not np.isfinite(a).all():
        # np.sort parks NaN at the tail, so a NaN-poisoned clock stream
        # would flow straight into the high percentiles (and p99 ordering
        # checks pass vacuously: NaN comparisons are all False) — reject
        # loudly instead of laundering a broken replay into SLO columns
        raise ValueError(
            f"non-finite latency samples "
            f"({int((~np.isfinite(a)).sum())} of {a.size}): percentiles "
            "over NaN/inf would silently corrupt the SLO columns")
    q = np.asarray(qs, dtype=np.float64)
    if q.size and (q.min() < 0.0 or q.max() > 100.0):
        raise ValueError("percentiles must lie in [0, 100]")
    virt = q / 100.0 * (a.size - 1)
    lo = np.floor(virt).astype(np.int64)
    hi = np.minimum(lo + 1, a.size - 1)
    t = virt - lo
    x, y = a[lo], a[hi]
    diff = y - x
    return np.where(t < 0.5, x + diff * t, y - diff * (1.0 - t))


def slo_percentiles(samples: Sequence[float], prefix: str,
                    qs: Tuple[int, ...] = (50, 95, 99)
                    ) -> Dict[str, Optional[float]]:
    """Latency samples -> SLO percentile columns
    (``{"<prefix>_p50_us": ..., "<prefix>_p95_us": ..., ...}``); an empty
    sample set yields None values so result rows stay schema-stable.
    One shared sort feeds every percentile (:func:`sorted_percentiles`)."""
    arr = np.asarray(samples, dtype=np.float64)
    if not arr.size:
        return {f"{prefix}_p{q}_us": None for q in qs}
    vals = sorted_percentiles(np.sort(arr), qs)
    return {f"{prefix}_p{q}_us": float(v) for q, v in zip(qs, vals)}
