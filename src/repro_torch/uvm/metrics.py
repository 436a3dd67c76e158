"""Evaluation metrics (paper §7.6) and serving SLO percentiles -- the port's
copy of the reference ``repro.uvm.metrics``: Unity, the geometric mean of
the paper's summaries, the PCIe GB/s timeline of Fig 11, and the serve
rows' latency percentiles."""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np


def unity(accuracy: float, coverage: float, hit_rate: float) -> float:
    """Unity := cbrt(Accuracy * Coverage * Page_hit_rate); 1.0 is perfect."""
    return float(np.cbrt(accuracy * coverage * hit_rate))


def geomean(xs: Iterable[float]) -> float:
    xs = np.asarray(list(xs), dtype=np.float64)
    return float(np.exp(np.mean(np.log(np.maximum(xs, 1e-12)))))


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


def pcie_gbs_timeline(timeline: np.ndarray, core_mhz: float,
                      window_cycles: float = 10_000.0) -> np.ndarray:
    """(cycle, bytes) transfer events -> (window_center_cycle, GB/s) rows.

    Events may arrive in any order (binning is order-independent), but
    every cycle stamp must be finite and non-negative: a negative stamp
    floor-divides to a negative window index, which ``np.add.at`` wraps
    to the *tail* window — the bandwidth spike lands on the wrong end of
    the plot with no error.  Reject instead of mis-binning."""
    if timeline is None or len(timeline) == 0:
        return np.zeros((0, 2))
    if window_cycles <= 0:
        raise ValueError(f"window_cycles must be positive: {window_cycles}")
    t = timeline[:, 0]
    b = timeline[:, 1]
    if not np.isfinite(t).all() or (t < 0).any():
        bad = int(((~np.isfinite(t)) | (t < 0)).sum())
        raise ValueError(
            f"invalid PCIe timeline: {bad} of {t.size} cycle stamps are "
            "negative or non-finite (negative stamps would wrap into the "
            "tail window)")
    n_win = int(t.max() // window_cycles) + 1
    idx = (t // window_cycles).astype(np.int64)
    acc = np.zeros(n_win)
    np.add.at(acc, idx, b)
    secs = window_cycles / (core_mhz * 1e6)
    centers = (np.arange(n_win) + 0.5) * window_cycles
    return np.stack([centers, acc / secs / 1e9], axis=1)
