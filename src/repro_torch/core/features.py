"""Feature extraction and trace clustering (paper Fig 3, §5.1).

A feature token has 13 fields: PC, Hit/Miss, warp, SM, TPC, CTA ids, the
page / basic-block / 2MB-root addresses, the input-array base ('In'), and the
three address deltas.  Traces are clustered before windowing; the paper shows
SM-id clustering wins (Table 2) and the revised predictor uses SM+warp.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from repro_torch.traces.trace import BASIC_BLOCK_PAGES, ROOT_PAGES, Trace

FEATURE_NAMES = [
    "pc", "hit", "warp", "sm", "tpc", "cta", "kernel",
    "paddr", "bbaddr", "raddr", "inarr", "dp", "dbb", "dr",
]
# 13 trace features of Fig 3 (+ kernel id, which GPGPU-Sim exposes too).
N_FEATURES = len(FEATURE_NAMES)

CLUSTER_KEYS = ("sm", "pc", "cta", "warp", "kernel", "sm_warp", "none")


@dataclasses.dataclass
class ClusteredTrace:
    """Per-cluster raw feature columns, plus the global index of each access
    so per-access predictions can be scattered back into trace order."""

    name: str
    cluster_key: str
    clusters: List[Dict[str, np.ndarray]]   # feature name -> int64 column
    global_index: List[np.ndarray]          # trace positions per cluster
    pages: List[np.ndarray]                 # raw page numbers per cluster


def _columns(trace: Trace, resident_miss: np.ndarray | None) -> Dict[str, np.ndarray]:
    a = trace.accesses
    pages = a["page"].astype(np.int64)
    bb = pages // BASIC_BLOCK_PAGES
    rt = pages // ROOT_PAGES
    if resident_miss is None:
        # first touch of a page == far-fault under on-demand paging
        _, first = np.unique(pages, return_index=True)
        miss = np.zeros(len(pages), np.int64)
        miss[first] = 1
    else:
        miss = resident_miss.astype(np.int64)
    return {
        "pc": a["pc"].astype(np.int64),
        "hit": miss,
        "warp": a["warp"].astype(np.int64),
        "sm": a["sm"].astype(np.int64),
        "tpc": a["tpc"].astype(np.int64),
        "cta": a["cta"].astype(np.int64),
        "kernel": a["kernel"].astype(np.int64),
        "paddr": pages,
        "bbaddr": bb,
        "raddr": rt,
        "inarr": a["array"].astype(np.int64),
    }


def cluster_trace(trace: Trace, key: str = "sm",
                  resident_miss: np.ndarray | None = None) -> ClusteredTrace:
    """Split the GMMU trace into per-cluster streams and compute the delta
    features *within* each cluster (deltas across cluster boundaries are
    meaningless — that is the whole point of clustering)."""
    if key not in CLUSTER_KEYS:
        raise ValueError(f"cluster key {key!r} not in {CLUSTER_KEYS}")
    cols = _columns(trace, resident_miss)
    n = len(trace)
    if key == "none":
        group_ids = np.zeros(n, np.int64)
    elif key == "sm_warp":
        group_ids = cols["sm"] * (1 << 32) + cols["warp"]
    else:
        group_ids = cols[key]

    order = np.argsort(group_ids, kind="stable")
    sorted_ids = group_ids[order]
    boundaries = np.flatnonzero(np.diff(sorted_ids)) + 1
    splits = np.split(order, boundaries)

    clusters, gidx, pages = [], [], []
    for idx in splits:
        if len(idx) < 2:
            continue
        c = {k: v[idx] for k, v in cols.items()}
        p = c["paddr"]
        c["dp"] = np.diff(p, prepend=p[0])
        c["dbb"] = np.diff(c["bbaddr"], prepend=c["bbaddr"][0])
        c["dr"] = np.diff(c["raddr"], prepend=c["raddr"][0])
        clusters.append(c)
        gidx.append(idx)
        pages.append(p)
    return ClusteredTrace(trace.name, key, clusters, gidx, pages)


def delta_convergence(ct: ClusteredTrace) -> float:
    """Ratio of the most frequent page delta to all deltas (paper §5.4) —
    the attention-bypass indicator of the revised predictor."""
    all_d = np.concatenate([c["dp"][1:] for c in ct.clusters if len(c["dp"]) > 1])
    if all_d.size == 0:
        return 1.0
    _, counts = np.unique(all_d, return_counts=True)
    return float(counts.max() / counts.sum())
