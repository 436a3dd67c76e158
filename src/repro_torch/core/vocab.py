"""Vocabularies: delta classification categories + feature-id encoding.

The classifier's output classes are the unique page deltas of the training
split (Hashemi et al.'s insight: unique deltas are orders of magnitude fewer
than unique addresses).  Input features are encoded into bounded integer id
spaces so embedding tables stay small: id-like features are used modulo their
table size; address-like features are bucketed by hashing.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from repro_torch.core.features import ClusteredTrace, FEATURE_NAMES

UNK = 0  # class / id 0 is reserved for "unseen"

# embedding-table sizes per feature (input id space)
FEATURE_BUCKETS: Dict[str, int] = {
    "pc": 512, "hit": 2, "warp": 256, "sm": 32, "tpc": 16, "cta": 1024,
    "kernel": 64, "paddr": 4096, "bbaddr": 2048, "raddr": 512, "inarr": 16,
    "dp": 2048, "dbb": 1024, "dr": 256,
}

_HASH_MULT = np.uint64(0x9E3779B97F4A7C15)


def _hash_bucket(x: np.ndarray, buckets: int) -> np.ndarray:
    with np.errstate(over="ignore"):
        h = x.astype(np.int64).view(np.uint64) * _HASH_MULT
        h = h ^ (h >> np.uint64(29))
    return (1 + (h % np.uint64(buckets - 1))).astype(np.int64)  # 0 = UNK


@dataclasses.dataclass
class DeltaVocab:
    """Maps page deltas <-> class ids; built on the training split."""

    deltas: np.ndarray           # class id -> delta value (class 0 = UNK)
    index: Dict[int, int]

    @classmethod
    def build(cls, ct: ClusteredTrace, train_frac: float = 0.8,
              max_classes: int = 20000, distance: int = 1) -> "DeltaVocab":
        """Classes are the unique *distance-d* page deltas of the training
        split: label(i) = page[i+d] - page[i] within a cluster (d=1 is the
        next-access delta of paper Tables 1-8; the deployed prefetcher uses
        d=30 per §5.2)."""
        ds: List[np.ndarray] = []
        for c in ct.clusters:
            p = c["paddr"]
            if len(p) <= distance:
                continue
            dd = p[distance:] - p[:-distance]
            k = max(int(len(dd) * train_frac), 1)
            ds.append(dd[:k])
        all_d = np.concatenate(ds) if ds else np.zeros(0, np.int64)
        vals, counts = np.unique(all_d, return_counts=True)
        if vals.size > max_classes - 1:
            keep = np.argsort(-counts)[: max_classes - 1]
            vals = vals[np.sort(keep)]
        deltas = np.concatenate([[np.iinfo(np.int64).min], vals])
        index = {int(d): i + 1 for i, d in enumerate(vals)}
        return cls(deltas=deltas, index=index)

    @property
    def n_classes(self) -> int:
        return int(len(self.deltas))

    def encode(self, dp: np.ndarray) -> np.ndarray:
        out = np.zeros(len(dp), np.int64)
        for i, d in enumerate(dp):
            out[i] = self.index.get(int(d), UNK)
        return out

    def encode_fast(self, dp: np.ndarray) -> np.ndarray:
        """Vectorized encode via searchsorted over the sorted delta list."""
        vals = self.deltas[1:]
        pos = np.searchsorted(vals, dp)
        pos = np.clip(pos, 0, len(vals) - 1)
        ok = vals[pos] == dp
        return np.where(ok, pos + 1, UNK).astype(np.int64)

    def decode(self, cls_ids: np.ndarray) -> np.ndarray:
        return self.deltas[cls_ids]

    @property
    def convergence(self) -> float:  # set externally when known
        return getattr(self, "_convergence", 0.0)


def encode_features(cluster: Dict[str, np.ndarray],
                    features: List[str] | None = None) -> np.ndarray:
    """Encode a cluster's raw feature columns into bounded int ids.
    Returns (n, len(features)) int32."""
    feats = features or FEATURE_NAMES
    n = len(cluster["paddr"])
    out = np.zeros((n, len(feats)), np.int32)
    for j, f in enumerate(feats):
        col = cluster[f]
        b = FEATURE_BUCKETS[f]
        if f in ("paddr", "bbaddr", "raddr", "dp", "dbb", "dr", "pc", "inarr"):
            out[:, j] = _hash_bucket(col, b)
        else:
            out[:, j] = 1 + (col % (b - 1))
    return out
