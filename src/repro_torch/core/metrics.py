"""Classification metrics: top-k accuracy and weighted F1 (paper Tables 1-8)."""
from __future__ import annotations

import numpy as np


def topk_accuracy(logits: np.ndarray, y: np.ndarray, k: int = 1) -> float:
    if k == 1:
        return float((logits.argmax(-1) == y).mean())
    topk = np.argpartition(-logits, kth=min(k, logits.shape[-1] - 1), axis=-1)[:, :k]
    return float((topk == y[:, None]).any(axis=1).mean())


def weighted_f1(logits: np.ndarray, y: np.ndarray) -> float:
    """Support-weighted mean of per-class F1 (sklearn 'weighted' semantics)."""
    pred = logits.argmax(-1)
    classes, support = np.unique(y, return_counts=True)
    f1s = np.zeros(len(classes))
    for i, c in enumerate(classes):
        tp = np.sum((pred == c) & (y == c))
        fp = np.sum((pred == c) & (y != c))
        fn = np.sum((pred != c) & (y == c))
        prec = tp / (tp + fp) if tp + fp else 0.0
        rec = tp / (tp + fn) if tp + fn else 0.0
        f1s[i] = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
    return float(np.average(f1s, weights=support))
