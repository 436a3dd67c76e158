"""Sequence dataset: sliding windows of 30 feature tokens -> delta class.

Labels: for prediction distance d, the label of a window ending at position i
is the class of ``page[i+d] - page[i]`` — the page the GPU will touch d
requests later, relative to now (d=1 reduces to the next-access delta, the
setup of paper Tables 1-8; the deployed service uses d=30 for timeliness,
paper §5.2).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Tuple

import numpy as np

from repro_torch.core.features import ClusteredTrace
from repro_torch.core.vocab import DeltaVocab, encode_features

SEQ_LEN = 30


@dataclasses.dataclass
class SequenceDataset:
    x_train: np.ndarray     # (N, seq, F) int32
    y_train: np.ndarray     # (N,) int32 class ids
    x_valid: np.ndarray
    y_valid: np.ndarray
    x_test: np.ndarray      # 100% of the trace (paper §4)
    y_test: np.ndarray
    n_classes: int
    vocab: DeltaVocab
    features: List[str]

    @property
    def class_counts(self) -> np.ndarray:
        counts = np.bincount(self.y_train, minlength=self.n_classes)
        return counts


def build_dataset(ct: ClusteredTrace, vocab: DeltaVocab,
                  features: List[str] | None = None,
                  seq_len: int = SEQ_LEN, distance: int = 1,
                  train_frac: float = 0.8, stride: int = 1,
                  max_train: int = 24000, max_eval: int = 8000,
                  shuffle_tokens: bool = False,
                  seed: int = 0) -> SequenceDataset:
    """Window each cluster independently; chronological 80/20 split within
    clusters; test set spans 100%.  ``shuffle_tokens`` randomly permutes the
    tokens *within* each window (paper Fig 6's order-sensitivity probe)."""
    rng = np.random.default_rng(seed)
    xs, ys, split_pos = [], [], []
    for c, pages in zip(ct.clusters, ct.pages):
        n = len(pages)
        if n < seq_len + distance + 1:
            continue
        enc = encode_features(c, features)
        n_win = n - seq_len - distance + 1
        starts = np.arange(0, n_win, stride)
        # gather windows: (n_win, seq, F)
        idx = starts[:, None] + np.arange(seq_len)[None, :]
        x = enc[idx]
        ends = starts + seq_len - 1
        deltas = pages[ends + distance] - pages[ends]
        y = vocab.encode_fast(deltas)
        xs.append(x)
        ys.append(y)
        split_pos.append(int(len(starts) * train_frac))

    if not xs:
        raise ValueError(f"trace {ct.name} too short for seq_len={seq_len}")

    xtr = np.concatenate([x[:s] for x, s in zip(xs, split_pos)])
    ytr = np.concatenate([y[:s] for y, s in zip(ys, split_pos)])
    xva = np.concatenate([x[s:] for x, s in zip(xs, split_pos)])
    yva = np.concatenate([y[s:] for y, s in zip(ys, split_pos)])
    xte = np.concatenate(xs)
    yte = np.concatenate(ys)

    def sub(x, y, cap):
        if len(x) > cap:
            sel = rng.choice(len(x), cap, replace=False)
            return x[sel], y[sel]
        return x, y

    xtr, ytr = sub(xtr, ytr, max_train)
    xva, yva = sub(xva, yva, max_eval)
    xte, yte = sub(xte, yte, max_eval)

    if shuffle_tokens:
        def shuf(x):
            perm = rng.permuted(
                np.broadcast_to(np.arange(x.shape[1]), x.shape[:2]), axis=1)
            return np.take_along_axis(x, perm[:, :, None], axis=1)
        xtr, xva, xte = shuf(xtr), shuf(xva), shuf(xte)

    from repro_torch.core.features import FEATURE_NAMES
    return SequenceDataset(
        x_train=xtr, y_train=ytr.astype(np.int32),
        x_valid=xva, y_valid=yva.astype(np.int32),
        x_test=xte, y_test=yte.astype(np.int32),
        n_classes=vocab.n_classes, vocab=vocab,
        features=list(features or FEATURE_NAMES),
    )


def batches(x: np.ndarray, y: np.ndarray, batch_size: int,
            seed: int = 0, epochs: int = 1) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    rng = np.random.default_rng(seed)
    n = len(x)
    for _ in range(epochs):
        perm = rng.permutation(n)
        for i in range(0, n - batch_size + 1, batch_size):
            sel = perm[i:i + batch_size]
            yield x[sel], y[sel]
