"""The synthetic token stream: a mixture of Zipfian unigrams and repeated
motifs, counter-based (a batch depends only on seed, rank and step).  A
frozen copy of the port's ``TokenPipeline`` (itself a copy of the JAX
package's, which holds no JAX); its batches are the same bytes."""
from __future__ import annotations

from typing import Dict

import numpy as np


class TokenPipeline:
    def __init__(self, vocab: int, seq_len: int, batch_size: int,
                 seed: int = 0, rank: int = 0, motif_len: int = 16,
                 n_motifs: int = 256):
        self.seq_len, self.batch_size = seq_len, batch_size
        self.seed, self.rank = seed, rank
        self.motif_len, self.n_motifs = motif_len, n_motifs
        self.step = 0
        v = min(vocab, 65536)
        self.motifs = np.random.default_rng(seed).integers(
            0, v, size=(n_motifs, motif_len))
        p = 1.0 / np.arange(1, v + 1, dtype=np.float64)
        self.p = p / p.sum()
        self.v = v

    def next_batch(self) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + self.rank) * 2_000_003 + self.step)
        self.step += 1
        toks = rng.choice(self.v, p=self.p,
                          size=(self.batch_size, self.seq_len))
        spans = max(self.seq_len // (self.motif_len * 4), 1)
        for b in range(self.batch_size):
            for _ in range(spans):
                m = rng.integers(0, self.n_motifs)
                at = rng.integers(0, max(self.seq_len - self.motif_len, 1))
                toks[b, at:at + self.motif_len] = self.motifs[m]
        return {"tokens": toks.astype(np.int32)}
