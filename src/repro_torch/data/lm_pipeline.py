"""Deterministic, checkpointable synthetic LM token pipeline (a copy of the
reference's ``repro.data.lm_pipeline``, which holds no JAX, so that the
port stands alone; its batches equal the reference's byte for byte).

Generates structured token streams (mixture of Zipfian unigrams and repeated
motifs, so models have something learnable) sharded by data-parallel rank.
The iterator state is a plain dict — saved with the checkpoint, restored
exactly: a preempted job resumes on the batch it would have seen.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass
class TokenPipeline:
    vocab: int
    seq_len: int
    batch_size: int            # per-host batch
    seed: int = 0
    rank: int = 0
    world: int = 1
    motif_len: int = 16
    n_motifs: int = 256

    def __post_init__(self) -> None:
        self._step = 0
        base = np.random.default_rng(self.seed)
        v = min(self.vocab, 65536)
        self._motifs = base.integers(
            0, v, size=(self.n_motifs, self.motif_len))
        # Zipf-ish unigram distribution
        ranks = np.arange(1, v + 1, dtype=np.float64)
        p = 1.0 / ranks
        self._p = p / p.sum()
        self._v = v

    # ------------------------------------------------------------------
    def state(self) -> Dict:
        return {"step": self._step, "seed": self.seed, "rank": self.rank,
                "world": self.world}

    def restore(self, state: Dict) -> None:
        assert state["seed"] == self.seed and state["world"] == self.world, \
            "pipeline config changed across restore"
        self._step = int(state["step"])

    # ------------------------------------------------------------------
    def _rng_for(self, step: int) -> np.random.Generator:
        # counter-based: batch content depends only on (seed, rank, step)
        return np.random.default_rng(
            (self.seed * 1_000_003 + self.rank) * 2_000_003 + step)

    def next_batch(self) -> Dict[str, np.ndarray]:
        rng = self._rng_for(self._step)
        self._step += 1
        toks = rng.choice(self._v, p=self._p,
                          size=(self.batch_size, self.seq_len))
        # overwrite random spans with motifs (learnable repeats)
        n_spans = self.seq_len // (self.motif_len * 4)
        for b in range(self.batch_size):
            for _ in range(max(n_spans, 1)):
                m = rng.integers(0, self.n_motifs)
                at = rng.integers(0, max(self.seq_len - self.motif_len, 1))
                toks[b, at:at + self.motif_len] = self._motifs[m]
        return {"tokens": toks.astype(np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()
