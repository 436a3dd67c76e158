"""Learned prefetcher for the paged KV store.

The decode access pattern over KV blocks is the serving-side analogue of the
paper's GMMU stream: per request, blocks 0..pos/B are swept every step, and
the working set grows by one block every BLOCK_TOKENS steps.  The predictor
here is the paper's *bypass* case in miniature — the block-delta stream has
extreme convergence (+1 sweeps), so per §6 the attention model is bypassed
and a delta-table predictor (the FC-equivalent) drives prefetch; the full
HLSH predictor (repro_torch.core) plugs in through the same interface for
workloads with irregular reuse (benchmarks/offload_bench.py exercises both).
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Tuple

from repro_torch.offload.paged_store import BLOCK_TOKENS, PagedKVStore


@dataclasses.dataclass
class OffloadPrefetcher:
    store: PagedKVStore
    lookahead_blocks: int = 2

    def __post_init__(self) -> None:
        # per-request delta histogram over observed block transitions
        self._deltas: Dict[int, Dict[int, int]] = defaultdict(
            lambda: defaultdict(int))
        self._last: Dict[int, int] = {}

    def observe(self) -> None:
        for r, blk in self.store.access_log[-256:]:
            prev = self._last.get(r)
            if prev is not None:
                self._deltas[r][blk - prev] += 1
            self._last[r] = blk

    def step(self, pos: int) -> None:
        """Called before each decode step: prefetch the blocks each request
        will need next (the about-to-be-written frontier block plus the
        top-delta continuation)."""
        self.observe()
        frontier = pos // BLOCK_TOKENS
        keys: List[Tuple[int, int]] = []
        for r in range(self.store.n_requests):
            for ahead in range(1, self.lookahead_blocks + 1):
                keys.append((r, frontier + ahead))
            hist = self._deltas.get(r)
            if hist:
                best = max(hist, key=hist.get)
                last = self._last.get(r, frontier)
                cand = last + best
                if 0 <= cand <= frontier + self.lookahead_blocks:
                    keys.append((r, cand))
        self.store.prefetch(keys)
