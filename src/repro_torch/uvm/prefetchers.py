"""Prefetching policies for the UVM simulator.

TreePrefetcher implements the CUDA-driver tree-based neighborhood scheme
uncovered by Ganguly et al. (ISCA'19) and used by the UVMSmart runtime — the
paper's baseline.  LearnedPrefetcher implements the paper's solution: on a
far-fault, migrate the 64 KB basic block of the faulting page plus the top-1
page predicted by the deep-learning model.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch import spans
from repro_torch.traces.trace import BASIC_BLOCK_PAGES, ROOT_PAGES


class Prefetcher:
    """Base interface.

    ``on_fault`` returns the pages to migrate *in addition to* the faulting
    page (the simulator always migrates the demand page first on the bus).
    ``extra_latency_cycles`` is added to the prefetched pages' availability
    (e.g. model inference overhead).
    """

    name = "none"
    extra_latency_cycles: float = 0.0

    def reset(self) -> None:  # pragma: no cover - trivial
        pass

    def on_fault(self, index: int, page: int, resident) -> List[int]:
        raise NotImplementedError

    def on_access(self, index: int, page: int, resident,
                  clock: float = 0.0) -> List[int]:
        """Called for *every* GMMU request (hit or fault) — continuous
        prefetching.  Returns additional pages to schedule."""
        return []

    def on_migrate(self, pages: List[int]) -> None:
        """Observe every page that became resident (demand or prefetch)."""

    def on_evict(self, page: int) -> None:
        """Observe evictions (tree node occupancy must shrink)."""


class NoPrefetcher(Prefetcher):
    """Pure on-demand paging (first-touch migration only)."""

    name = "on-demand"

    def on_fault(self, index: int, page: int, resident) -> List[int]:
        return []


def _block_of(page: int) -> int:
    return page // BASIC_BLOCK_PAGES


class BlockPrefetcher(Prefetcher):
    """Migrate the whole 64 KB basic block of the faulting page."""

    name = "block"

    def on_fault(self, index: int, page: int, resident) -> List[int]:
        base = _block_of(page) * BASIC_BLOCK_PAGES
        return [p for p in range(base, base + BASIC_BLOCK_PAGES)
                if p != page and p not in resident]


class TreePrefetcher(Prefetcher):
    """CUDA-driver tree-based neighborhood prefetcher (UVMSmart baseline).

    Each 2 MB chunk of an allocation is a full binary tree over 64 KB basic
    blocks (leaves).  A far-fault migrates its 64 KB block; whenever a
    non-leaf node becomes more than half resident, the *remaining* pages of
    that node are scheduled too — cascading up to the whole 2 MB chunk.
    """

    name = "tree"
    LEVELS = 5  # 64KB -> 128 -> 256 -> 512 -> 1MB -> 2MB (32 leaves)

    def __init__(self) -> None:
        # resident page count per (level, node); node id at level L covers
        # BASIC_BLOCK_PAGES * 2^L pages.
        self.counts: Dict[tuple, int] = {}

    def reset(self) -> None:
        self.counts.clear()

    def _node(self, level: int, page: int) -> tuple:
        span = BASIC_BLOCK_PAGES << level
        return (level, page // span)

    def on_migrate(self, pages: List[int]) -> None:
        for page in pages:
            for lv in range(self.LEVELS + 1):
                key = self._node(lv, page)
                self.counts[key] = self.counts.get(key, 0) + 1

    def on_evict(self, page: int) -> None:
        for lv in range(self.LEVELS + 1):
            key = self._node(lv, page)
            cnt = self.counts.get(key)
            if cnt is not None:
                if cnt <= 1:
                    # pop at zero: on churny oversubscribed runs the dict
                    # otherwise grows monotonically with every node ever
                    # touched (a zero-count node reads the same as a missing
                    # one, so behavior is unchanged)
                    del self.counts[key]
                else:
                    self.counts[key] = cnt - 1

    def on_fault(self, index: int, page: int, resident) -> List[int]:
        # 1) the faulting basic block
        base = _block_of(page) * BASIC_BLOCK_PAGES
        out = [p for p in range(base, base + BASIC_BLOCK_PAGES)
               if p != page and p not in resident]
        # 2) >50% escalation: walk up; count the about-to-arrive pages too.
        pending = set(out) | {page}
        for lv in range(1, self.LEVELS + 1):
            span = BASIC_BLOCK_PAGES << lv
            node_base = (page // span) * span
            key = (lv, page // span)
            cnt = self.counts.get(key, 0) + len(
                [p for p in pending if node_base <= p < node_base + span])
            if cnt * 2 > span:
                extra = [p for p in range(node_base, node_base + span)
                         if p not in resident and p not in pending and p != page]
                out.extend(extra)
                pending.update(extra)
            else:
                break
        return out


class LearnedPrefetcher(Prefetcher):
    """The paper's solution (§4, §7.3): the predictor sits at the UVM backend
    and makes a prediction for *every* GMMU read-request; the top-1 predicted
    page is scheduled for migration if absent.  On a far-fault the faulting
    64 KB basic block is migrated as well (max 15 + 1 = 16 pages per fault).

    Predictions are precomputed per trace index by the predictor service
    (``repro.core.service``): ``predicted_pages[i]`` is the model's top-1
    future page given the access history of this access's cluster up to and
    including index ``i`` (at the configured prediction distance).
    ``extra_latency_cycles`` models inference overhead (Fig 10 sensitivity).
    """

    name = "learned"

    def __init__(self, predicted_pages: np.ndarray,
                 extra_latency_cycles: float = 0.0,
                 prefetch_block: bool = True) -> None:
        self.predicted_pages = predicted_pages
        self.extra_latency_cycles = float(extra_latency_cycles)
        self.prefetch_block = prefetch_block
        self._next_free = 0.0

    def reset(self) -> None:
        self._next_free = 0.0

    def on_fault(self, index: int, page: int, resident) -> List[int]:
        if not self.prefetch_block:
            return []
        base = _block_of(page) * BASIC_BLOCK_PAGES
        return [p for p in range(base, base + BASIC_BLOCK_PAGES)
                if p != page and p not in resident]

    def on_access(self, index: int, page: int, resident,
                  clock: float = 0.0) -> List[int]:
        # The predictor is a serialized inference server: one prediction per
        # ``extra_latency_cycles``.  Requests arriving while it is busy get
        # no prediction — this is exactly why the paper's Fig 10 shows gains
        # vanishing as per-prediction overhead grows: the predictor can no
        # longer keep up with the GMMU request rate.
        if clock < self._next_free:
            return []
        self._next_free = clock + self.extra_latency_cycles
        pred = int(self.predicted_pages[index])
        if pred >= 0 and pred != page and pred not in resident:
            return [pred]
        return []


class OraclePrefetcher(Prefetcher):
    """Ideal-prefetcher upper bound: streams pages in first-touch order a
    fixed distance ahead of the demand frontier (perfect accuracy, perfect
    coverage; hit rate limited only by bus bandwidth)."""

    name = "oracle"

    def __init__(self, future_pages: np.ndarray, lookahead: int = 96) -> None:
        self.lookahead = lookahead
        # first-touch order of pages + the access index of each first touch
        spans.count("sweep.trace_scans")
        pages = np.asarray(future_pages)
        _, first_idx = np.unique(pages, return_index=True)
        order = np.sort(first_idx)
        self.ft_pages = pages[order]
        self.ft_index = order
        self.pos = 0

    def reset(self) -> None:
        self.pos = 0

    def on_fault(self, index: int, page: int, resident) -> List[int]:
        return self.on_access(index, page, resident)

    def on_access(self, index: int, page: int, resident,
                  clock: float = 0.0) -> List[int]:
        while (self.pos < len(self.ft_index)
               and self.ft_index[self.pos] <= index):
            self.pos += 1
        out = []
        for j in range(self.pos, min(self.pos + self.lookahead, len(self.ft_pages))):
            p = int(self.ft_pages[j])
            if p not in resident:
                out.append(p)
            if len(out) >= 16:
                break
        return out
