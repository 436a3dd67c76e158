"""Paged KV-cache store: host<->HBM block residency manager.

The TPU analogue of the paper's UVM page system: the KV cache is divided
into fixed-size *blocks* (the 64 KB basic-block analogue: BLOCK_TOKENS
tokens per request per block).  Decoding attention at position ``pos`` reads
every block of the request's history — blocks resident in HBM are hits;
absent blocks must DMA from host memory (the far-fault analogue).

This layer does residency accounting and transfer scheduling against a
bandwidth model (PCIe-class host link), and exposes the access stream the
learned prefetcher trains on.  It is exercised by ``launch/serve.py`` and
benchmarked in ``benchmarks/offload_bench.py``.

The access stream is also a first-class UVM replay trace source:
``repro_torch.offload.serve_trace`` maps blocks to pages (one block = one page,
per-request 2 MB-aligned regions), DMAs to far-faults, and decode steps to
kernel ids, so serving workloads replay through the backend-pluggable
``repro_torch.uvm.replay_core`` on every registered backend (the ``serve-*``
scenario family in ``repro_torch.uvm.scenarios``).
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, List, Tuple

BLOCK_TOKENS = 64
BLOCK_BYTES = 64 * 1024          # 64 KB blocks, like the UVM basic block
HOST_LINK_GBS = 32.0             # host<->HBM DMA per chip
DMA_LATENCY_US = 5.0


@dataclasses.dataclass
class PagedKVStore:
    n_requests: int
    max_len: int
    hbm_capacity_blocks: int
    # eviction policy:
    #   "lru"  — rotate (degenerates to 0% under cyclic-sweep thrash);
    #   "pin"  — once HBM is full, new blocks are served from host WITHOUT
    #            caching (insertion bypass).  Decode attention sweeps the
    #            whole history every step; for cyclic sweeps a frozen
    #            resident set is Belady-optimal.  This is the serving-side
    #            analogue of the paper's soft-pinning/zero-copy insight
    #            (§2.1): under thrash, pin hot pages and remote-access the
    #            cold ones.
    evict: str = "lru"

    def __post_init__(self) -> None:
        # (request, block) -> arrival time; OrderedDict doubles as LRU
        self.resident: "OrderedDict[Tuple[int,int], float]" = OrderedDict()
        self.clock_us = 0.0
        self.link_free_us = 0.0
        self.hits = 0
        self.misses = 0
        self.prefetched: Dict[Tuple[int, int], bool] = {}
        self.prefetch_used = 0
        self.prefetch_issued = 0
        self.prefetch_bypassed = 0
        self.host_bytes = 0.0
        self.evictions = 0
        self.access_log: List[Tuple[int, int]] = []

    # ------------------------------------------------------------------
    @property
    def blocks_per_seq(self) -> int:
        """Blocks of KV history one request at ``max_len`` spans — the
        capacity-accounting bound every decode position must respect."""
        return (self.max_len - 1) // BLOCK_TOKENS + 1

    def _touch(self, key: Tuple[int, int]) -> None:
        self.resident.move_to_end(key)

    def _insert(self, key: Tuple[int, int], arrival: float) -> bool:
        """Insert a block; returns False when the pin policy's insertion
        bypass rejects it (served from host, never transferred)."""
        if (self.evict == "pin" and key not in self.resident
                and len(self.resident) >= self.hbm_capacity_blocks):
            return False  # insertion bypass: serve from host, don't thrash
        self.resident[key] = arrival
        self.resident.move_to_end(key)
        while len(self.resident) > self.hbm_capacity_blocks:
            victim, _ = self.resident.popitem(last=False)
            self.prefetched.pop(victim, None)
            self.evictions += 1
        return True

    def _dma(self, n_blocks: int) -> float:
        start = max(self.clock_us + DMA_LATENCY_US, self.link_free_us)
        dur = n_blocks * BLOCK_BYTES / (HOST_LINK_GBS * 1e3)  # us
        self.link_free_us = start + dur
        self.host_bytes += n_blocks * BLOCK_BYTES
        return start + dur

    # ------------------------------------------------------------------
    def on_decode_step(self, pos: int, step_us: float = 10.0) -> None:
        """Account one decode step at sequence position ``pos``: every block
        of every request's history is accessed.  ``pos`` is the *cache*
        position (prefix-inflated for VLM archs) — it must stay inside the
        ``max_len`` the store's capacity accounting was sized with."""
        if not 0 <= pos < self.max_len:
            raise ValueError(
                f"decode position {pos} outside max_len={self.max_len}: "
                "the KV-cache index and the store's capacity accounting "
                "disagree (VLM prefix dropped?)")
        self.clock_us += step_us
        n_blocks = pos // BLOCK_TOKENS + 1
        for r in range(self.n_requests):
            for blk in range(n_blocks):
                key = (r, blk)
                self.access_log.append(key)
                arr = self.resident.get(key)
                if arr is not None and arr <= self.clock_us:
                    self.hits += 1
                    if self.prefetched.pop(key, None):
                        self.prefetch_used += 1
                    self._touch(key)
                elif arr is not None:
                    # in flight: stall until arrival, but never re-DMA
                    self.misses += 1
                    self._touch(key)
                else:
                    self.misses += 1
                    arrival = self._dma(1)
                    self._insert(key, arrival)

    def prefetch(self, keys: List[Tuple[int, int]]) -> None:
        """Batch-DMA non-resident blocks ahead of demand.

        Only blocks *actually inserted* are charged to ``host_bytes`` /
        ``prefetch_issued`` and flagged in ``prefetched``: duplicates in
        one request are collapsed (one block, one transfer), and under the
        ``pin`` policy the batch is trimmed to the remaining HBM room
        up front — blocks the insertion bypass would reject are never
        transferred, so they must not inflate interconnect traffic or the
        prefetch-accuracy denominator (they are counted in
        ``prefetch_bypassed`` instead).
        """
        todo: List[Tuple[int, int]] = []
        seen = set()
        for k in keys:
            if k not in self.resident and k not in seen:
                todo.append(k)
                seen.add(k)
        if self.evict == "pin":
            room = max(self.hbm_capacity_blocks - len(self.resident), 0)
            self.prefetch_bypassed += max(len(todo) - room, 0)
            todo = todo[:room]
        if not todo:
            return
        arrival = self._dma(len(todo))
        for k in todo:
            inserted = self._insert(k, arrival)
            assert inserted, "prefetch batch was trimmed to the HBM room"
            self.prefetched[k] = True
        self.prefetch_issued += len(todo)

    # ------------------------------------------------------------------
    def stats(self) -> Dict[str, float]:
        total = self.hits + self.misses
        return {
            "hit_rate": self.hits / max(total, 1),
            "prefetch_accuracy": (self.prefetch_used
                                  / max(self.prefetch_issued, 1)),
            "host_bytes": self.host_bytes,
            "evictions": float(self.evictions),
            "prefetch_bypassed": float(self.prefetch_bypassed),
        }
