"""Trace container shared by the generators, the UVM simulator and the core
predictor pipeline.

Addresses are kept at 4 KB *page* granularity (the GMMU in the paper's
simulator coalesces warp accesses; far-faults are page-level events).  The
64 KB basic block and 2 MB root chunk of the tree prefetcher are expressed in
pages.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from repro_torch import spans

PAGE_SIZE = 4096                 # bytes per page (paper Table 9)
BASIC_BLOCK_PAGES = 16           # 64 KB prefetch unit
ROOT_PAGES = 512                 # 2 MB tree root

# Structured record for one coalesced GMMU access.
ACCESS_DTYPE = np.dtype([
    ("pc", np.uint32),       # instruction address
    ("sm", np.uint16),       # streaming multiprocessor id
    ("tpc", np.uint16),      # texture processing cluster id (= sm // 2)
    ("cta", np.uint32),      # cooperative thread array id
    ("warp", np.uint32),     # warp id (global)
    ("kernel", np.uint16),   # kernel launch index
    ("array", np.uint16),    # which input array ('In' feature)
    ("page", np.int64),      # 4KB virtual page index
])


@dataclasses.dataclass
class Trace:
    """A GMMU-order memory access trace for one benchmark run."""

    name: str
    accesses: np.ndarray                  # ACCESS_DTYPE records, GMMU order
    array_bases: Dict[str, int]           # array name -> base page
    array_pages: Dict[str, int]           # array name -> size in pages
    n_instructions: int                   # modeled instruction count
    meta: Dict[str, float] = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        if self.accesses.dtype != ACCESS_DTYPE:
            raise TypeError(f"bad access dtype {self.accesses.dtype}")

    def __len__(self) -> int:
        return int(self.accesses.shape[0])

    @property
    def pages(self) -> np.ndarray:
        return self.accesses["page"]

    @property
    def working_set_pages(self) -> int:
        spans.count("sweep.trace_scans")
        return int(np.unique(self.accesses["page"]).size)

    def split(self, frac: float) -> "tuple[Trace, Trace]":
        """Chronological split (train/validation)."""
        k = int(len(self) * frac)
        a = dataclasses.replace(self, accesses=self.accesses[:k])
        b = dataclasses.replace(self, accesses=self.accesses[k:])
        return a, b


def concat_streams(streams: List[np.ndarray]) -> np.ndarray:
    if not streams:
        return np.empty(0, dtype=ACCESS_DTYPE)
    return np.concatenate(streams)


def make_records(n: int) -> np.ndarray:
    return np.zeros(n, dtype=ACCESS_DTYPE)
