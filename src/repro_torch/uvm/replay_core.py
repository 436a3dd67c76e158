"""The replay backend interface, copied from the reference
``repro.uvm.replay_core``: the request type, the backend contract and
registry, and the shared helpers every backend derives its constants from.

The reference's NumPy chunked engine, its fallback chain and ``dispatch``
are not part of the port yet.  The port's registry has no fallback: a
backend that declines a request raises (see ``uvm.backends.cuda_backend``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.traces.trace import ROOT_PAGES, Trace
from repro_torch.uvm.config import UVMConfig
from repro_torch.uvm.prefetchers import LearnedPrefetcher, Prefetcher
from repro_torch.uvm.simulator import UVMStats, _tenant_accesses

__all__ = ["MAX_SPAN_PAGES", "ReplayRequest", "ReplayBackend",
           "register_backend", "get_backend",
           "cycles_per_access", "prefetcher_page_range", "dense_bounds",
           "UVMStats", "_tenant_accesses"]

#: beyond this many pages of span the dense state arrays stop paying for
#: themselves
MAX_SPAN_PAGES = 1 << 24


@dataclasses.dataclass
class ReplayRequest:
    """One (trace × prefetcher × config) replay cell, backend-agnostic.

    The prefetcher object is *consumed* by the replay (its ``reset()`` is
    called and its state mutated); build a fresh one per request.
    """

    trace: Trace
    prefetcher: Prefetcher
    config: UVMConfig
    record_timeline: bool = False
    max_span_pages: int = MAX_SPAN_PAGES
    #: optional non-decreasing exclusive end indices into the access stream
    #: (per-window clocks); no backend of the port records them yet
    step_bounds: Optional[np.ndarray] = None


class ReplayBackend:
    """Narrow contract every replay backend implements.

    * ``name`` -- recorded in :attr:`UVMStats.backend` of every stats object
      the backend produces, and surfaced in sweep result rows.
    * ``can_replay(request)`` -- purely structural test (prefetcher type,
      page span, feature flags); must not mutate the request.
    * ``replay(requests)`` -- replay every request, order-preserving, one
      ``UVMStats`` per request, equivalent to the legacy engine (integer
      counters exact, cycles/pcie_bytes to 1e-6 relative).
    """

    name: str = "abstract"

    def __init__(self, device: str = "cuda") -> None:
        self.device = device

    def can_replay(self, request: ReplayRequest) -> bool:
        raise NotImplementedError

    def replay(self, requests: Sequence[ReplayRequest]) -> List[UVMStats]:
        raise NotImplementedError


_REGISTRY: Dict[str, type] = {}


def register_backend(cls: type) -> type:
    _REGISTRY[cls.name] = cls
    return cls


def _ensure_registry() -> None:
    if not _REGISTRY:
        import repro_torch.uvm.backends  # noqa: F401  (registers on import)


def get_backend(name: str, device: str = "cuda") -> ReplayBackend:
    """A backend instance that replays on ``device``."""
    _ensure_registry()
    try:
        return _REGISTRY[name](device=device)
    except KeyError:
        raise ValueError(f"unknown replay backend {name!r}; "
                         f"available: {sorted(_REGISTRY)}") from None


# ---------------------------------------------------------------------------
# shared pure helpers (every backend derives its scalar constants through
# these, so the float values agree bit for bit with the legacy loop)
# ---------------------------------------------------------------------------

def cycles_per_access(trace: Trace, config: UVMConfig) -> float:
    """Per-access cost in GPU cycles -- the exact legacy-loop expression."""
    n = len(trace.pages)
    return (config.page_table_walk_cycles + config.dram_cycles
            + config.access_overhead_cycles
            + (trace.n_instructions / max(n, 1)) / config.issue_ipc)


def prefetcher_page_range(pf: Prefetcher) -> Optional[Tuple[int, int]]:
    """Extra page range a prefetcher can touch beyond the accessed span."""
    if type(pf) is LearnedPrefetcher:
        preds = np.asarray(pf.predicted_pages, dtype=np.int64)
        valid = preds[preds >= 0]
        if valid.size:
            return int(valid.min()), int(valid.max())
    return None


def dense_bounds(trace: Trace, prefetcher: Prefetcher) -> Tuple[int, int]:
    """2 MB-aligned ``[lo, hi)`` page bounds of the dense state arrays
    (aligned so block extras always fall inside the span)."""
    pages = trace.pages
    if len(pages):
        lo, hi = int(pages.min()), int(pages.max())
    else:
        lo, hi = 0, 0
    pr = prefetcher_page_range(prefetcher)
    if pr is not None:
        lo, hi = min(lo, pr[0]), max(hi, pr[1])
    lo = (lo // ROOT_PAGES) * ROOT_PAGES
    hi = ((hi // ROOT_PAGES) + 1) * ROOT_PAGES
    return lo, hi
