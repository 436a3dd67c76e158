"""The port's replay core, copied from the reference ``repro.uvm.replay_core``
with the imports rewritten: the request type, the backend contract and
registry, the fallback chain, the shared helpers every backend derives its
constants from, and the NumPy chunked engine (:func:`replay_chunked`) with
its per-prefetcher adapters.

Three layers, as in the reference:

1. **Replay core (this module).**  The chunk classification /
   clock-cumsum / event-subsequence state machine over a dense page span
   (:func:`replay_chunked` plus the per-prefetcher scan/callback adapters),
   the :class:`ReplayBackend` interface and the registry.
2. **Backends (``repro_torch.uvm.backends``).**  ``cuda`` (kernel K1's lane
   batches; on a CPU device its plain version), ``numpy`` (this module's
   chunked engine, bit-identical to legacy) and ``legacy`` (the reference
   per-access loop, which accepts everything).
3. **Scheduler (``repro_torch.uvm.sweep``).**  Packs the cells K1 accepts
   into lane batches and sends every other cell down the chain one at a
   time through :func:`dispatch`; every row records the backend that ran
   it.

The chain moves a request on only where a backend *declines* it
(``can_replay`` is false; for ``cuda`` that is
``cuda_backend.decline_reason``).  No backend of the port is experimental:
a backend's runtime failure (a K1 build or launch error included)
propagates, and nothing replays the request elsewhere.

The timing model is ``repro_torch.uvm.simulator.UVMSimulator``; every
backend reproduces it on the golden matrix: integer counters exactly, float
accumulators to 1e-6 relative.

Replay-core state machine
-------------------------

* Residency lives in a dense per-page ``arrival``-cycle array over the
  (2 MB-aligned) page span of the trace instead of an ``OrderedDict``, so a
  whole chunk of accesses is classified with one gather.
* The per-access clock is reconstructed with ``np.cumsum`` seeded at the
  chunk-start clock.  NumPy's cumsum is the same sequential chain of float64
  additions as the legacy ``clock += cycles_per_access``, so every
  hit/late/fault comparison sees the exact same IEEE-754 values.
* Only the *event* subsequence (far-faults, accesses to in-flight pages,
  prefetch issues, MSHR stalls and evictions) runs through a scalar step
  that is a line-for-line port of the legacy loop, driving the *real*
  prefetcher callbacks so prefetcher state stays exact.
* Per-prefetcher scan adapters find the first continuous-prefetch event in a
  chunk without calling ``on_access`` per access (the tree prefetcher's dict
  is replaced by dense per-level count arrays, the block prefetcher's 64 KB
  window scan by one slice compare).
* LRU order under oversubscription is kept as monotone touch stamps plus a
  lazy min-heap, reproducing ``OrderedDict`` order exactly, including the
  reinsert-at-MRU of in-flight victims; ``random`` keeps per-page
  insert-time priority draws in a lazy heap, ``hotcold`` a (frequency,
  stamp) lazy heap.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import spans
from repro_torch.traces.trace import BASIC_BLOCK_PAGES, ROOT_PAGES, Trace
from repro_torch.uvm.config import UVMConfig
from repro_torch.uvm.eviction import (eviction_score, resolve_tenancy,
                                      validate_policy)
from repro_torch.uvm.prefetchers import (BlockPrefetcher, LearnedPrefetcher,
                                         NoPrefetcher, OraclePrefetcher,
                                         Prefetcher, TreePrefetcher)
from repro_torch.uvm.simulator import UVMSimulator, UVMStats, _tenant_accesses

#: beyond this many pages of span the dense state arrays stop paying for
#: themselves; the chain falls back to the legacy dict-based loop
MAX_SPAN_PAGES = 1 << 24

_INF = float("inf")


class TransientBackendFault(RuntimeError):
    """A backend failure that is expected to succeed on retry (device
    preemption, transient OOM, an injected fault).  Like every other
    runtime failure it propagates out of :func:`dispatch`; the sweep's
    retry layer re-runs the whole cell on the same backend, so the row's
    ``backend`` column never depends on a fault."""


# ---------------------------------------------------------------------------
# request / backend interface
# ---------------------------------------------------------------------------

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
    strict_checks: bool = False
    max_span_pages: int = MAX_SPAN_PAGES
    #: optional non-decreasing exclusive end indices into the access
    #: stream: the replay records the clock after the last access of each
    #: window in ``UVMStats.step_clocks`` (serve traces use decode-step
    #: boundaries here).  Every backend honours it bit-identically:
    #: legacy/numpy record host-side, K1 captures the clocks in-kernel.
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
    """A backend instance that replays on ``device`` (the host backends
    ignore it)."""
    _ensure_registry()
    try:
        return _REGISTRY[name](device=device)
    except KeyError:
        raise ValueError(f"unknown replay backend {name!r}; "
                         f"available: {sorted(_REGISTRY)}") from None


def available_backends() -> List[str]:
    _ensure_registry()
    return sorted(_REGISTRY)


def backend_chain(backend: str = "auto") -> List[str]:
    """Fallback order for a requested backend.  Every chain ends in
    ``legacy`` (which can replay anything); ``cuda`` and ``auto`` start at
    K1 on either device (on a CPU device the ``cuda`` backend runs K1's
    plain version)."""
    if backend == "legacy":
        return ["legacy"]
    if backend == "numpy":
        return ["numpy", "legacy"]
    if backend in ("cuda", "auto"):
        return ["cuda", "numpy", "legacy"]
    raise ValueError(f"unknown replay backend {backend!r}")


def resolve_backend(request: ReplayRequest, backend: str = "auto",
                    device: str = "cuda") -> ReplayBackend:
    """First backend in the fallback chain that can replay ``request``."""
    for name in backend_chain(backend):
        b = get_backend(name, device)
        if b.can_replay(request):
            return b
    raise AssertionError("legacy backend must accept every request")


def dispatch(request: ReplayRequest, backend: str = "auto",
             device: str = "cuda") -> UVMStats:
    """Replay one cell on the first backend of the chain that accepts it.
    Its runtime errors propagate: a failure is never served by a later
    backend of the chain."""
    return resolve_backend(request, backend, device).replay([request])[0]


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
    (aligned so block/tree extras always fall inside the span)."""
    pages = trace.pages
    if len(pages):
        spans.count("sweep.trace_scans")
        lo, hi = int(pages.min()), int(pages.max())
    else:
        lo, hi = 0, 0
    pr = prefetcher_page_range(prefetcher)
    if pr is not None:
        lo, hi = min(lo, pr[0]), max(hi, pr[1])
    lo = (lo // ROOT_PAGES) * ROOT_PAGES
    hi = ((hi // ROOT_PAGES) + 1) * ROOT_PAGES
    return lo, hi


def span_ok(request: ReplayRequest) -> bool:
    lo, hi = dense_bounds(request.trace, request.prefetcher)
    return lo >= 0 and (hi - lo) <= request.max_span_pages


# ---------------------------------------------------------------------------
# prefetcher adapters
# ---------------------------------------------------------------------------

class _ResidencyView:
    """Read-only dict façade over the arrival array for prefetcher callbacks
    (they only ever use ``page in resident``)."""

    __slots__ = ("arrival", "lo")

    def __init__(self, arrival: np.ndarray, lo: int) -> None:
        self.arrival = arrival
        self.lo = lo

    def __contains__(self, page) -> bool:
        i = int(page) - self.lo
        return 0 <= i < self.arrival.size and self.arrival[i] != _INF


class _BaseAdapter:
    """Engine-side façade over one prefetcher.

    Adapters own *all* prefetcher interaction inside the chunked replay:
    the chunk-wise ``scan`` for the next continuous-prefetch event, and the
    ``on_fault`` / ``on_migrate`` / ``on_evict`` callbacks raised by the
    scalar event step.  The base class delegates the callbacks to the real
    prefetcher object; state-heavy prefetchers (tree) override them with
    dense-array implementations that stay bit-identical to the legacy
    object while doing O(levels) array arithmetic instead of per-page
    Python dict walks.
    """

    def __init__(self, pf: Prefetcher) -> None:
        self.pf = pf

    def scan(self, i0: int, clocks: np.ndarray, seg: np.ndarray,
             limit: int) -> Optional[int]:
        return None

    def on_access(self, i: int, p: int, clock: float) -> List[int]:
        return []

    def on_fault(self, i: int, p: int, resident):
        return self.pf.on_fault(i, p, resident)

    def on_migrate(self, pages) -> None:
        self.pf.on_migrate(list(pages))

    def on_evict(self, page: int) -> None:
        self.pf.on_evict(page)


class _NullAccessAdapter(_BaseAdapter):
    """Prefetchers whose ``on_access`` is the no-op base implementation."""


class _BlockAdapter(_BaseAdapter):
    """Vectorized :class:`BlockPrefetcher`.

    The legacy object probes all 16 pages of the faulting 64 KB basic block
    through per-page ``in resident`` calls; here the whole window is
    classified with one slice compare on the arrival array.  The demand
    page is excluded automatically — the engine inserts it before raising
    ``on_fault``, so its arrival is already finite — and the ascending
    page order of the legacy list comprehension is preserved by
    ``np.nonzero``.
    """

    _SHIFT = BASIC_BLOCK_PAGES.bit_length() - 1      # 16 pages -> 4 bits

    def __init__(self, pf: BlockPrefetcher, arrival: np.ndarray,
                 lo: int) -> None:
        super().__init__(pf)
        self.arrival = arrival
        self.lo = lo

    def on_fault(self, i: int, p: int, resident) -> np.ndarray:
        pi = int(p) - self.lo
        blk = (pi >> self._SHIFT) << self._SHIFT
        out = np.nonzero(
            self.arrival[blk:blk + BASIC_BLOCK_PAGES] == _INF)[0]
        return out + (blk + self.lo)


class _TreeAdapter(_BaseAdapter):
    """Vectorized :class:`TreePrefetcher` state.

    The legacy object keeps a ``(level, node) -> count`` dict and walks it
    per page in pure Python; with up-to-512-page escalation batches that
    makes the tree path the slowest replay.  Here node occupancy lives in
    dense per-level ``int32`` arrays over the trace's (2 MB-aligned) page
    span, so:

    * ``on_migrate`` of a k-page batch is ``LEVELS+1`` ``np.add.at`` calls
      instead of ``6k`` dict updates,
    * ``on_evict`` is ``LEVELS+1`` scalar decrements,
    * ``on_fault`` classifies the whole 2 MB root window (residency,
      pending, escalation counts) with array slices and emits the exact
      extras list — same pages, same ascending order per level — that the
      legacy dict walk produces, which the golden harness pins bit-exact.

    ``lo`` is ROOT_PAGES-aligned, so relative node indices coincide with
    the legacy object's absolute ``page // span`` nodes at every level.
    """

    LEVELS = TreePrefetcher.LEVELS
    _SHIFT = BASIC_BLOCK_PAGES.bit_length() - 1      # 16 pages -> 4 bits

    def __init__(self, pf: TreePrefetcher, arrival: np.ndarray,
                 lo: int) -> None:
        super().__init__(pf)
        self.arrival = arrival
        self.lo = lo
        span = arrival.size
        self.counts = [
            np.zeros(span >> (self._SHIFT + lv), dtype=np.int32)
            for lv in range(self.LEVELS + 1)
        ]

    def on_migrate(self, pages) -> None:
        if len(pages) == 1:
            pi = int(pages[0]) - self.lo
            for lv in range(self.LEVELS + 1):
                self.counts[lv][pi >> (self._SHIFT + lv)] += 1
            return
        rel = np.asarray(pages, dtype=np.int64) - self.lo
        for lv in range(self.LEVELS + 1):
            np.add.at(self.counts[lv], rel >> (self._SHIFT + lv), 1)

    def on_evict(self, page: int) -> None:
        pi = int(page) - self.lo
        for lv in range(self.LEVELS + 1):
            self.counts[lv][pi >> (self._SHIFT + lv)] -= 1

    def on_fault(self, i: int, p: int, resident) -> np.ndarray:
        pi = int(p) - self.lo
        root = (pi // ROOT_PAGES) * ROOT_PAGES
        rel = pi - root
        nonres = self.arrival[root:root + ROOT_PAGES] == _INF
        # 1) the faulting basic block (the demand page is already resident
        #    here — the engine inserts it before raising on_fault — so
        #    ``nonres`` excludes it exactly like the legacy checks)
        blk = (rel >> self._SHIFT) << self._SHIFT
        out = np.nonzero(nonres[blk:blk + BASIC_BLOCK_PAGES])[0] + blk
        # 2) >50% escalation walk, counting the about-to-arrive pages too
        pend = np.zeros(ROOT_PAGES, dtype=bool)
        pend[out] = True
        pend[rel] = True
        for lv in range(1, self.LEVELS + 1):
            span = BASIC_BLOCK_PAGES << lv
            nb = (rel // span) * span
            node = (root + nb) >> (self._SHIFT + lv)
            cnt = int(self.counts[lv][node]) + int(pend[nb:nb + span].sum())
            if cnt * 2 > span:
                extra = np.nonzero(nonres[nb:nb + span]
                                   & ~pend[nb:nb + span])[0] + nb
                out = np.concatenate([out, extra])
                pend[extra] = True
            else:
                break
        return out + (root + self.lo)


class _LearnedAdapter(_BaseAdapter):
    """Replays ``LearnedPrefetcher.on_access`` arithmetically.

    The gate is a serialized inference server: an access fires iff
    ``clock >= next_free`` and then sets ``next_free = clock + extra``.
    Within a chunk the exact clocks are known, so firing positions are a
    deterministic chain; only a firing whose top-1 prediction is valid,
    different from the demand page, and non-resident is an *event*.
    """

    def __init__(self, pf: LearnedPrefetcher, arrival: np.ndarray, lo: int,
                 cpa: float) -> None:
        self.pf = pf
        self.preds = np.asarray(pf.predicted_pages, dtype=np.int64)
        self.extra = float(pf.extra_latency_cycles)
        self.arrival = arrival
        self.lo = lo
        self.cpa = cpa
        self.nf = float(pf._next_free)  # 0.0 after reset()

    def scan(self, i0, clocks, seg, limit) -> Optional[int]:
        if limit <= 0:
            return None
        cl = clocks[:limit]
        j0 = 0 if self.nf <= cl[0] else int(
            np.searchsorted(cl, self.nf, side="left"))
        if j0 >= limit:
            return None                      # gate closed for the whole prefix
        if self.extra <= self.cpa:
            # once open, the gate fires on every access (extra <= 1/rate)
            pr = self.preds[i0 + j0:i0 + limit]
            abspg = seg[j0:limit] + self.lo
            valid = (pr >= 0) & (pr != abspg)
            act = np.zeros(limit - j0, dtype=bool)
            if valid.any():
                act[valid] = ~np.isfinite(self.arrival[pr[valid] - self.lo])
            if act.any():
                c = j0 + int(np.argmax(act))
                if c > j0:                   # commit the no-op firings
                    self.nf = float(cl[c - 1]) + self.extra
                return c
            self.nf = float(cl[limit - 1]) + self.extra
            return None
        # sparse gating (extra > cycles/access): firings step by a nearly
        # constant stride ceil(extra/cpa) — generate the candidate chain at
        # that stride and verify it with vector comparisons (the chunk clocks
        # are an exact fp chain, so each step can wobble by at most one)
        k_star = max(1, int(np.ceil(self.extra / self.cpa)))
        poss = np.arange(j0, limit, k_star)
        thr = cl[poss] + self.extra          # nf value set by each firing
        chain_ok = True
        if poss.size > 1:
            nxt = poss[1:]
            chain_ok = bool(np.all(cl[nxt] >= thr[:-1])
                            and np.all(cl[nxt - 1] < thr[:-1]))
        if chain_ok and poss[-1] + k_star - 1 < limit:
            # tail: no extra firing may sneak in before the chunk ends
            chain_ok = bool(cl[poss[-1] + k_star - 1] < thr[-1])
        if chain_ok:
            prs = self.preds[i0 + poss]
            abspg = seg[poss] + self.lo
            valid = (prs >= 0) & (prs != abspg)
            act = np.zeros(poss.size, dtype=bool)
            if valid.any():
                act[valid] = ~np.isfinite(self.arrival[prs[valid] - self.lo])
            if act.any():
                mi = int(np.argmax(act))
                if mi > 0:                   # commit the no-op firings
                    self.nf = float(thr[mi - 1])
                return int(poss[mi])
            self.nf = float(thr[-1])
            return None
        # fp wobble broke the constant stride: exact scalar walk
        j = j0
        while j < limit:
            pred = int(self.preds[i0 + j])
            if (pred >= 0 and pred != int(seg[j]) + self.lo
                    and self.arrival[pred - self.lo] == _INF):
                return j                     # on_access at j handles the rest
            self.nf = float(cl[j]) + self.extra
            j = int(np.searchsorted(cl, self.nf, side="left"))
        return None

    def on_access(self, i, p, clock) -> List[int]:
        # line-for-line port of LearnedPrefetcher.on_access (shadowed gate)
        if clock < self.nf:
            return []
        self.nf = clock + self.extra
        pred = int(self.preds[i])
        if (pred >= 0 and pred != p
                and self.arrival[pred - self.lo] == _INF):
            return [pred]
        return []


class _OracleAdapter(_BaseAdapter):
    """Oracle lookahead windows checked with one cumulative sum per chunk.

    ``pf.pos`` is a pure function of the access index (it only advances), so
    the real object self-heals when ``on_access`` finally runs at an event.
    """

    def __init__(self, pf: OraclePrefetcher, arrival: np.ndarray, lo: int,
                 view: _ResidencyView) -> None:
        self.pf = pf
        self.arrival = arrival
        self.lo = lo
        self.view = view

    def scan(self, i0, clocks, seg, limit) -> Optional[int]:
        if limit <= 0:
            return None
        ft_idx = self.pf.ft_index
        ft_pages = self.pf.ft_pages
        look = self.pf.lookahead
        pos = np.searchsorted(ft_idx, np.arange(i0, i0 + limit), side="right")
        a = int(pos[0])
        b = min(int(pos[-1]) + look, len(ft_pages))
        if a >= b:
            return None
        nr = ~np.isfinite(self.arrival[ft_pages[a:b].astype(np.int64) - self.lo])
        cs = np.concatenate(([0], np.cumsum(nr)))
        start = pos - a
        end = np.minimum(pos + look, len(ft_pages)) - a
        act = (cs[end] - cs[start]) > 0
        if act.any():
            return int(np.argmax(act))
        return None

    def on_access(self, i, p, clock) -> List[int]:
        return self.pf.on_access(i, p, self.view, clock)


#: exact prefetcher types with a scan adapter and a known page extent (all
#: pages they can emit fit the 2MB-aligned span of accesses + predictions).
#: Unknown subclasses fall back to the legacy engine wholesale — they could
#: prefetch pages outside the dense state arrays.
SUPPORTED_PREFETCHERS = (NoPrefetcher, BlockPrefetcher, TreePrefetcher,
                         LearnedPrefetcher, OraclePrefetcher)


def _make_adapter(pf: Prefetcher, arrival: np.ndarray, lo: int,
                  view: _ResidencyView, cpa: float):
    t = type(pf)
    if t is NoPrefetcher:
        return _NullAccessAdapter(pf)
    if t is BlockPrefetcher:
        return _BlockAdapter(pf, arrival, lo)
    if t is TreePrefetcher:
        return _TreeAdapter(pf, arrival, lo)
    if t is LearnedPrefetcher:
        return _LearnedAdapter(pf, arrival, lo, cpa)
    if t is OraclePrefetcher:
        return _OracleAdapter(pf, arrival, lo, view)
    raise AssertionError(f"unsupported prefetcher type {t!r}")


# ---------------------------------------------------------------------------
# the chunked replay state machine (NumPy array program)
# ---------------------------------------------------------------------------

def replay_chunked(request: ReplayRequest) -> UVMStats:
    """Replay one request with the NumPy-chunked state machine.

    Bit-identical to ``UVMSimulator`` for every supported prefetcher type;
    callers are expected to have checked :data:`SUPPORTED_PREFETCHERS` and
    :func:`span_ok` (the NumPy backend does) — unsupported requests raise.
    """
    trace, prefetcher, cfg = (request.trace, request.prefetcher,
                              request.config)
    if type(prefetcher) not in SUPPORTED_PREFETCHERS:
        raise ValueError(f"unsupported prefetcher {type(prefetcher)!r}; "
                         "route through the legacy backend")
    prefetcher.reset()
    pages = np.ascontiguousarray(trace.pages, dtype=np.int64)
    n = len(pages)
    cpa = cycles_per_access(trace, cfg)

    # --- dense page-state span (2MB-aligned so block/tree extras fit)
    lo, hi = dense_bounds(trace, prefetcher)
    span = hi - lo
    if lo < 0 or span > request.max_span_pages:
        raise ValueError(f"page span [{lo}, {hi}) too large for dense "
                         "replay; route through the legacy backend")

    arrival = np.full(span, _INF, dtype=np.float64)
    pfu = np.zeros(span, dtype=bool)      # prefetched-but-unused flags
    pg = pages - lo
    cap = cfg.device_pages
    track_lru = cap is not None
    policy = validate_policy(cfg.eviction)
    hotcold = policy == "hotcold"
    randomp = policy == "random"
    stamp = np.zeros(span, dtype=np.int64) if track_lru else None
    # hotcold: per-page touches since migration; random: per-page
    # insert-time priority draws (lazy heaps over both, like the LRU one)
    freq = np.zeros(span, dtype=np.int64) if (track_lru and hotcold) else None
    prio = np.zeros(span, dtype=np.int64) if (track_lru and randomp) else None
    # multi-tenant traces (repro_torch.traces.interleave): per-tenant hit
    # counters always; per-tenant residency counters + tenant-masked
    # victim selection only under hard quotas (Tenancy.split).  The lazy
    # heaps shard by tenant at insert time — without a split everything
    # lands in shard 0, so the single-tenant pop order is untouched.
    tenancy = resolve_tenancy(trace, cfg)
    split = track_lru and tenancy is not None and tenancy.split
    bnd = (tenancy.boundary - lo) if tenancy is not None else 0
    rc = [0, 0]                            # per-tenant resident counts
    th = [0, 0]                            # per-tenant hits
    lru_heaps: List[List[Tuple[int, int]]] = [[], []]
    hc_heaps: List[List[Tuple[int, int, int]]] = [[], []]
    rand_heaps: List[List[Tuple[int, int]]] = [[], []]
    counter = 0                            # monotone LRU touch counter
    resident_count = 0

    def _shard(pi: int) -> int:
        return 1 if (split and pi >= bnd) else 0

    clock = 0.0
    pcie_free = 0.0
    outstanding: List[float] = []
    hits = late = faults = 0
    prefetch_issued = prefetch_used = 0
    pages_migrated = pages_evicted = 0
    pcie_bytes = 0.0
    timeline: List[Tuple[float, float]] = []

    page_tx = cfg.page_transfer_cycles
    ff = cfg.far_fault_cycles
    mshr = cfg.mshr_entries
    record = request.record_timeline
    strict = request.strict_checks

    # step-window clock capture (ReplayRequest.step_bounds): windows are
    # marked as the replay crosses their exclusive end index — in the
    # scalar event step and in the vector-hit path, where the chunk's
    # exact cumsum clocks are available per access
    if request.step_bounds is not None:
        sb = np.asarray(request.step_bounds, dtype=np.int64)
        if sb.size and (np.any(np.diff(sb) < 0) or sb[-1] > n):
            raise ValueError("step_bounds must be non-decreasing end "
                             "indices <= n_accesses")
        step_clocks = np.zeros(sb.size, dtype=np.float64)
    else:
        sb = None
        step_clocks = None
    sp = 0
    while sb is not None and sp < sb.size and sb[sp] == 0:
        sp += 1                      # leading empty windows end at clock 0.0

    view = _ResidencyView(arrival, lo)
    adapter = _make_adapter(prefetcher, arrival, lo, view, cpa)

    # --- scalar event step: line-for-line port of UVMSimulator.run ----
    def _insert(pi: int, t: float) -> None:
        """Page becomes resident/in-flight at MRU position."""
        nonlocal resident_count, counter
        if arrival[pi] == _INF:
            resident_count += 1
            if split:
                rc[1 if pi >= bnd else 0] += 1
            if track_lru:
                stamp[pi] = counter
                sh = _shard(pi)
                if hotcold:
                    freq[pi] = 0
                    heapq.heappush(hc_heaps[sh], (0, counter, pi))
                elif randomp:
                    pr = eviction_score(pi + lo, counter)
                    prio[pi] = pr
                    heapq.heappush(rand_heaps[sh], (pr, pi))
                else:
                    heapq.heappush(lru_heaps[sh], (counter, pi))
            counter += 1
        arrival[pi] = t                    # overwrite keeps LRU position

    def _retouch(pi: int) -> None:
        """move_to_end: stale heap entries self-heal at pop time."""
        nonlocal counter
        if track_lru:
            stamp[pi] = counter
            if hotcold:
                freq[pi] += 1
        counter += 1

    def _schedule(extras, batch: bool) -> None:
        nonlocal pcie_free, pages_migrated, pcie_bytes, prefetch_issued
        nonlocal resident_count, counter
        k = len(extras)
        ex_ready = (clock + cfg.prefetch_overhead_cycles
                    + prefetcher.extra_latency_cycles)
        ex_start = max(pcie_free, ex_ready)
        end = ex_start + k * page_tx
        if batch and not track_lru and k > 1:
            # batch DMA without LRU tracking: every page arrives at
            # batch completion, extras are unique and non-resident by
            # the supported prefetchers' contract — apply in one shot
            idx = np.asarray(extras, dtype=np.int64) - lo
            ex_arr = end + cfg.pcie_latency_cycles
            if strict:
                assert not np.isfinite(arrival[idx]).any(), \
                    "prefetch batch contains resident pages"
            arrival[idx] = ex_arr
            pfu[idx] = True
            resident_count += k
            counter += k
            pages_migrated += k
            pcie_bytes += k * cfg.page_size
            if record:
                timeline.extend([(ex_arr, float(cfg.page_size))] * k)
        else:
            t = ex_start
            for q in extras:
                t += page_tx
                ex_arr = (end if batch else t) + cfg.pcie_latency_cycles
                _insert(int(q) - lo, ex_arr)
                pfu[int(q) - lo] = True
                pages_migrated += 1
                pcie_bytes += cfg.page_size
                if record:
                    timeline.append((ex_arr, float(cfg.page_size)))
        pcie_free = end
        prefetch_issued += k
        adapter.on_migrate(extras)

    def _select_victim(sh: int) -> int:
        """Policy victim from heap shard ``sh`` (the over-quota tenant, or
        0 without a split): lazy-heap min of (stamp) / (prio, page) /
        (freq, stamp) — stale entries self-heal at pop time.  The LRU
        branch pops its entry (the spare path re-pushes); the other
        policies peek (their stale tops heal on the next selection)."""
        if hotcold:
            heap = hc_heaps[sh]
            while True:
                f, s, vi = heap[0]
                if arrival[vi] == _INF:
                    heapq.heappop(heap)        # evicted since: stale
                    continue
                if freq[vi] != f or stamp[vi] != s:
                    heapq.heapreplace(heap,
                                      (int(freq[vi]), int(stamp[vi]), vi))
                    continue
                return vi
        if randomp:
            heap = rand_heaps[sh]
            while True:
                pr, vi = heap[0]
                if arrival[vi] == _INF or prio[vi] != pr:
                    heapq.heappop(heap)        # evicted or re-drawn
                    continue
                return vi
        heap = lru_heaps[sh]
        while True:                        # lazy-heap pop of the true LRU
            s, vi = heapq.heappop(heap)
            if arrival[vi] == _INF:
                continue                   # evicted since: stale entry
            if stamp[vi] != s:
                heapq.heappush(heap, (int(stamp[vi]), vi))
                continue
            return vi

    def _over() -> bool:
        """Eviction pressure: over total capacity, or (quota split) any
        tenant over its current allowance."""
        if not track_lru:
            return False
        if split:
            a0, a1 = tenancy.allowed(rc[0], rc[1])
            return rc[0] > a0 or rc[1] > a1
        return resident_count > cap

    def _evict_loop() -> None:
        nonlocal resident_count, pages_evicted, pcie_bytes, pcie_free
        nonlocal counter
        while True:
            if split:
                # per-tenant quotas: trim whichever tenant is over its
                # allowance, tenant 0 first — same order as the legacy
                # loop and K1
                a0, a1 = tenancy.allowed(rc[0], rc[1])
                if rc[0] > a0:
                    u = 0
                elif rc[1] > a1:
                    u = 1
                else:
                    break
            else:
                if resident_count <= cap:
                    break
                u = 0
            vi = _select_victim(u)
            v_arr = float(arrival[vi])
            if v_arr > clock:
                # never evict in-flight pages; retouch at MRU (the
                # legacy loop's reinsert) — random keeps its insert-time
                # priority, so only the shared counter ticks for it
                stamp[vi] = counter
                if hotcold:
                    freq[vi] += 1
                elif not randomp:
                    heapq.heappush(lru_heaps[u], (counter, vi))
                counter += 1
                break
            if strict:
                assert v_arr <= clock, "evicted an in-flight page"
            arrival[vi] = _INF
            resident_count -= 1
            if split:
                rc[u] -= 1
            pfu[vi] = False
            adapter.on_evict(vi + lo)
            pages_evicted += 1
            # writeback traffic (assume half the evictions dirty)
            if pages_evicted % 2 == 0:
                pcie_bytes += cfg.page_size
                pcie_free += page_tx

    def _step(i: int) -> None:
        nonlocal clock, hits, late, faults, prefetch_used
        nonlocal pcie_free, pages_migrated, pcie_bytes, sp
        prev = clock
        clock += cpa
        p = int(pages[i])
        pi = p - lo
        a = arrival[pi]
        if a != _INF:
            if a <= clock:
                hits += 1
                if tenancy is not None:
                    th[1 if pi >= bnd else 0] += 1
            else:
                late += 1
                heapq.heappush(outstanding, float(a))
            if pfu[pi]:
                prefetch_used += 1
                pfu[pi] = False
            _retouch(pi)
        else:
            faults += 1
            ready = ((clock // ff) + 2.0) * ff + cfg.page_table_walk_cycles
            start = max(ready, pcie_free)
            arr_v = start + cfg.pcie_latency_cycles + page_tx
            pcie_free = start + page_tx
            _insert(pi, arr_v)
            pages_migrated += 1
            pcie_bytes += cfg.page_size
            if record:
                timeline.append((arr_v, float(cfg.page_size)))
            heapq.heappush(outstanding, arr_v)
            adapter.on_migrate([p])
            extras = adapter.on_fault(i, p, view)
            if len(extras):
                _schedule(extras, True)
        extras = adapter.on_access(i, p, clock)
        if len(extras):
            _schedule(extras, False)
        while len(outstanding) > mshr:
            clock = max(clock, heapq.heappop(outstanding))
        if track_lru:
            _evict_loop()
        if strict:
            assert clock >= prev, "clock moved backwards"
        if sb is not None:
            # the step for access i completes windows ending at i+1
            # (duplicate bounds = empty windows repeating this clock)
            while sp < sb.size and sb[sp] <= i + 1:
                step_clocks[sp] = clock
                sp += 1

    # --- chunked main loop -------------------------------------------
    i = 0
    chunk = 512
    dense = 0      # consecutive chunk scans that hit an event at offset 0
    while i < n:
        if _over():
            # eviction dribble: legacy retries the victim pop every
            # access (total cap, or any tenant over its quota allowance)
            _step(i)
            i += 1
            continue
        if dense >= 4:
            # event storm: chunk scans are pure overhead — run scalar
            # until a hit run resumes (the step itself is always exact)
            streak = 0
            while i < n and streak < 24:
                a = arrival[pg[i]]
                plain = a != _INF and a <= clock + cpa
                _step(i)
                i += 1
                streak = streak + 1 if plain else 0
                if _over():
                    break
            dense = 0
            chunk = 64
            continue

        k = min(chunk, n - i)
        seg = pg[i:i + k]
        incr = np.full(k, cpa)
        incr[0] = clock + cpa
        clocks = np.cumsum(incr)           # exact: same fp chain as +=
        arr_seg = arrival[seg]
        bad = (arr_seg == _INF) | (arr_seg > clocks)
        fl = int(np.argmax(bad)) if bad.any() else k
        cand = adapter.scan(i, clocks, seg, fl)
        event = fl if cand is None else cand

        if event > 0:                      # vector-apply the pure hits
            h = event
            hseg = seg[:h]
            hits += h
            if tenancy is not None:
                n1 = int((hseg >= bnd).sum())
                th[1] += n1
                th[0] += h - n1
            m = pfu[hseg]
            if m.any():
                # first hit on each prefetched-unused page consumes it
                uniq = np.unique(hseg[m])
                prefetch_used += int(uniq.size)
                pfu[uniq] = False
            if track_lru:
                np.maximum.at(stamp, hseg,
                              counter + np.arange(h, dtype=np.int64))
                if hotcold:
                    np.add.at(freq, hseg, 1)
            counter += h
            clock = float(clocks[h - 1])
            if sb is not None:
                # windows ending inside the pure-hit run close at the
                # exact cumsum clock of their last access — the same
                # fp value the legacy += chain produces there
                while sp < sb.size and sb[sp] <= i + h:
                    step_clocks[sp] = float(clocks[sb[sp] - 1 - i])
                    sp += 1
            i += h
            dense = 0
        if event < k and i < n:
            _step(i)
            i += 1
            if event == 0:
                dense += 1
            chunk = max(32, min(2 * max(event, 1), 65536))
        else:
            chunk = min(chunk * 2, 65536)

    # drain: all outstanding stalls resolve
    while outstanding:
        clock = max(clock, heapq.heappop(outstanding))

    return UVMStats(
        name=trace.name,
        prefetcher=prefetcher.name,
        n_accesses=n,
        n_instructions=trace.n_instructions,
        cycles=clock,
        hits=hits,
        late=late,
        faults=faults,
        prefetch_issued=prefetch_issued,
        prefetch_used=prefetch_used,
        pages_migrated=pages_migrated,
        pages_evicted=pages_evicted,
        pcie_bytes=pcie_bytes,
        zero_copy_bytes=0.0,
        timeline=np.asarray(timeline) if record else None,
        eviction=cfg.eviction,
        step_clocks=step_clocks,
        tenant_hits=(th[0], th[1]) if tenancy is not None else None,
        tenant_accesses=_tenant_accesses(pages, tenancy),
    )


def run_legacy(request: ReplayRequest) -> UVMStats:
    """Replay one request on the reference per-access loop."""
    return UVMSimulator(request.config, request.record_timeline).run(
        request.trace, request.prefetcher,
        step_bounds=request.step_bounds)
