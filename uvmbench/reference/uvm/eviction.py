"""Pluggable eviction policies for the UVM replay stack.

The paper's oversubscription results hinge on how the device frees pages
when capacity runs out; "An Intelligent Framework for Oversubscription
Management in CPU-GPU Unified Memory" (arXiv 2204.02974) shows the choice
of policy (LRU vs. random vs. access-pattern-aware) swings oversubscribed
performance by double digits.  This module defines the policy vocabulary
shared by every replay backend:

* ``lru`` — least-recently-used, the historical behavior (the legacy
  ``OrderedDict`` order / the monotone touch-stamp argmin).  Default;
  golden fixtures recorded before the policy axis replay bit-identically.
* ``random`` — counter-based deterministic pseudo-random replacement: a
  page draws a 32-bit priority from :func:`eviction_scores` **at insertion
  time** (the draw is the monotone insert/touch counter, so re-insertions
  draw fresh priorities), and the victim is the resident page with the
  smallest ``(priority, page)``.  Deterministic, seedless, and identical
  across backends: the legacy loop hashes Python ints, the NumPy engine
  hashes ``uint32`` arrays, and the pallas kernel replays the same mixer
  in ``jnp.uint32`` — all three wrap mod 2**32 by construction.
* ``hotcold`` — access-frequency (cold-first) replacement per 2204.02974:
  each resident page counts its touches since migration; the victim is
  the resident page with the smallest ``(frequency, LRU-stamp)`` — the
  coldest page, ties broken least-recently-used.  Prefetched-but-unused
  pages (frequency 0) are evicted first, which is exactly the
  access-pattern-aware intuition.

Every backend must agree on the *victim sequence* (pinned by the golden
and differential suites): the policy semantics here — including the
in-flight-victim rule (a selected victim that has not arrived yet is
spared, retouched at MRU, and the eviction round stops) and the event
counter (one tick per page insert and per resident touch, shared with the
LRU stamps) — are the single source of truth.

The scalar/array scorer below is the reference for the ``random`` mixer;
``pallas_backend`` re-implements the identical operation chain in jnp and
the test suites pin the equality.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Tuple

import numpy as np

#: policy vocabulary, in CLI/registry order (``lru`` is the default and
#: must stay first: code that predates the policy axis assumes it)
EVICTION_POLICIES = ("lru", "random", "hotcold")

_MASK32 = 0xFFFFFFFF
#: mixer constants (32-bit finalizer, low-bias): the jnp re-implementation
#: in ``pallas_backend._rand_score`` must use the exact same chain
SCORE_SEED_MULT = 0x9E3779B9
SCORE_MULT_1 = 0x21F0AAAD
SCORE_MULT_2 = 0x735A2D97


def validate_policy(name: str) -> str:
    if name not in EVICTION_POLICIES:
        raise ValueError(f"unknown eviction policy {name!r}; "
                         f"choose from {', '.join(EVICTION_POLICIES)}")
    return name


def eviction_scores(pages, draw) -> np.ndarray:
    """uint32 priority per page for the ``random`` policy.

    ``pages`` are absolute page ids (truncated mod 2**32); ``draw`` is the
    per-page insert-event counter value (scalar or array).  All arithmetic
    wraps mod 2**32 — NumPy array ops wrap silently, and the seeds are
    pre-masked Python ints so no scalar-overflow warnings fire.
    """
    x = (np.asarray(pages, dtype=np.int64) & _MASK32).astype(np.uint32)
    # at-least-1d operands: NumPy *array* integer ops wrap silently, but
    # scalar ops would raise overflow RuntimeWarnings
    d = np.atleast_1d(
        (np.asarray(draw, dtype=np.int64) & _MASK32)).astype(np.uint32)
    x = np.atleast_1d(x) ^ (d * np.uint32(SCORE_SEED_MULT))
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(SCORE_MULT_1)
    x = x ^ (x >> np.uint32(15))
    x = x * np.uint32(SCORE_MULT_2)
    x = x ^ (x >> np.uint32(15))
    return x


def eviction_score(page: int, draw: int) -> int:
    """Scalar :func:`eviction_scores` as a pure-int mixer — this sits in
    the per-insert hot path of both the legacy loop and the NumPy
    engine's ``random`` policy, where one-element array round trips cost
    more than the hash itself.  ``tests/test_scenarios.py`` pins it equal
    to the array version."""
    x = (int(page) & _MASK32) ^ ((int(draw) * SCORE_SEED_MULT) & _MASK32)
    x ^= x >> 16
    x = (x * SCORE_MULT_1) & _MASK32
    x ^= x >> 15
    x = (x * SCORE_MULT_2) & _MASK32
    x ^= x >> 15
    return x


# ---------------------------------------------------------------------------
# tenancy: per-tenant capacity partitioning for multi-tenant traces
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Tenancy:
    """Resolved tenancy of one replay: the page-region boundary of a
    multi-tenant trace (``repro.traces.interleave``) plus the optional
    hard quotas partitioning device capacity.

    ``quotas=None`` is **shared mode**: both tenants contend for the whole
    device exactly like the single-tenant model (per-tenant stats are
    still recorded — it is the interference-allowed baseline the isolation
    property test contrasts against).  With quotas ``(q0, q1)``, tenant
    ``t`` owns ``q_t`` pages outright and may additionally borrow from the
    ``spill`` pool (``device_pages - q0 - q1``) whatever the co-tenant is
    not currently borrowing — so victim selection for tenant ``t`` is
    masked to tenant ``t``'s own resident pages, and a thrashing co-tenant
    can never evict a quota-protected tenant's pages.
    """

    boundary: int                          # first page of tenant 1's region
    quotas: Optional[Tuple[int, int]]      # hard per-tenant quotas, or None
    spill: int                             # shared pool beyond the quotas

    @property
    def split(self) -> bool:
        return self.quotas is not None

    def tenant_of(self, page: int) -> int:
        return 1 if page >= self.boundary else 0

    def allowed(self, rc0: int, rc1: int) -> Tuple[int, int]:
        """Per-tenant residency ceilings given current residencies: quota
        plus whatever spill the co-tenant has not borrowed.  The pallas
        kernel re-implements this arithmetic in int32; the differential
        suite pins the equality."""
        q0, q1 = self.quotas
        a0 = q0 + max(0, self.spill - max(0, rc1 - q1))
        a1 = q1 + max(0, self.spill - max(0, rc0 - q0))
        return a0, a1


def resolve_tenancy(trace, config) -> Optional[Tenancy]:
    """The single tenancy-validation chokepoint shared by all three
    backends: returns None for a plain single-tenant replay, a
    :class:`Tenancy` for a multi-tenant trace, and raises on inconsistent
    requests (quotas without a multi-tenant trace, quotas without a
    capacity, quotas exceeding the capacity)."""
    from uvmbench.reference.traces.interleave import tenant_boundary
    boundary = tenant_boundary(trace)
    tp = getattr(config, "tenant_pages", None)
    if tp is None:
        if boundary is None:
            return None
        return Tenancy(boundary=boundary, quotas=None, spill=0)
    if boundary is None:
        raise ValueError(
            f"config.tenant_pages={tp!r} but trace {trace.name!r} is not "
            "multi-tenant (no meta['mt'] sidecar; build it via "
            "repro.traces.interleave.build_mt_trace)")
    if config.device_pages is None:
        raise ValueError(
            "config.tenant_pages requires device_pages: quotas partition "
            "a finite device capacity")
    quotas = tuple(int(q) for q in tp)
    if len(quotas) != 2 or any(q < 0 for q in quotas):
        raise ValueError(f"tenant_pages must be two non-negative page "
                         f"counts, got {tp!r}")
    spill = int(config.device_pages) - sum(quotas)
    if spill < 0:
        raise ValueError(
            f"tenant_pages {quotas} exceed device_pages "
            f"{config.device_pages} (spill would be {spill})")
    return Tenancy(boundary=boundary, quotas=quotas, spill=spill)


# ---------------------------------------------------------------------------
# reference policy objects (the legacy per-access loop drives these; the
# NumPy and pallas engines replay the same semantics vectorized)
# ---------------------------------------------------------------------------

class EvictionPolicy:
    """Victim-selection strategy for the legacy simulator.

    The simulator calls, only when ``device_pages`` is set:

    * ``on_insert(page)`` — page became resident (demand fault or
      prefetch).  Idempotent for already-resident pages (matches the
      engines, which never re-draw state for an overwrite).
    * ``on_touch(page)`` — resident page touched (hit/late access, or an
      in-flight victim spared by the eviction loop and retouched at MRU).
    * ``on_evict(page)`` — page left residency.
    * ``select_victim(resident, tenant=None)`` — the next victim among
      the keys of ``resident`` (the simulator's page → arrival
      ``OrderedDict``, kept in exact LRU order by the access loop).
      With per-tenant quotas the simulator first calls
      :meth:`bind_tenancy` and then passes the over-quota tenant id, and
      selection is masked to that tenant's resident pages — the policy's
      internal ordering (LRU order, random priorities, hotcold keys) is
      unchanged; only the candidate set shrinks.

    The event counter (one tick per insert and per touch) is shared
    vocabulary with the vectorized engines' LRU touch stamps — policies
    that consume it (random draws, hotcold tie-breaks) stay identical
    across backends because every backend ticks it on the same events.
    """

    name = "abstract"

    #: page -> tenant id mapping when quota-split tenancy is bound
    #: (bind_tenancy); None = single-tenant / shared-capacity selection
    _tenant_of = None

    def bind_tenancy(self, tenant_of) -> None:
        """Install a ``page -> tenant`` mapping so victim selection can be
        masked per tenant.  Must be called before any ``on_insert`` (the
        heap-backed policies shard their heaps by tenant at insert time)."""
        self._tenant_of = tenant_of

    def reset(self) -> None:
        pass

    def on_insert(self, page: int) -> None:
        pass

    def on_touch(self, page: int) -> None:
        pass

    def on_evict(self, page: int) -> None:
        pass

    def select_victim(self, resident, tenant: Optional[int] = None) -> int:
        raise NotImplementedError


class LRUEviction(EvictionPolicy):
    """Least-recently-used: the simulator's ``resident`` OrderedDict *is*
    the LRU order (every touch moves to end), so the victim is simply its
    first key — exactly the historical ``popitem(last=False)``."""

    name = "lru"

    def select_victim(self, resident, tenant: Optional[int] = None) -> int:
        if tenant is None or self._tenant_of is None:
            return next(iter(resident))
        # masked LRU: the least-recently-used page OF THIS TENANT — the
        # OrderedDict is already in LRU order, so the first match is it
        return next(p for p in resident if self._tenant_of(p) == tenant)


class RandomEviction(EvictionPolicy):
    """Counter-based deterministic pseudo-random replacement.

    Each page draws ``eviction_score(page, counter)`` when it becomes
    resident (so re-insertions re-draw), and the victim is the resident
    page minimizing ``(priority, page)``.  Priorities are static while
    resident, so selection is a lazy min-heap: stale entries (evicted or
    re-drawn pages) self-heal at pop time.
    """

    name = "random"

    def reset(self) -> None:
        self.counter = 0
        self.prio: Dict[int, int] = {}
        # heaps sharded by tenant id (None = unmasked): priorities are
        # unchanged by tenancy, only which shard gets popped from
        self.heaps: Dict[Optional[int], List[Tuple[int, int]]] = {None: []}

    def _heap(self, page: int) -> List[Tuple[int, int]]:
        key = self._tenant_of(page) if self._tenant_of else None
        return self.heaps.setdefault(key, [])

    def on_insert(self, page: int) -> None:
        if page in self.prio:
            return
        pr = eviction_score(page, self.counter)
        self.prio[page] = pr
        heapq.heappush(self._heap(page), (pr, page))
        self.counter += 1

    def on_touch(self, page: int) -> None:
        self.counter += 1

    def on_evict(self, page: int) -> None:
        del self.prio[page]

    def select_victim(self, resident, tenant: Optional[int] = None) -> int:
        key = tenant if self._tenant_of else None
        heap = self.heaps[key]
        while True:
            pr, page = heap[0]
            if self.prio.get(page) != pr:
                heapq.heappop(heap)          # evicted or re-drawn: stale
                continue
            return page


class HotColdEviction(EvictionPolicy):
    """Access-frequency (cold-first) replacement per arXiv 2204.02974.

    ``freq[page]`` counts touches since the page migrated (0 at insert:
    prefetched-but-unused pages are the coldest); the victim minimizes
    ``(freq, stamp)`` — stamps are the shared monotone touch counter, so
    frequency ties resolve least-recently-used.  Lazy min-heap: keys only
    grow while resident, so stale entries re-push and self-heal.
    """

    name = "hotcold"

    def reset(self) -> None:
        self.counter = 0
        self.freq: Dict[int, int] = {}
        self.stamp: Dict[int, int] = {}
        self.heaps: Dict[Optional[int],
                         List[Tuple[int, int, int]]] = {None: []}

    def _heap(self, page: int) -> List[Tuple[int, int, int]]:
        key = self._tenant_of(page) if self._tenant_of else None
        return self.heaps.setdefault(key, [])

    def on_insert(self, page: int) -> None:
        if page in self.stamp:
            return
        self.freq[page] = 0
        self.stamp[page] = self.counter
        heapq.heappush(self._heap(page), (0, self.counter, page))
        self.counter += 1

    def on_touch(self, page: int) -> None:
        if page in self.stamp:
            self.freq[page] += 1
            self.stamp[page] = self.counter
        self.counter += 1

    def on_evict(self, page: int) -> None:
        del self.freq[page]
        del self.stamp[page]

    def select_victim(self, resident, tenant: Optional[int] = None) -> int:
        key = tenant if self._tenant_of else None
        heap = self.heaps[key]
        while True:
            f, s, page = heap[0]
            cur = self.stamp.get(page)
            if cur is None:                  # evicted: drop the entry
                heapq.heappop(heap)
                continue
            if (self.freq[page], cur) != (f, s):
                heapq.heapreplace(heap, (self.freq[page], cur, page))
                continue
            return page


def make_eviction_policy(name: str) -> EvictionPolicy:
    validate_policy(name)
    policy = {"lru": LRUEviction, "random": RandomEviction,
              "hotcold": HotColdEviction}[name]()
    policy.reset()
    return policy
