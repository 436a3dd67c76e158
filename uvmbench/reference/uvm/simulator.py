"""Page-granular UVM simulator.

Queue-based timing model in GPU core cycles:

* the GPU issues coalesced GMMU requests at a fixed instruction throughput;
* a far-fault pays host page-walk + fault service latency (45 us) and then
  queues its page migration on the PCIe channel (bandwidth + latency);
* prefetched pages ride the bus behind the demand page;
* the GPU hides up to ``mshr_entries`` outstanding faults behind fine-grained
  multithreading — beyond that the clock stalls to the oldest completion
  (this is what serializes clustered faults when the bus is saturated, the
  BICG effect in the paper's Fig 11);
* accesses to in-flight pages (late prefetches / duplicate faults) stall the
  warp until the page arrives;
* under oversubscription, pages are evicted (with writeback traffic) by a
  pluggable policy — LRU by default, counter-based random or
  access-frequency hot/cold via ``UVMConfig.eviction``
  (see ``repro.uvm.eviction``).

IPC is instructions / modeled cycles.  Absolute IPC is a proxy, but all
paper-facing results are *normalized* (ours vs UVMSmart), which cancels the
issue-throughput constant.

The benchmark's frozen copy of the port's legacy engine
(``repro_torch.uvm.simulator``), with two departures that keep its results
and make it usable as the benchmark's reference and control:

* ``clock_dtype``: every value of the clock chain (the clock, the bus, each
  arrival, the PCIe byte count) is rounded to this type after each
  operation.  ``float`` (IEEE double) is the engine as it was; ``np.float32``
  is the lower-precision control that the comparison must reject.
* under hard quotas the LRU victim of a tenant is read from a per-tenant
  copy of the residency order instead of a scan of the whole order: the
  same page (the first of that tenant in LRU order), found in O(1).
"""
from __future__ import annotations

import dataclasses
import heapq
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

from uvmbench.reference.traces.trace import Trace
from uvmbench.reference.uvm.config import UVMConfig
from uvmbench.reference.uvm.eviction import make_eviction_policy, resolve_tenancy
from uvmbench.reference.uvm.prefetchers import Prefetcher


@dataclasses.dataclass
class UVMStats:
    name: str
    prefetcher: str
    n_accesses: int
    n_instructions: int
    cycles: float
    hits: int
    late: int              # demanded while in-flight (late prefetch)
    faults: int            # demand far-faults
    prefetch_issued: int
    prefetch_used: int
    pages_migrated: int
    pages_evicted: int
    pcie_bytes: float
    zero_copy_bytes: float
    timeline: Optional[np.ndarray] = None   # (cycle, bytes) per transfer
    #: replay backend that actually produced these stats ("legacy" /
    #: "numpy" / "pallas"); set by the backend layer so sweep rows can
    #: surface silent fallbacks.  None when a simulator was run directly.
    backend: Optional[str] = None
    #: eviction policy the replay ran under (``UVMConfig.eviction``);
    #: surfaced in sweep result rows alongside ``backend``.
    eviction: str = "lru"
    #: replay clock after the last access of each requested step window
    #: (``ReplayRequest.step_bounds`` / ``UVMSimulator.run(step_bounds=)``);
    #: None unless bounds were requested.  Serving traces use this for
    #: per-decode-step latency and TTFT percentiles
    #: (``repro.offload.serve_trace``).
    step_clocks: Optional[np.ndarray] = None
    #: per-tenant (hits, accesses) on multi-tenant interleaved traces
    #: (``repro.traces.interleave``); None on single-tenant replays.  The
    #: sweep's per-tenant hit-rate columns derive from these.
    tenant_hits: Optional[Tuple[int, int]] = None
    tenant_accesses: Optional[Tuple[int, int]] = None

    @property
    def ipc(self) -> float:
        return self.n_instructions / max(self.cycles, 1.0)

    @property
    def hit_rate(self) -> float:
        return self.hits / max(self.n_accesses, 1)

    @property
    def accuracy(self) -> float:
        """Fraction of prefetched pages that were used before eviction."""
        if self.prefetch_issued == 0:
            return 1.0
        return self.prefetch_used / self.prefetch_issued

    @property
    def coverage(self) -> float:
        """Fraction of would-be misses mitigated by prefetching."""
        would_be = self.prefetch_used + self.faults + self.late
        if would_be == 0:
            return 1.0
        return self.prefetch_used / would_be

    @property
    def unity(self) -> float:
        return float(np.cbrt(self.accuracy * self.coverage * self.hit_rate))


class UVMSimulator:
    def __init__(self, config: UVMConfig | None = None,
                 record_timeline: bool = False, clock_dtype=float) -> None:
        self.config = config or UVMConfig()
        self.record_timeline = record_timeline
        self.clock_dtype = clock_dtype

    def run(self, trace: Trace, prefetcher: Prefetcher,
            step_bounds: Optional[np.ndarray] = None) -> UVMStats:
        """Replay one trace.  ``step_bounds`` (optional, non-decreasing
        exclusive end indices into the access stream) requests the replay
        clock after the last access of each window — recorded in
        ``UVMStats.step_clocks``.  A bound of 0 (an empty leading window)
        completes at clock 0.0; an empty middle window repeats the
        previous window's clock."""
        cfg = self.config
        F = self.clock_dtype
        # policy name validated even when memory is never oversubscribed,
        # so a typo fails fast instead of silently simulating uncapped
        policy = make_eviction_policy(cfg.eviction)
        prefetcher.reset()
        pages = trace.pages
        n = len(pages)
        # Every trace record is a TLB-missed coalesced request: it pays a GMMU
        # page-table walk plus a DRAM access, and amortizes the kernel's
        # arithmetic.  This per-access cost sets the prefetch lead-time scale
        # (prediction distance d buys ~d * cycles_per_access of slack).
        cycles_per_access = F(cfg.page_table_walk_cycles + cfg.dram_cycles
                              + cfg.access_overhead_cycles
                              + (trace.n_instructions / max(n, 1))
                              / cfg.issue_ipc)

        # page -> arrival cycle (usable when clock >= arrival). OrderedDict
        # doubles as the LRU (move_to_end on touch).
        resident: "OrderedDict[int, float]" = OrderedDict()
        prefetched_unused: Dict[int, bool] = {}

        clock = F(0.0)
        pcie_free = F(0.0)
        outstanding: List[float] = []   # min-heap of unresolved stall points

        hits = late = faults = 0
        prefetch_issued = prefetch_used = 0
        pages_migrated = pages_evicted = 0
        pcie_bytes = F(0.0)
        zero_copy_bytes = 0.0
        timeline: List[Tuple[float, float]] = []

        page_tx = F(cfg.page_transfer_cycles)
        ff = F(cfg.far_fault_cycles)
        walk = F(cfg.page_table_walk_cycles)
        pcie_lat = F(cfg.pcie_latency_cycles)
        pf_over = F(cfg.prefetch_overhead_cycles)
        page_bytes = F(cfg.page_size)
        cap = cfg.device_pages
        track = cap is not None      # policy callbacks only matter capped

        # multi-tenant traces: per-tenant hit counters always; per-tenant
        # residency counters + tenant-masked victim selection only when
        # hard quotas split the capacity (see repro.uvm.eviction.Tenancy)
        tenancy = resolve_tenancy(trace, cfg)
        split = track and tenancy is not None and tenancy.split
        if split:
            policy.bind_tenancy(tenancy.tenant_of)
        rc = [0, 0]                  # per-tenant resident page counts
        th = [0, 0]                  # per-tenant hits
        # masked LRU: each tenant's resident pages in the global LRU order
        tres = ([OrderedDict(), OrderedDict()]
                if split and cfg.eviction == "lru" else None)

        if step_bounds is not None:
            sb = np.asarray(step_bounds, dtype=np.int64)
            if sb.size and (np.any(np.diff(sb) < 0) or sb[-1] > n):
                raise ValueError("step_bounds must be non-decreasing "
                                 "end indices <= n_accesses")
            step_clocks = np.zeros(sb.size, dtype=np.float64)
        else:
            sb = None
            step_clocks = None
        sp = 0
        while sb is not None and sp < sb.size and sb[sp] == 0:
            sp += 1                  # leading empty windows end at clock 0.0

        def schedule_prefetch(extras, batch: bool) -> None:
            nonlocal pcie_free, pages_migrated, pcie_bytes, prefetch_issued
            # Prefetches are driver-initiated: they skip the 45us fault
            # service and only pay runtime overhead (+ model inference
            # latency for the learned prefetcher), then queue on the bus.
            # ``batch=True`` models the driver's block/chunk DMA granularity:
            # the whole group transfers as one DMA and every page in it
            # becomes usable only at *batch completion* — this is the tree
            # prefetcher's timeliness weakness.  Single-page learned
            # prefetches (batch=False) complete page by page.
            ex_ready = F(F(clock + pf_over)
                         + F(prefetcher.extra_latency_cycles))
            ex_start = max(pcie_free, ex_ready)
            end = F(ex_start + F(len(extras) * page_tx))
            t = ex_start
            for q in extras:
                t = F(t + page_tx)
                ex_arr = F((end if batch else t) + pcie_lat)
                if split and q not in resident:
                    rc[tenancy.tenant_of(q)] += 1
                resident[q] = ex_arr
                if tres is not None:
                    tres[tenancy.tenant_of(q)][q] = ex_arr
                if track:
                    policy.on_insert(q)
                prefetched_unused[q] = True
                pages_migrated += 1
                pcie_bytes = F(pcie_bytes + page_bytes)
                if self.record_timeline:
                    timeline.append((ex_arr, float(cfg.page_size)))
            pcie_free = end
            prefetch_issued += len(extras)
            prefetcher.on_migrate(list(extras))

        for i in range(n):
            p = int(pages[i])
            clock = F(clock + cycles_per_access)
            arr = resident.get(p)
            if arr is not None:
                if arr <= clock:
                    hits += 1
                    if tenancy is not None:
                        th[tenancy.tenant_of(p)] += 1
                    if prefetched_unused.pop(p, None):
                        prefetch_used += 1
                else:
                    # demanded while in flight: warp stalls till arrival
                    late += 1
                    heapq.heappush(outstanding, arr)
                    if prefetched_unused.pop(p, None):
                        prefetch_used += 1
                resident.move_to_end(p)
                if tres is not None:
                    tres[tenancy.tenant_of(p)].move_to_end(p)
                if track:
                    policy.on_touch(p)
            else:
                # ---- far fault ----
                # The driver services the GPU fault buffer in batched rounds
                # of ~one fault-service latency: a fault raised during round
                # k is resolved at the end of round k+1 (uniform 1-2x 45us).
                # Driver-initiated prefetches skip this path entirely —
                # that asymmetry is what the paper's prefetcher exploits.
                faults += 1
                ready = F(F(F(F(clock // ff) + F(2.0)) * ff) + walk)
                start = max(ready, pcie_free)
                arrival = F(F(start + pcie_lat) + page_tx)
                pcie_free = F(start + page_tx)
                if split:
                    rc[tenancy.tenant_of(p)] += 1
                resident[p] = arrival
                resident.move_to_end(p)
                if tres is not None:
                    own = tres[tenancy.tenant_of(p)]
                    own[p] = arrival
                    own.move_to_end(p)
                if track:
                    policy.on_insert(p)
                pages_migrated += 1
                pcie_bytes = F(pcie_bytes + page_bytes)
                if self.record_timeline:
                    timeline.append((arrival, float(cfg.page_size)))
                heapq.heappush(outstanding, arrival)
                prefetcher.on_migrate([p])

                extras = prefetcher.on_fault(i, p, resident)
                if extras:
                    schedule_prefetch(extras, batch=True)

            # continuous (per-request) prefetching — the learned predictor
            # sits at the UVM backend and predicts on every read-request.
            extras = prefetcher.on_access(i, p, resident, clock)
            if extras:
                schedule_prefetch(extras, batch=False)

            # MSHR pressure: too many outstanding faults -> stall to oldest
            while len(outstanding) > cfg.mshr_entries:
                clock = max(clock, heapq.heappop(outstanding))

            # eviction under oversubscription: the policy picks victims
            # (LRU = first key of the order-maintained dict, exactly the
            # historical popitem(last=False))
            if track:
                while True:
                    if split:
                        # per-tenant quotas: trim whichever tenant is over
                        # its allowance (tenant 0 first — the vectorized
                        # engines and the pallas kernel use the same
                        # order), victim masked to that tenant's pages
                        a0, a1 = tenancy.allowed(rc[0], rc[1])
                        if rc[0] > a0:
                            u: Optional[int] = 0
                        elif rc[1] > a1:
                            u = 1
                        else:
                            break
                    else:
                        if len(resident) <= cap:
                            break
                        u = None
                    if tres is not None:
                        victim = next(iter(tres[u]))
                    else:
                        victim = policy.select_victim(resident, u)
                    v_arr = resident[victim]
                    if v_arr > clock:
                        # never evict in-flight pages; retouch at MRU
                        resident.move_to_end(victim)
                        if tres is not None:
                            tres[u].move_to_end(victim)
                        policy.on_touch(victim)
                        break
                    del resident[victim]
                    if tres is not None:
                        del tres[u][victim]
                    if split:
                        rc[u] -= 1
                    policy.on_evict(victim)
                    prefetched_unused.pop(victim, None)
                    prefetcher.on_evict(victim)
                    pages_evicted += 1
                    # writeback traffic (assume half the evictions dirty)
                    if pages_evicted % 2 == 0:
                        pcie_bytes = F(pcie_bytes + page_bytes)
                        pcie_free = F(pcie_free + page_tx)

            # step-window clocks: the iteration for access i completes
            # windows whose exclusive end is i+1 (duplicates = empty windows)
            if sb is not None:
                while sp < sb.size and sb[sp] <= i + 1:
                    step_clocks[sp] = clock
                    sp += 1

        # drain: all outstanding stalls resolve
        while outstanding:
            clock = max(clock, heapq.heappop(outstanding))

        return UVMStats(
            name=trace.name,
            prefetcher=prefetcher.name,
            n_accesses=n,
            n_instructions=trace.n_instructions,
            cycles=float(clock),
            hits=hits,
            late=late,
            faults=faults,
            prefetch_issued=prefetch_issued,
            prefetch_used=prefetch_used,
            pages_migrated=pages_migrated,
            pages_evicted=pages_evicted,
            pcie_bytes=float(pcie_bytes),
            zero_copy_bytes=zero_copy_bytes,
            timeline=np.asarray(timeline) if self.record_timeline else None,
            eviction=cfg.eviction,
            step_clocks=step_clocks,
            tenant_hits=(th[0], th[1]) if tenancy is not None else None,
            tenant_accesses=_tenant_accesses(pages, tenancy),
        )


def _tenant_accesses(pages: np.ndarray,
                     tenancy) -> Optional[Tuple[int, int]]:
    """Host-side per-tenant access counts (every backend derives these
    the same way — the counts are a property of the trace slice, not of
    the replay)."""
    if tenancy is None:
        return None
    n1 = int(np.count_nonzero(np.asarray(pages) >= tenancy.boundary))
    return int(len(pages)) - n1, n1
