"""Simulator configuration — constants from the paper's Table 9."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class UVMConfig:
    """GPGPU-Sim UVMSmart configuration (paper Table 9), GTX 1080 Ti-like."""

    core_mhz: float = 1481.0
    n_sms: int = 28
    page_size: int = 4096

    # latencies (GPU core cycles unless noted)
    page_table_walk_cycles: int = 100
    dram_cycles: int = 100
    zero_copy_cycles: int = 200
    pcie_latency_cycles: int = 100
    far_fault_us: float = 45.0            # host-side fault service

    # PCI-e 3.0 x16: 8 GT/s per lane per direction, 128b/130b -> ~15.75 GB/s
    pcie_gb_s: float = 15.75

    # device memory capacity in pages; None = never oversubscribed
    device_pages: int | None = None

    # per-tenant hard quotas (pages) for multi-tenant interleaved traces
    # (repro.traces.interleave): a (q0, q1) tuple partitions device_pages
    # into per-tenant capacity, with device_pages - q0 - q1 left as a
    # shared spill pool either tenant may borrow while the other is under
    # its quota.  None (default) = shared capacity: tenants contend for
    # the whole device exactly like the single-tenant model.  Requires
    # device_pages and a multi-tenant trace; see repro.uvm.eviction
    # .resolve_tenancy for validation and the spill arithmetic.
    tenant_pages: tuple | None = None

    # eviction policy under oversubscription: "lru" (default, the
    # historical behavior), "random" (counter-based deterministic PRNG
    # replacement), or "hotcold" (access-frequency cold-first, arXiv
    # 2204.02974).  See repro.uvm.eviction.
    eviction: str = "lru"

    # far-fault MSHR entries: outstanding faults the GPU can hide behind
    # fine-grained multithreading before the SMs fully stall
    mshr_entries: int = 64

    # aggregate instruction issue throughput (inst / core cycle) used for the
    # IPC proxy.  28 SMs x 128 cores, but memory-intensive kernels sustain a
    # small fraction of peak; this constant cancels in normalized IPC.
    issue_ipc: float = 512.0

    # fixed cost per coalesced GMMU request beyond walk+DRAM (queueing,
    # multi-warp round trips).  Calibrated so the GMMU request rate is a
    # few/us — fast enough that bulk-DMA prefetch batches (the tree
    # prefetcher's granularity) are frequently still in flight when their
    # pages are demanded, and that a 1 us-per-prediction model keeps up
    # with most requests while a 10 us one cannot (paper Fig 10).
    access_overhead_cycles: float = 1200.0

    # driver-initiated prefetch overhead (scheduling a migration without a
    # GPU fault: no 45us fault service, just runtime work + doorbell)
    prefetch_overhead_cycles: float = 600.0

    # learned-predictor inference overhead per prediction, microseconds
    prediction_overhead_us: float = 1.0

    @property
    def cycles_per_us(self) -> float:
        return self.core_mhz  # 1481 MHz -> 1481 cycles / us

    def us_from_cycles(self, cycles):
        """GPU core cycles -> microseconds (scalar or ndarray) — the
        conversion behind the serving SLO latency columns
        (``repro.offload.serve_trace.serve_latency_columns``)."""
        return cycles / self.cycles_per_us

    @property
    def far_fault_cycles(self) -> float:
        return self.far_fault_us * self.cycles_per_us

    @property
    def pcie_bytes_per_cycle(self) -> float:
        return self.pcie_gb_s * 1e9 / (self.core_mhz * 1e6)

    @property
    def page_transfer_cycles(self) -> float:
        return self.page_size / self.pcie_bytes_per_cycle

    @property
    def prediction_overhead_cycles(self) -> float:
        return self.prediction_overhead_us * self.cycles_per_us
