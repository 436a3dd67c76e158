"""Golden-equivalence matrix of the UVM engines -- the port's copy of the
reference ``repro.uvm.golden``.

The same small, fully deterministic (trace x prefetcher x config) matrix,
built from the port's own trace generators and prefetchers, so that the
card-side checks (``tests/test_torch_cuda.py``, ``chip_smoke.py``) can hold
kernel K1 against ``tests/golden/uvm_golden.json`` where the JAX package is
not installed.  ``learned-cached`` and ``learned-tf`` round-trip their
predictions through the port's prediction cache
(``repro_torch.uvm.predcache``), as the reference does through its own.

The matrix: ATAX and Pathfinder at scale 0.25, a BICG-style clustered-fault
storm under MSHR pressure, an oversubscribed cyclic sweep, a tree-churn
case, the per-policy oversubscribed cells (random and hotcold), and the
multi-tenant ATAX+Pathfinder interleave under shared capacity and under
hard quotas; each against the seven prefetcher variants.
"""
from __future__ import annotations

import atexit
import dataclasses
import functools
import shutil
import tempfile
from typing import Callable, Dict, Iterator, List, Tuple

import numpy as np

from repro_torch.traces.trace import ROOT_PAGES, Trace, make_records
from repro_torch.uvm.config import UVMConfig
from repro_torch.uvm.prefetchers import (BlockPrefetcher, LearnedPrefetcher,
                                   NoPrefetcher, OraclePrefetcher, Prefetcher,
                                   TreePrefetcher)
from repro_torch.uvm.simulator import UVMStats

#: integer counters that must match the legacy engine exactly
INT_FIELDS = ("n_accesses", "n_instructions", "hits", "late", "faults",
              "prefetch_issued", "prefetch_used", "pages_migrated",
              "pages_evicted")
#: float accumulators (bit-equal in practice; compared to tight rel. tol.)
FLOAT_FIELDS = ("cycles", "pcie_bytes", "zero_copy_bytes")

PREFETCHER_NAMES = ("none", "block", "tree", "learned", "learned-cached",
                    "learned-tf", "oracle")

#: prediction distance / inference overhead of the synthetic learned model
LEARNED_DISTANCE = 32
LEARNED_OVERHEAD_US = 1.0

#: the learned-tf cells model the reference-Transformer family: a
#: *different* prediction distance (so their predictions measurably
#: differ from the simplified cells') round-tripped through predcache
#: under ``model_family="transformer"`` — the fixtures then pin the
#: family-keyed cache path: a key collision would cross-serve
#: distance-32 predictions into these cells and fail every backend
LEARNED_TF_DISTANCE = 16


@dataclasses.dataclass(frozen=True)
class GoldenCase:
    name: str
    trace: Trace
    config: UVMConfig


def _mk_trace(name: str, pages: np.ndarray, inst_per_access: int = 100) -> Trace:
    recs = make_records(len(pages))
    recs["page"] = pages
    recs["sm"] = np.arange(len(pages)) % 4
    return Trace(name, recs, {}, {}, len(pages) * inst_per_access)


@functools.lru_cache(maxsize=1)
def golden_cases() -> Tuple[GoldenCase, ...]:
    from repro_torch.traces import GPUModel, generate_benchmark

    atax = GPUModel().run(generate_benchmark("ATAX", scale=0.25))
    pathfinder = GPUModel().run(generate_benchmark("Pathfinder", scale=0.25))

    # BICG-style clustered faults: bursts of new pages a large stride apart,
    # replayed under a tight MSHR so the fault storms serialize (Fig 11).
    bicg = np.concatenate([np.arange(k, k + 50, dtype=np.int64)
                           for k in range(0, 12000, 200)])

    # Oversubscribed cyclic sweep: the working set is ~1.7x device memory,
    # so LRU eviction churns continuously (including in-flight victims).
    oversub = np.tile(np.arange(2500, dtype=np.int64), 6)

    # Tree churn under oversubscription: two far-apart 3-chunk regions are
    # swept alternately in a stride-7 permuted order (blocks fill out of
    # sequence, so >50% escalations fire at varied points), with capacity
    # for only ~2/3 of the union — chunks migrate, evict, and re-migrate,
    # driving tree node counts up and down for the whole replay.
    n_churn = 3 * ROOT_PAGES
    perm = (np.arange(n_churn, dtype=np.int64) * 7) % n_churn
    churn = np.concatenate([perm + (0 if k % 2 == 0 else 8192)
                            for k in range(8)])

    # Per-policy oversubscribed regimes (smaller traces — every cell also
    # replays through the lane kernel): a thrashing
    # cyclic sweep at ~1.8x capacity, and a permuted two-region sweep
    # whose blocks migrate/evict/re-migrate continuously, so random
    # priority draws and hot/cold frequency ranks churn the whole replay.
    pol_oversub = np.tile(np.arange(2000, dtype=np.int64), 4)
    n_pol = 2 * ROOT_PAGES
    pol_perm = (np.arange(n_pol, dtype=np.int64) * 5) % n_pol
    pol_churn = np.concatenate([pol_perm + (0 if k % 2 == 0 else 4096)
                                for k in range(6)])

    # Multi-tenant interleave: ATAX and Pathfinder zipped into one stream
    # with disjoint page regions, replayed at ~0.6x the union working set
    # so both tenants feel eviction pressure — once contending for the
    # whole device (mt-shared) and once under hard 40%/40% quotas with a
    # 20% spill pool and tenant-masked hotcold victim selection (mt-quota)
    from repro_torch.traces.interleave import build_mt_trace
    mt = build_mt_trace("ATAX+Pathfinder", scale=0.25)
    mt_cap = int(0.6 * mt.working_set_pages)

    return (
        GoldenCase("atax", atax, UVMConfig()),
        GoldenCase("pathfinder", pathfinder, UVMConfig()),
        GoldenCase("bicg-cluster", _mk_trace("bicg-cluster", bicg),
                   UVMConfig(mshr_entries=16)),
        GoldenCase("oversub", _mk_trace("oversub", oversub),
                   UVMConfig(device_pages=1500)),
        GoldenCase("tree-churn", _mk_trace("tree-churn", churn),
                   UVMConfig(device_pages=2048)),
        GoldenCase("oversub-random", _mk_trace("oversub-random", pol_oversub),
                   UVMConfig(device_pages=1100, eviction="random")),
        GoldenCase("oversub-hotcold",
                   _mk_trace("oversub-hotcold", pol_oversub),
                   UVMConfig(device_pages=1100, eviction="hotcold")),
        GoldenCase("churn-random", _mk_trace("churn-random", pol_churn),
                   UVMConfig(device_pages=700, eviction="random",
                             mshr_entries=16)),
        GoldenCase("churn-hotcold", _mk_trace("churn-hotcold", pol_churn),
                   UVMConfig(device_pages=700, eviction="hotcold",
                             mshr_entries=16)),
        GoldenCase("mt-shared", mt, UVMConfig(device_pages=mt_cap)),
        GoldenCase("mt-quota", mt,
                   UVMConfig(device_pages=mt_cap,
                             tenant_pages=(int(0.4 * mt_cap),
                                           int(0.4 * mt_cap)),
                             eviction="hotcold")),
    )


def perfect_preds(trace: Trace, distance: int = LEARNED_DISTANCE) -> np.ndarray:
    """Deterministic stand-in for the trained model: perfect distance-k
    predictions (exercises the LearnedPrefetcher pipeline without a
    trained model)."""
    pages = np.asarray(trace.pages, dtype=np.int64)
    preds = np.full(len(pages), -1, dtype=np.int64)
    if len(pages) > distance:
        preds[:-distance] = pages[distance:]
    return preds


@functools.lru_cache(maxsize=1)
def _roundtrip_cache_dir() -> str:
    """Process-lifetime scratch dir for the learned-cached golden cells
    (removed at interpreter exit so repeated runs don't litter /tmp)."""
    path = tempfile.mkdtemp(prefix="uvm_golden_predcache_")
    atexit.register(shutil.rmtree, path, ignore_errors=True)
    return path


def make_prefetcher(name: str, trace: Trace, config: UVMConfig) -> Prefetcher:
    if name == "none":
        return NoPrefetcher()
    if name == "block":
        return BlockPrefetcher()
    if name == "tree":
        return TreePrefetcher()
    if name == "learned":
        return LearnedPrefetcher(
            perfect_preds(trace),
            extra_latency_cycles=LEARNED_OVERHEAD_US * config.cycles_per_us)
    if name in ("learned-cached", "learned-tf"):
        # same predictions as "learned" (learned-cached) or the
        # Transformer-family stand-in at a different prediction distance
        # (learned-tf), round-tripped through the prediction cache's
        # atomic npz store — the fixtures pin the cache path to replay
        # bit-identically to the direct array, and the two names differ
        # *only* by model_family in their keys, so a family-blind key
        # would cross-serve the wrong distance and fail every backend
        from repro_torch.uvm import predcache
        family = "transformer" if name == "learned-tf" else "simplified"
        distance = (LEARNED_TF_DISTANCE if name == "learned-tf"
                    else LEARNED_DISTANCE)
        key = predcache.predictions_key(trace, kind="golden-roundtrip",
                                        model_family=family)
        cache_dir = _roundtrip_cache_dir()
        preds = predcache.load(cache_dir, key)
        if preds is None:
            predcache.store(cache_dir, key, perfect_preds(trace, distance))
            preds = predcache.load(cache_dir, key)
        return LearnedPrefetcher(
            preds,
            extra_latency_cycles=LEARNED_OVERHEAD_US * config.cycles_per_us)
    if name == "oracle":
        return OraclePrefetcher(np.asarray(trace.pages))
    raise ValueError(f"unknown prefetcher {name!r}")


def golden_cell_ids() -> List[str]:
    return [f"{case.name}/{pf}" for case in golden_cases()
            for pf in PREFETCHER_NAMES]


def golden_cell(cell_id: str) -> Tuple[Trace, UVMConfig, Callable[[], Prefetcher]]:
    case_name, pf_name = cell_id.split("/")
    case = next(c for c in golden_cases() if c.name == case_name)
    return (case.trace, case.config,
            lambda: make_prefetcher(pf_name, case.trace, case.config))


def golden_cell_policy(cell_id: str) -> str:
    """Eviction policy of one golden cell's config (lane batches are
    policy-homogeneous, so a lane harness groups by it)."""
    case_name = cell_id.split("/")[0]
    case = next(c for c in golden_cases() if c.name == case_name)
    return case.config.eviction


def stats_to_dict(stats: UVMStats) -> Dict:
    out = {f: int(getattr(stats, f)) for f in INT_FIELDS}
    out.update({f: float(getattr(stats, f)) for f in FLOAT_FIELDS})
    if stats.tenant_hits is not None:
        # multi-tenant cells pin the per-tenant accounting too
        out["tenant_hits"] = [int(x) for x in stats.tenant_hits]
        out["tenant_accesses"] = [int(x) for x in stats.tenant_accesses]
    return out


def iter_golden_cells() -> Iterator[Tuple[str, Trace, UVMConfig,
                                          Callable[[], Prefetcher]]]:
    for cell_id in golden_cell_ids():
        trace, config, factory = golden_cell(cell_id)
        yield cell_id, trace, config, factory
