"""Batched UVM sweep on the port: (trace × prefetcher × config) grids
replayed as multi-lane K1 batches.

A slim port of the reference ``repro.uvm.sweep``: the same cells, grid
expansion, trace windows, learned-predictor training through the prediction
cache, lane batching, and result rows with the SWEEP_VERSION 9 columns.
The port accepts all five prefetchers (``none``, ``block``, ``tree``,
``learned``, ``oracle``) on the benchmark traces under the ``lru``,
``random`` and ``hotcold`` eviction policies, and the named scenarios of
``repro_torch.uvm.scenarios``; it raises on anything else.  The reference's
lease pool, resume, serve, multi-tenant and adaptive paths are later
slices.

Programmatic use::

    from repro_torch.uvm.sweep import expand_grid, run_sweep
    cells = expand_grid(["ATAX", "BICG"], ["none", "learned"],
                        device_fracs=[None, 0.5])
    rows = run_sweep(cells, out_dir="results/", device="cuda")

CLI::

    PYTHONPATH=src python -m repro_torch.uvm.sweep --benches ATAX,BICG \\
        --prefetchers none,tree,learned --device-fracs 0.5 --out results/
    PYTHONPATH=src python -m repro_torch.uvm.sweep --scenario oversub-full \\
        --out results/oversub
"""
from __future__ import annotations

import argparse
import csv
import dataclasses
import functools
import hashlib
import json
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.families import MODEL_FAMILIES
from repro_torch.traces.trace import Trace
from repro_torch.uvm.config import UVMConfig
from repro_torch.uvm.eviction import EVICTION_POLICIES
from repro_torch.uvm.prefetchers import (BlockPrefetcher, LearnedPrefetcher,
                                         NoPrefetcher, OraclePrefetcher,
                                         Prefetcher, TreePrefetcher)
from repro_torch.uvm.replay_core import ReplayRequest, get_backend
from repro_torch.uvm.simulator import UVMStats

#: cell-spec prefetcher names to concrete types, in the reference's order
_PREFETCHER_TYPES = {"none": NoPrefetcher, "block": BlockPrefetcher,
                     "tree": TreePrefetcher, "learned": LearnedPrefetcher,
                     "oracle": OraclePrefetcher}
PREFETCHERS = tuple(_PREFETCHER_TYPES)
#: eviction policies the port replays (the ``adaptive`` pseudo-policy is a
#: later slice)
EVICTIONS = EVICTION_POLICIES

#: the reference's row-schema version: rows carry its columns, so port rows
#: and reference rows of the same cells can be compared column by column
SWEEP_VERSION = 9

SERVE_LATENCY_FIELDS = (
    "decode_lat_p50_us", "decode_lat_p95_us", "decode_lat_p99_us",
    "ttft_p50_us", "ttft_p95_us", "ttft_p99_us",
)
MT_FIELDS = (
    "tenants", "capacity_split", "hit_rate_t0", "hit_rate_t1",
    "slowdown_t0", "slowdown_t1", "interference_slowdown",
)
ROW_FIELDS = [
    "bench", "prefetcher", "scale", "seed", "window", "prediction_us",
    "device_pages", "device_frac", "eviction", "model_family", "scenario",
    "engine", "backend", "n_accesses", "n_instructions",
    "cycles", "ipc", "hits", "late", "faults", "hit_rate", "prefetch_issued",
    "prefetch_used", "accuracy", "coverage", "unity", "pages_migrated",
    "pages_evicted", "pcie_bytes", *SERVE_LATENCY_FIELDS, "slo_source",
    *MT_FIELDS, "retries", "quarantined", "seconds",
]


@dataclasses.dataclass(frozen=True)
class SweepCell:
    """One point of a sweep grid (the reference's fields)."""

    bench: str
    prefetcher: str
    scale: float = 1.0
    seed: int = 0
    window: Optional[float] = 0.6       # leading trace fraction (paper eval)
    prediction_us: float = 1.0          # learned-model inference overhead
    device_pages: Optional[int] = None  # absolute capacity, or ...
    device_frac: Optional[float] = None  # ... fraction of the working set
    eviction: str = "lru"
    capacity_split: Optional[str] = None
    scenario: Optional[str] = None
    engine: str = "auto"
    backend: str = "cuda"
    service_steps: int = 150            # learned-predictor training steps
    model_family: str = "simplified"

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    def key(self) -> str:
        blob = json.dumps({"_v": SWEEP_VERSION, **self.to_dict()},
                          sort_keys=True)
        return hashlib.sha256(blob.encode()).hexdigest()[:16]


def parse_capacity_split(split: Optional[str]
                         ) -> Optional[Tuple[float, float]]:
    """Validate/parse a ``capacity_split`` spec (the reference's parser):
    ``None`` or ``"shared"`` -> None; ``"f0/f1"`` -> the two per-tenant
    quota fractions of ``device_pages`` (``f0 + f1 <= 1``)."""
    if split is None or split == "shared":
        return None
    try:
        f0, f1 = (float(x) for x in str(split).split("/"))
    except ValueError:
        raise ValueError(
            f"bad capacity_split {split!r}: expected 'shared' or two "
            "quota fractions like '0.5/0.5'") from None
    if f0 < 0 or f1 < 0 or f0 + f1 > 1.0 + 1e-9:
        raise ValueError(
            f"bad capacity_split {split!r}: fractions must be "
            "non-negative and sum to at most 1")
    return f0, f1


def check_cell(cell: SweepCell) -> None:
    """Raise on a cell the port cannot run yet, naming the later slice."""
    from repro_torch.traces.generators import BENCHMARKS
    from repro_torch.traces.interleave import is_mt_bench
    from repro_torch.uvm.scenarios import ADAPTIVE_POLICY, is_serve_bench
    later = None
    if is_serve_bench(cell.bench):
        later = (f"serve bench {cell.bench!r}: serve scenarios with step "
                 "clocks are a later slice of the port")
    elif is_mt_bench(cell.bench):
        later = (f"multi-tenant bench {cell.bench!r}: mt quotas and the "
                 "per-tenant rows are a later slice of the port")
    elif cell.capacity_split is not None:
        later = (f"capacity splits ({cell.capacity_split!r}) are a later "
                 "slice of the port (the mt scenarios)")
    elif cell.bench not in BENCHMARKS:
        later = (f"unknown bench {cell.bench!r}; the port runs "
                 f"{','.join(sorted(BENCHMARKS))}")
    elif cell.eviction == ADAPTIVE_POLICY:
        later = (f"eviction {cell.eviction!r}: the adaptive policy is a "
                 "later slice of the port")
    elif cell.prefetcher not in PREFETCHERS:
        later = (f"unknown prefetcher {cell.prefetcher!r}; choose from "
                 f"{','.join(PREFETCHERS)}")
    elif cell.eviction not in EVICTIONS:
        later = (f"unknown eviction {cell.eviction!r}; choose from "
                 f"{','.join(EVICTIONS)}")
    elif cell.model_family not in MODEL_FAMILIES:
        later = f"unknown model family {cell.model_family!r}"
    elif cell.backend != "cuda":
        later = f"backend {cell.backend!r}: the port's only backend is cuda"
    if later is not None:
        raise ValueError(f"cell {cell.bench}/{cell.prefetcher}: {later}")


def expand_grid(benches: Sequence[str], prefetchers: Sequence[str], *,
                scales: Sequence[float] = (1.0,),
                seeds: Sequence[int] = (0,),
                windows: Sequence[Optional[float]] = (0.6,),
                prediction_us: Sequence[float] = (1.0,),
                device_fracs: Sequence[Optional[float]] = (None,),
                evictions: Sequence[str] = ("lru",),
                service_steps: int = 150) -> List[SweepCell]:
    """Cartesian product of the sweep axes, in the reference's order."""
    return [SweepCell(bench=bench, prefetcher=pf, scale=scale, seed=seed,
                      window=window, prediction_us=us, device_frac=frac,
                      eviction=ev, service_steps=service_steps)
            for bench in benches for pf in prefetchers for scale in scales
            for seed in seeds for window in windows for us in prediction_us
            for frac in device_fracs for ev in evictions]


@functools.lru_cache(maxsize=32)
def load_trace(bench: str, scale: float = 1.0, seed: int = 0,
               window: Optional[float] = 0.6) -> Trace:
    """Generate one benchmark trace and cut the leading evaluation window
    (memoized in-process; no disk cache)."""
    from repro_torch.traces import GPUModel, generate_benchmark
    from repro_torch.traces.gpu_model import GPUModelConfig
    spec = generate_benchmark(bench, scale=scale, seed=seed)
    trace = GPUModel(GPUModelConfig(seed=seed)).run(spec)
    if window is not None:
        trace, _ = trace.split(window)
    return trace


def make_prefetcher(cell: SweepCell, trace: Trace, config: UVMConfig,
                    cache_dir: Optional[str] = None, device: str = "cuda",
                    timings: Optional[Dict[str, float]] = None
                    ) -> Prefetcher:
    if cell.prefetcher == "learned":
        # train-once: one training run per (trace, model) pair, shared by
        # every prediction_us / capacity variant (repro_torch.uvm.predcache)
        from repro_torch.uvm import predcache
        pred_dir = (os.path.join(cache_dir, predcache.DEFAULT_SUBDIR)
                    if cache_dir else None)
        preds = predcache.get_or_train(
            trace, steps=cell.service_steps, cache_dir=pred_dir,
            service_kwargs={"model_family": cell.model_family},
            device=device, timings=timings)
        return LearnedPrefetcher(
            preds,
            extra_latency_cycles=cell.prediction_us * config.cycles_per_us)
    if cell.prefetcher == "oracle":
        return OraclePrefetcher(np.asarray(trace.pages))
    return _PREFETCHER_TYPES[cell.prefetcher]()


def prepare_cell(cell: SweepCell, *, cache_dir: Optional[str] = None,
                 device: str = "cuda",
                 timings: Optional[Dict[str, float]] = None):
    """One cell's (trace, config, prefetcher, device_pages)."""
    check_cell(cell)
    trace = load_trace(cell.bench, cell.scale, cell.seed, cell.window)
    device_pages = cell.device_pages
    if device_pages is None and cell.device_frac is not None:
        device_pages = int(trace.working_set_pages * cell.device_frac)
    config = UVMConfig(prediction_overhead_us=cell.prediction_us,
                       device_pages=device_pages, eviction=cell.eviction)
    prefetcher = make_prefetcher(cell, trace, config, cache_dir, device,
                                 timings)
    return trace, config, prefetcher, device_pages


def _finish_row(cell: SweepCell, stats: UVMStats,
                device_pages: Optional[int], seconds: float) -> Dict:
    row = cell.to_dict()
    row.pop("service_steps", None)
    row.update(
        device_pages=device_pages,
        backend=stats.backend,
        eviction=stats.eviction,
        n_accesses=stats.n_accesses,
        n_instructions=stats.n_instructions,
        cycles=stats.cycles,
        ipc=stats.ipc,
        hits=stats.hits,
        late=stats.late,
        faults=stats.faults,
        hit_rate=stats.hit_rate,
        prefetch_issued=stats.prefetch_issued,
        prefetch_used=stats.prefetch_used,
        accuracy=stats.accuracy,
        coverage=stats.coverage,
        unity=stats.unity,
        pages_migrated=stats.pages_migrated,
        pages_evicted=stats.pages_evicted,
        pcie_bytes=stats.pcie_bytes,
        retries=0,
        quarantined=False,
        seconds=seconds,
    )
    for f in SERVE_LATENCY_FIELDS:
        row.setdefault(f, None)
    row.setdefault("slo_source", None)
    for f in MT_FIELDS:
        row.setdefault(f, None)
    return row


def run_sweep(cells: Sequence[SweepCell], *, out_dir: Optional[str] = None,
              cache_dir: Optional[str] = None, device: str = "cuda",
              verbose: bool = False) -> List[Dict]:
    """Run a grid of cells; returns rows in the order of ``cells``.

    Cells are prepared in order (learned cells train or hit the prediction
    cache), then replayed as homogeneous K1 lane batches.  Row ``seconds``
    is the cell's share of its batch's replay time; learned rows also carry
    ``train_seconds`` and ``predict_seconds`` (0.0 where the predictions
    came from the cache)."""
    for cell in cells:
        check_cell(cell)
    if cache_dir is None and out_dir is not None:
        cache_dir = os.path.join(out_dir, "cache")
    prepared, extra = [], []
    for cell in cells:
        timings: Dict[str, float] = {}
        prepared.append(prepare_cell(cell, cache_dir=cache_dir,
                                     device=device, timings=timings))
        extra.append({"train_seconds": timings.get("train_s", 0.0),
                      "predict_seconds": timings.get("predict_s", 0.0)})
    requests = [ReplayRequest(tr, pf, cfg) for tr, cfg, pf, _ in prepared]
    backend = get_backend("cuda", device)
    rows: List[Optional[Dict]] = [None] * len(cells)
    for batch in backend.pack_lanes(requests):
        if verbose:
            print(f"[sweep] cuda lanes: replaying {len(batch)} cells in one "
                  "batch", flush=True)
        t0 = time.perf_counter()
        stats = backend.replay([requests[i] for i in batch])
        per_cell = (time.perf_counter() - t0) / len(batch)
        for i, st in zip(batch, stats):
            rows[i] = _finish_row(cells[i], st, prepared[i][3], per_cell)
            rows[i].update(extra[i])
    if out_dir:
        write_results(rows, out_dir)
    return rows


def write_results(rows: List[Dict], out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "results.json"), "w") as f:
        json.dump({"rows": rows}, f, indent=1, sort_keys=True)
        f.write("\n")
    with open(os.path.join(out_dir, "results.csv"), "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=ROW_FIELDS, extrasaction="ignore")
        w.writeheader()
        for row in rows:
            w.writerow(row)


def main(argv: Optional[List[str]] = None) -> None:
    from repro_torch.traces.generators import BENCHMARKS
    ap = argparse.ArgumentParser(
        description="Batched UVM sweep on the port (K1 lane batches)")
    ap.add_argument("--benches", default="ATAX,BICG,Pathfinder,Hotspot")
    ap.add_argument("--prefetchers", default="none,learned",
                    help=f"comma list from {','.join(PREFETCHERS)}")
    ap.add_argument("--scales", default="1.0")
    ap.add_argument("--windows", default="0.6")
    ap.add_argument("--prediction-us", default="1.0")
    ap.add_argument("--device-fracs", default="",
                    help="e.g. '0.5,0.75' (empty = no oversubscription)")
    ap.add_argument("--evictions", default="lru",
                    help="eviction policies under oversubscription, comma "
                         f"list from {','.join(EVICTIONS)}")
    ap.add_argument("--scenario", default=None,
                    help="expand a named scenario from "
                         "repro_torch.uvm.scenarios (e.g. 'oversub-full': "
                         "11 benchmarks x 4 capacity ratios x 3 eviction "
                         "policies x 5 prefetchers) instead of the grid "
                         "flags")
    ap.add_argument("--steps", type=int, default=150,
                    help="predictor training steps of learned cells")
    ap.add_argument("--device", default="cuda",
                    help="torch device of training, inference and replay")
    ap.add_argument("--out", default=None, help="results directory")
    args = ap.parse_args(argv)

    if args.scenario:
        from repro_torch.uvm.scenarios import (available_scenarios,
                                               expand_scenario)
        try:
            cells = expand_scenario(args.scenario)
        except KeyError:
            ap.error(f"unknown scenario {args.scenario!r}; choose from "
                     f"{','.join(available_scenarios())}")
        print(f"[sweep] scenario {args.scenario!r}: {len(cells)} cells")
    else:
        benches = args.benches.split(",")
        bad = [b for b in benches if b not in BENCHMARKS]
        if bad:
            ap.error(f"unknown benchmark(s) {','.join(bad)}; "
                     f"choose from {','.join(sorted(BENCHMARKS))}")
        pfs = args.prefetchers.split(",")
        bad = [p for p in pfs if p not in PREFETCHERS]
        if bad:
            ap.error(f"unknown prefetcher(s) {','.join(bad)}; "
                     f"choose from {','.join(PREFETCHERS)}")
        evictions = args.evictions.split(",")
        bad = [e for e in evictions if e not in EVICTIONS]
        if bad:
            ap.error(f"eviction policy(ies) {','.join(bad)} not in the "
                     f"port; choose from {','.join(EVICTIONS)}")
        fracs: List[Optional[float]] = [None]
        if args.device_fracs:
            fracs += [float(x) for x in args.device_fracs.split(",")]
        cells = expand_grid(
            benches, pfs, scales=[float(x) for x in args.scales.split(",")],
            windows=[None if x == "full" else float(x)
                     for x in args.windows.split(",")],
            prediction_us=[float(x) for x in args.prediction_us.split(",")],
            device_fracs=fracs, evictions=evictions,
            service_steps=args.steps)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda but no CUDA device is available "
                 "(pass --device cpu to run the plain versions)")
    t0 = time.time()
    rows = run_sweep(cells, out_dir=args.out, device=args.device,
                     verbose=True)
    print(f"\n{len(rows)} cells in {time.time() - t0:.1f}s")
    cols = ["bench", "prefetcher", "device_frac", "eviction", "backend",
            "hit_rate", "ipc", "unity"]
    print(",".join(cols))
    for r in rows:
        print(",".join(f"{r[c]:.4f}" if isinstance(r[c], float) else str(r[c])
                       for c in cols))


if __name__ == "__main__":
    main()
