"""Batched UVM sweep on the port: (trace × prefetcher × config) grids
replayed as multi-lane K1 batches.

A slim port of the reference ``repro.uvm.sweep``: the same cells, grid
expansion, trace windows, learned-predictor training through the prediction
cache, lane batching, and result rows with the SWEEP_VERSION 9 columns.
The port accepts all five prefetchers (``none``, ``block``, ``tree``,
``learned``, ``oracle``) under the ``lru``, ``random`` and ``hotcold``
eviction policies on the benchmark traces, the serve traces
(``repro_torch.offload.serve_trace``: rows with decode-latency and TTFT
percentiles from K1's step clocks) and the two-tenant interleaved pairs
(``repro_torch.traces.interleave``: shared capacity or hard quotas, rows
with per-tenant hit rates and interference slowdowns), and the named
scenarios of ``repro_torch.uvm.scenarios``, with learned cells of every
model family of ``repro_torch.core.families`` and the ``adaptive`` eviction
pseudo-policy (``repro_torch.uvm.adaptive``, resolved per cell before its
replay config exists); it raises on anything else.  The reference's lease
pool and resume are later slices.

Three departures from the reference, all deliberate: a row that arrives
without the step clocks it needs raises (the reference re-replays it on
its NumPy engine); the tenants' solo replays behind the slowdown columns,
and the adaptive policy's probe replays, run as K1 lanes (the reference
replays them one at a time on its NumPy engine).

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
    PYTHONPATH=src python -m repro_torch.uvm.sweep --scenario serve-smoke \\
        --device cpu
    PYTHONPATH=src python -m repro_torch.uvm.sweep --benches ATAX \\
        --prefetchers learned --model-families simplified,transformer \\
        --device-fracs 0.5 --evictions adaptive
"""
from __future__ import annotations

import argparse
import collections
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
from repro_torch.uvm import adaptive
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
#: eviction policies the port replays; a cell may also name the
#: ``adaptive`` pseudo-policy, which resolves to one of them
EVICTIONS = EVICTION_POLICIES
_EVICTION_VOCAB = EVICTIONS + (adaptive.ADAPTIVE_POLICY,)

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
    """Raise on a cell the port cannot run (yet), naming the later slice."""
    from repro_torch.offload.serve_trace import is_serve_bench
    from repro_torch.traces.generators import BENCHMARKS
    from repro_torch.traces.interleave import is_mt_bench
    mt = is_mt_bench(cell.bench)
    later = None
    if not (mt or is_serve_bench(cell.bench) or cell.bench in BENCHMARKS):
        later = (f"unknown bench {cell.bench!r}; the port runs "
                 f"{','.join(sorted(BENCHMARKS))}, serve workloads and "
                 "multi-tenant pairs like 'ATAX+Pathfinder'")
    elif parse_capacity_split(cell.capacity_split) is not None and not mt:
        later = (f"capacity splits ({cell.capacity_split!r}) need a "
                 "multi-tenant bench like 'ATAX+Pathfinder'")
    elif cell.prefetcher not in PREFETCHERS:
        later = (f"unknown prefetcher {cell.prefetcher!r}; choose from "
                 f"{','.join(PREFETCHERS)}")
    elif cell.eviction not in _EVICTION_VOCAB:
        later = (f"unknown eviction {cell.eviction!r}; choose from "
                 f"{','.join(_EVICTION_VOCAB)}")
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
                model_families: Sequence[str] = ("simplified",),
                capacity_splits: Sequence[Optional[str]] = (None,),
                service_steps: int = 150) -> List[SweepCell]:
    """Cartesian product of the sweep axes, in the reference's order."""
    return [SweepCell(bench=bench, prefetcher=pf, scale=scale, seed=seed,
                      window=window, prediction_us=us, device_frac=frac,
                      eviction=ev, capacity_split=split,
                      service_steps=service_steps, model_family=fam)
            for bench in benches for pf in prefetchers for scale in scales
            for seed in seeds for window in windows for us in prediction_us
            for frac in device_fracs for ev in evictions
            for split in capacity_splits for fam in model_families]


@functools.lru_cache(maxsize=32)
def load_trace(bench: str, scale: float = 1.0, seed: int = 0,
               window: Optional[float] = 0.6) -> Trace:
    """Generate one trace and cut the leading evaluation window (memoized
    in-process; no disk cache): a serve workload's trace (never windowed:
    its decode-step bounds cover every access), a multi-tenant pair's
    interleaved trace, or a benchmark's GMMU trace."""
    from repro_torch.offload.serve_trace import (build_serve_trace,
                                                 is_serve_bench)
    from repro_torch.traces.interleave import build_mt_trace, is_mt_bench
    if is_serve_bench(bench):
        return build_serve_trace(bench, scale=scale, seed=seed)
    if is_mt_bench(bench):
        trace = build_mt_trace(bench, scale=scale, seed=seed)
    else:
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


def _trace_and_capacity(cell: SweepCell) -> Tuple[Trace, Optional[int]]:
    trace = load_trace(cell.bench, cell.scale, cell.seed, cell.window)
    device_pages = cell.device_pages
    if device_pages is None and cell.device_frac is not None:
        device_pages = int(trace.working_set_pages * cell.device_frac)
    return trace, device_pages


def resolve_evictions(cells: Sequence[SweepCell], device: str = "cuda"
                      ) -> List[str]:
    """Each cell's concrete eviction policy; the probes of every adaptive
    cell run together as K1 lanes (``adaptive.resolve_all``)."""
    return adaptive.resolve_all(
        [(cell.eviction, cell.bench, *_trace_and_capacity(cell),
          cell.prefetcher) for cell in cells], device=device)


def prepare_cell(cell: SweepCell, *, cache_dir: Optional[str] = None,
                 device: str = "cuda",
                 timings: Optional[Dict[str, float]] = None):
    """One cell's (trace, config, prefetcher, device_pages).  The adaptive
    pseudo-policy resolves to a concrete one here, before the replay config
    exists: lane batches stay policy-homogeneous and the row's eviction
    column (from the stats) records what ran."""
    check_cell(cell)
    trace, device_pages = _trace_and_capacity(cell)
    eviction = adaptive.resolve_eviction(cell.eviction, cell.bench, trace,
                                         device_pages,
                                         prefetcher=cell.prefetcher,
                                         device=device)
    fracs = parse_capacity_split(cell.capacity_split)
    tenant_pages = None
    if fracs is not None:
        if device_pages is None:
            raise ValueError(
                f"cell {cell.bench}/{cell.prefetcher}: capacity_split="
                f"{cell.capacity_split!r} needs a device capacity "
                "(device_pages or device_frac)")
        tenant_pages = (int(fracs[0] * device_pages),
                        int(fracs[1] * device_pages))
    config = UVMConfig(prediction_overhead_us=cell.prediction_us,
                       device_pages=device_pages, eviction=eviction,
                       tenant_pages=tenant_pages)
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


def _serve_step_bounds(trace: Trace) -> Optional[np.ndarray]:
    """Decode-step bounds of a serve trace, None for other traces."""
    if trace.meta and "serve" in trace.meta:
        from repro_torch.offload.serve_trace import trace_step_bounds
        return trace_step_bounds(trace)
    return None


def _mt_step_bounds(trace: Trace) -> Optional[np.ndarray]:
    """Step bounds at each tenant's *last access* of an interleaved trace
    (None for single-tenant traces): the replay's clocks there are the
    per-tenant completion cycles behind the interference slowdowns."""
    from repro_torch.traces.interleave import tenant_last_index
    last = tenant_last_index(trace)
    if last is None:
        return None
    return np.asarray(sorted({i + 1 for i in last if i >= 0}),
                      dtype=np.int64)


def _step_bounds(trace: Trace) -> Optional[np.ndarray]:
    """The step bounds a cell's replay clocks: serve decode steps,
    multi-tenant completion bounds, or None."""
    bounds = _serve_step_bounds(trace)
    return bounds if bounds is not None else _mt_step_bounds(trace)


def _step_clocks(cell: SweepCell, trace: Trace, config: UVMConfig,
                 stats: UVMStats, bounds: np.ndarray,
                 cache_dir: Optional[str], device: str) -> np.ndarray:
    """The step clocks the row's own replay captured.  A row without them
    raises: nothing re-replays it quietly.  ``REPRO_SERVE_CHECK=1`` asks for
    the differential check: the cell re-replays on the port's legacy engine,
    and its counters and clocks must equal the row's bit for bit."""
    what = (f"{stats.backend} row {cell.bench}/{cell.prefetcher}/"
            f"{cell.eviction}")
    clocks = stats.step_clocks
    if clocks is None or len(clocks) != len(bounds):
        raise ValueError(f"{what} arrived without its {len(bounds)} step "
                         "clocks")
    if os.environ.get("REPRO_SERVE_CHECK", "0") == "1":
        from repro_torch.uvm.simulator import UVMSimulator
        pf = make_prefetcher(cell, trace, config, cache_dir, device)
        check = UVMSimulator(config).run(trace, pf, step_bounds=bounds)
        for f in ("hits", "late", "faults", "prefetch_issued",
                  "prefetch_used", "pages_migrated", "pages_evicted"):
            if getattr(check, f) != getattr(stats, f):
                raise AssertionError(
                    f"{what}: {f} {getattr(stats, f)} != legacy "
                    f"{getattr(check, f)}")
        if not np.array_equal(np.asarray(clocks), check.step_clocks):
            raise AssertionError(f"{what}: step clocks diverge from the "
                                 "legacy engine's")
    return np.asarray(clocks)


def _serve_latency_row(cell: SweepCell, trace: Trace, config: UVMConfig,
                       stats: UVMStats, cache_dir: Optional[str],
                       device: str) -> Dict:
    """The serving SLO columns of one serve row: percentile math over the
    step clocks K1 captured (``slo_source="kernel"``)."""
    from repro_torch.offload.serve_trace import (serve_latency_columns,
                                                 trace_step_bounds)
    clocks = _step_clocks(cell, trace, config, stats,
                          trace_step_bounds(trace), cache_dir, device)
    row = serve_latency_columns(trace, clocks, config)
    row["slo_source"] = "kernel"
    return row


def _solo_capacity(config: UVMConfig, device_pages: Optional[int],
                   tenant: int) -> Optional[int]:
    """A tenant's solo capacity: its quota on split rows, the whole device
    on shared rows."""
    return (config.tenant_pages[tenant] if config.tenant_pages
            else device_pages)


def _solo_key(cell: SweepCell, tenant: int, capacity: Optional[int],
              eviction: str) -> Tuple:
    """Identity of one tenant's solo replay: every cell of a grid that
    shares it reuses one replay."""
    return (cell.bench, cell.scale, cell.seed, cell.window, tenant, capacity,
            cell.prefetcher, eviction, cell.prediction_us, cell.model_family,
            cell.service_steps)


def _solo_requests(cells: Sequence[SweepCell], prepared: Sequence[Tuple],
                   timings: Sequence[Dict[str, float]],
                   cache_dir: Optional[str], device: str
                   ) -> Tuple[Dict[Tuple, ReplayRequest], List[List[Tuple]]]:
    """The distinct solo replays behind the grid's interference slowdowns,
    and the solo keys each cell uses: each tenant's accesses extracted from
    the interleaved trace (``mt_component_trace``) and replayed alone at its
    solo capacity.  A learned solo lane trains on the solo trace through
    the prediction cache; the cell that first needs it pays that training
    in its ``timings``."""
    from repro_torch.traces.interleave import (mt_component_trace,
                                               tenant_last_index)
    solos: Dict[Tuple, ReplayRequest] = {}
    uses: List[List[Tuple]] = []
    components: Dict[Tuple[int, int], Trace] = {}
    for cell, (trace, config, _, device_pages), tm in zip(cells, prepared,
                                                          timings):
        uses.append([])
        last = tenant_last_index(trace)
        if last is None:
            continue
        for t, li in enumerate(last):
            capacity = _solo_capacity(config, device_pages, t)
            key = _solo_key(cell, t, capacity, config.eviction)
            if li >= 0:
                uses[-1].append(key)
            if li < 0 or key in solos:
                continue
            solo = components.get((id(trace), t))
            if solo is None:
                solo = components[(id(trace), t)] = mt_component_trace(
                    trace, t)
            cfg = UVMConfig(prediction_overhead_us=cell.prediction_us,
                            device_pages=capacity, eviction=config.eviction)
            solo_tm: Dict[str, float] = {}
            pf = make_prefetcher(cell, solo, cfg, cache_dir, device, solo_tm)
            for k in ("train_s", "predict_s"):
                tm[k] = tm.get(k, 0.0) + solo_tm.get(k, 0.0)
            solos[key] = ReplayRequest(solo, pf, cfg)
    return solos, uses


def _mt_row(cell: SweepCell, trace: Trace, config: UVMConfig,
            stats: UVMStats, device_pages: Optional[int],
            solo_cycles: Dict[Tuple, int], cache_dir: Optional[str],
            device: str) -> Dict:
    """The multi-tenant columns of one interleaved-trace row: tenant count,
    the capacity split that ran, per-tenant hit rates, and the interference
    slowdown (per-tenant completion cycles in the mix over the tenant's
    solo replay)."""
    from repro_torch.traces.interleave import N_TENANTS, tenant_last_index

    row: Dict = {"tenants": N_TENANTS,
                 "capacity_split": cell.capacity_split or "shared"}
    th, ta = stats.tenant_hits, stats.tenant_accesses
    for t in range(N_TENANTS):
        row[f"hit_rate_t{t}"] = (th[t] / ta[t]) if ta and ta[t] else None
    last = tenant_last_index(trace)
    bounds = _mt_step_bounds(trace)
    clocks = _step_clocks(cell, trace, config, stats, bounds, cache_dir,
                          device)
    cyc_at = {int(b): float(c) for b, c in zip(bounds, clocks)}
    slowdowns = []
    for t in range(N_TENANTS):
        if last[t] < 0:
            row[f"slowdown_t{t}"] = None
            continue
        solo = solo_cycles[_solo_key(
            cell, t, _solo_capacity(config, device_pages, t),
            config.eviction)]
        sd = cyc_at[last[t] + 1] / solo if solo > 0 else None
        row[f"slowdown_t{t}"] = sd
        if sd is not None:
            slowdowns.append(sd)
    row["interference_slowdown"] = max(slowdowns) if slowdowns else None
    return row


def run_sweep(cells: Sequence[SweepCell], *, out_dir: Optional[str] = None,
              cache_dir: Optional[str] = None, device: str = "cuda",
              verbose: bool = False) -> List[Dict]:
    """Run a grid of cells; returns rows in the order of ``cells``.

    The adaptive cells' probes run first, together; then cells are
    prepared in order (learned cells train or hit the prediction
    cache), the tenants' solo replays of multi-tenant cells join them, and
    everything replays as homogeneous K1 lane batches; serve and
    multi-tenant cells carry their step bounds into K1.  Row ``seconds`` is
    the cell's share of its batch's replay time, and on a multi-tenant row
    also its share of its solo replays' time (a solo replay's share split
    evenly among the rows that use it), so the rows' seconds add up to the
    sweep's replay time.  Learned rows also carry ``train_seconds`` and
    ``predict_seconds`` (0.0 where the predictions came from the cache; a
    multi-tenant row includes the training of the solo lanes it was the
    first to need)."""
    for cell in cells:
        check_cell(cell)
    if cache_dir is None and out_dir is not None:
        cache_dir = os.path.join(out_dir, "cache")
    # every adaptive cell's probes in one backend call; prepare_cell then
    # reads its policy from the memo
    resolve_evictions(cells, device)
    prepared, timings = [], []
    for cell in cells:
        tm: Dict[str, float] = {}
        prepared.append(prepare_cell(cell, cache_dir=cache_dir,
                                     device=device, timings=tm))
        timings.append(tm)
    requests = [ReplayRequest(tr, pf, cfg, step_bounds=_step_bounds(tr))
                for tr, cfg, pf, _ in prepared]
    solos, uses = _solo_requests(cells, prepared, timings, cache_dir, device)
    solo_index = {}
    for key, req in solos.items():
        solo_index[key] = len(requests)
        requests.append(req)
    from repro_torch.traces.interleave import mt_meta
    backend = get_backend("cuda", device)
    stats: List[Optional[UVMStats]] = [None] * len(requests)
    seconds = [0.0] * len(requests)
    for batch in backend.pack_lanes(requests):
        if verbose:
            print(f"[sweep] cuda lanes: replaying {len(batch)} cells in one "
                  "batch", flush=True)
        t0 = time.perf_counter()
        got = backend.replay([requests[i] for i in batch])
        per_cell = (time.perf_counter() - t0) / len(batch)
        for i, st in zip(batch, got):
            stats[i], seconds[i] = st, per_cell
    solo_cycles = {key: int(stats[i].cycles) for key, i in solo_index.items()}
    users = collections.Counter(key for keys in uses for key in keys)
    rows: List[Dict] = []
    for i, (cell, (trace, config, _, device_pages)) in enumerate(
            zip(cells, prepared)):
        row = _finish_row(cell, stats[i], device_pages, seconds[i] + sum(
            seconds[solo_index[key]] / users[key] for key in uses[i]))
        row.update(train_seconds=timings[i].get("train_s", 0.0),
                   predict_seconds=timings[i].get("predict_s", 0.0))
        if "top1" in timings[i]:
            # the fit's own metrics, on the row of the cell that trained it
            row.update({f"fit_{m}": timings[i][m]
                        for m in ("top1", "f1", "coverage")})
        if _serve_step_bounds(trace) is not None:
            row.update(_serve_latency_row(cell, trace, config, stats[i],
                                          cache_dir, device))
        elif mt_meta(trace) is not None:
            row.update(_mt_row(cell, trace, config, stats[i], device_pages,
                               solo_cycles, cache_dir, device))
        rows.append(row)
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
    from repro_torch.offload.serve_trace import (SERVE_WORKLOADS,
                                                 is_serve_bench)
    from repro_torch.traces.generators import BENCHMARKS
    from repro_torch.traces.interleave import is_mt_bench
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
    ap.add_argument("--capacity-splits", default="",
                    help="multi-tenant capacity splits for '<A>+<B>' "
                         "benches, e.g. 'shared,0.5/0.5,0.4/0.4' "
                         "(empty = shared capacity)")
    ap.add_argument("--evictions", default="lru",
                    help="eviction policies under oversubscription, comma "
                         f"list from {','.join(_EVICTION_VOCAB)} ('adaptive' "
                         "resolves per cell before its replay; rows record "
                         "the concrete policy)")
    ap.add_argument("--model-families", default="simplified",
                    help="predictor families for learned cells, comma list "
                         f"from {','.join(MODEL_FAMILIES)}")
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
        bad = [b for b in benches if b not in BENCHMARKS
               and not is_serve_bench(b) and not is_mt_bench(b)]
        if bad:
            ap.error(f"unknown benchmark(s) {','.join(bad)}; "
                     f"choose from {','.join(sorted(BENCHMARKS))}, "
                     "multi-tenant pairs like ATAX+Pathfinder, or serve "
                     f"workloads {','.join(sorted(SERVE_WORKLOADS))} "
                     "(rate variants like ServeBursty@r128 accepted)")
        pfs = args.prefetchers.split(",")
        bad = [p for p in pfs if p not in PREFETCHERS]
        if bad:
            ap.error(f"unknown prefetcher(s) {','.join(bad)}; "
                     f"choose from {','.join(PREFETCHERS)}")
        splits: List[Optional[str]] = [None]
        if args.capacity_splits:
            splits = list(args.capacity_splits.split(","))
            for split in splits:
                try:
                    parse_capacity_split(split)
                except ValueError as e:
                    ap.error(str(e))
            mt_less = [b for b in benches if not is_mt_bench(b)]
            if mt_less and any(parse_capacity_split(x) for x in splits):
                ap.error(f"--capacity-splits needs multi-tenant benches; "
                         f"{','.join(mt_less)} are single-tenant")
        evictions = args.evictions.split(",")
        bad = [e for e in evictions if e not in _EVICTION_VOCAB]
        if bad:
            ap.error(f"unknown eviction policy(ies) {','.join(bad)}; "
                     f"choose from {','.join(_EVICTION_VOCAB)}")
        model_families = args.model_families.split(",")
        bad = [m for m in model_families if m not in MODEL_FAMILIES]
        if bad:
            ap.error(f"unknown model family(ies) {','.join(bad)}; "
                     f"choose from {','.join(MODEL_FAMILIES)}")
        fracs: List[Optional[float]] = [None]
        if args.device_fracs:
            fracs += [float(x) for x in args.device_fracs.split(",")]
        cells = expand_grid(
            benches, pfs, scales=[float(x) for x in args.scales.split(",")],
            windows=[None if x == "full" else float(x)
                     for x in args.windows.split(",")],
            prediction_us=[float(x) for x in args.prediction_us.split(",")],
            device_fracs=fracs, evictions=evictions,
            model_families=model_families, capacity_splits=splits,
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
