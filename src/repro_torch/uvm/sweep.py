"""Batched UVM sweep on the port: (trace × prefetcher × config) grids
replayed as multi-lane K1 batches, down the backend chain where K1
declines, and crash-safe end to end with an ``out_dir``.

A port of the reference ``repro.uvm.sweep``: the same cells, grid
expansion, trace windows, learned-predictor training through the
prediction cache, lane batching, result rows with the SWEEP_VERSION 9
columns, and the crash-safety plane.  The port accepts all five
prefetchers (``none``, ``block``, ``tree``, ``learned``, ``oracle``) under
the ``lru``, ``random`` and ``hotcold`` eviction policies on the benchmark
traces, the serve traces (``repro_torch.offload.serve_trace``: rows with
decode-latency and TTFT percentiles from K1's step clocks) and the
two-tenant interleaved pairs (``repro_torch.traces.interleave``: shared
capacity or hard quotas, rows with per-tenant hit rates and interference
slowdowns), and the named scenarios of ``repro_torch.uvm.scenarios``, with
learned cells of every model family of ``repro_torch.core.families`` and
the ``adaptive`` eviction pseudo-policy (``repro_torch.uvm.adaptive``,
resolved per cell before its replay config exists); it raises on anything
else.

Every pending cell whose engine is ``auto``/``vectorized`` and whose
backend chain starts at ``cuda`` (``replay_core.backend_chain``), and that
K1 accepts, packs into a K1 lane batch in the driver process.  Every other
cell (``engine="legacy"``, ``backend="numpy"``, or a request K1 declines:
per-transfer timelines, lanes past K1's length or span ceilings, more than
65,536 step windows, oracle lookahead above 512) replays on its own
through ``replay_core.dispatch``, on the NumPy chunked engine or the legacy
loop.  Each row's ``backend`` column names the backend that ran it.

Crash safety (the reference's protocol), with an ``out_dir``:

* every persisted artifact (``cells/<key>.json`` rows, cached trace
  ``.npz`` files under ``trace_cache/``, prediction-cache entries) is
  checksummed and written by atomic rename; a torn, corrupt or
  cross-version file found on read is quarantined to ``*.corrupt`` with a
  warning and the work redone;
* K1 lane rows are persisted as soon as their batch (and the solo replays
  they need) returns; every other cell runs under an expiring lease
  (``cells/<key>.lease``, ``repro_torch.distributed.fault_tolerance``)
  with retries and capped exponential backoff, and lands in
  ``quarantine.json`` as a ``quarantined=True`` stub row after
  ``max_attempts`` lease claims instead of aborting the grid;
* ``workers > 1`` runs those cells in a pool of spawned lease workers
  supervised by a heartbeat monitor (dead workers restart, silent ones are
  terminated); they share the card with the driver;
* a resumed sweep loads finished cells and prepares, probes and replays
  only the pending ones: a resumed grid launches no kernel and trains
  nothing;
* ``repro_torch.uvm.faults`` (``REPRO_FAULT_PLAN``) injects kills,
  corruption and transient backend raises at the sites marked here, and
  its chaos harness proves a sweep under such a plan converges to the
  fault-free rows.

Departures from the reference, all deliberate: a row that arrives without
the step clocks it needs raises (the reference re-replays it on its NumPy
engine); the tenants' solo replays behind the slowdown columns, and the
adaptive policy's probe replays, run as K1 lanes where K1 accepts them
(the reference replays them one at a time on its NumPy engine); the
cells' default backend is ``cuda`` (the reference's ``auto``); rows also
carry ``train_seconds``, ``predict_seconds`` and, on the row of the cell
that trained, ``fit_top1``/``fit_f1``/``fit_coverage``, which the
convergence digest leaves aside (``faults.VOLATILE_ROW_FIELDS``); pool
workers always start by spawn (a process that has initialised CUDA cannot
fork safely); and the lane stage runs its batches one after another (the
reference overlaps preparation and flushes in thread pools).

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
    PYTHONPATH=src python -m repro_torch.uvm.sweep --benches ATAX,BICG \\
        --prefetchers learned --backend numpy --workers 4 --out results/l
    PYTHONPATH=src python -m repro_torch.uvm.sweep --scenario serve-smoke \\
        --device cpu
    PYTHONPATH=src python -m repro_torch.uvm.sweep --benches ATAX \\
        --prefetchers learned --model-families simplified,transformer \\
        --device-fracs 0.5 --evictions adaptive
    PYTHONPATH=src python -m repro_torch.uvm.sweep --benches ATAX,BICG \\
        --prefetchers none,tree --engine legacy --device cpu

Rerunning a command with the same ``--out`` resumes it; ``--no-resume``
recomputes every cell.
"""
from __future__ import annotations

import argparse
import collections
import csv
import dataclasses
import functools
import hashlib
import json
import multiprocessing
import os
import sys
import threading
import time
import warnings
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.families import MODEL_FAMILIES
from repro_torch import kernels, spans
from repro_torch.distributed import fault_tolerance as ft
from repro_torch.traces.trace import ACCESS_DTYPE, Trace
from repro_torch.uvm import adaptive, faults
from repro_torch.uvm.config import UVMConfig
from repro_torch.uvm.eviction import EVICTION_POLICIES
from repro_torch.uvm.prefetchers import (BlockPrefetcher, LearnedPrefetcher,
                                         NoPrefetcher, OraclePrefetcher,
                                         Prefetcher, TreePrefetcher)
from repro_torch.uvm.engine import ENGINES
from repro_torch.uvm.replay_core import (ReplayRequest, backend_chain,
                                         dispatch, get_backend)
from repro_torch.uvm.simulator import UVMStats

#: cell-spec prefetcher names to concrete types, in the reference's order
_PREFETCHER_TYPES = {"none": NoPrefetcher, "block": BlockPrefetcher,
                     "tree": TreePrefetcher, "learned": LearnedPrefetcher,
                     "oracle": OraclePrefetcher}
PREFETCHERS = tuple(_PREFETCHER_TYPES)
#: a cell's backend: the first of its chain (``auto`` and ``cuda``: K1, then
#: the NumPy engine, then the legacy loop; ``numpy``: the NumPy engine, then
#: the legacy loop)
BACKENDS = ("auto", "numpy", "cuda")
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
    """Raise on a cell the port cannot run, naming why."""
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
    elif cell.engine not in ENGINES:
        later = (f"unknown engine {cell.engine!r}; choose from "
                 f"{','.join(ENGINES)}")
    elif cell.backend not in BACKENDS:
        later = (f"unknown backend {cell.backend!r}; choose from "
                 f"{','.join(BACKENDS)}")
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
                engine: str = "auto", backend: str = "cuda",
                service_steps: int = 150) -> List[SweepCell]:
    """Cartesian product of the sweep axes, in the reference's order."""
    return [SweepCell(bench=bench, prefetcher=pf, scale=scale, seed=seed,
                      window=window, prediction_us=us, device_frac=frac,
                      eviction=ev, capacity_split=split, engine=engine,
                      backend=backend, service_steps=service_steps,
                      model_family=fam)
            for bench in benches for pf in prefetchers for scale in scales
            for seed in seeds for window in windows for us in prediction_us
            for frac in device_fracs for ev in evictions
            for split in capacity_splits for fam in model_families]


# ---------------------------------------------------------------------------
# cached trace generation (the reference's checksummed npz cache and memo)
# ---------------------------------------------------------------------------

def _trace_cache_path(cache_dir: str, bench: str, scale: float,
                      seed: int) -> str:
    tag = hashlib.sha256(
        json.dumps([SWEEP_VERSION, bench, scale, seed]).encode()
    ).hexdigest()[:16]
    return os.path.join(cache_dir, f"trace_{bench}_{tag}.npz")


def _trace_digest(accesses: np.ndarray, meta_json: str) -> str:
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(accesses).tobytes())
    h.update(meta_json.encode())
    return h.hexdigest()


def quarantine_artifact(path: str, reason: str) -> None:
    """Move a damaged persisted artifact aside (``<path>.corrupt``) with a
    warning, so the caller regenerates it and the evidence survives."""
    warnings.warn(f"{reason}: quarantining {path} -> {path}.corrupt and "
                  "regenerating", RuntimeWarning)
    try:
        os.replace(path, path + ".corrupt")
    except OSError:                   # already gone: a racer quarantined it
        pass


class _TraceMemo:
    """Bounded in-process LRU over loaded (and checksum-verified) traces,
    keyed by (bench, scale, seed, window, cache_dir): cells sharing a trace
    read and hash its cache file once per process.  Thread-safe.
    ``REPRO_TRACE_MEMO`` overrides the bound (0 disables the memo)."""

    def __init__(self, maxsize: int = 32):
        self.maxsize = maxsize
        self._lock = threading.Lock()
        self._data: "collections.OrderedDict[Tuple, Trace]" = \
            collections.OrderedDict()

    def _bound(self) -> int:
        try:
            return int(os.environ.get("REPRO_TRACE_MEMO", self.maxsize))
        except ValueError:
            return self.maxsize

    def get(self, key: Tuple) -> Optional[Trace]:
        if self._bound() <= 0:
            return None
        with self._lock:
            trace = self._data.pop(key, None)
            if trace is not None:
                self._data[key] = trace       # refresh LRU position
            return trace

    def put(self, key: Tuple, trace: Trace) -> None:
        bound = self._bound()
        if bound <= 0:
            return
        with self._lock:
            self._data[key] = trace
            self._data.move_to_end(key)
            while len(self._data) > bound:
                self._data.popitem(last=False)

    def clear(self) -> None:
        with self._lock:
            self._data.clear()


#: process-wide trace memo (worker processes each build their own)
_trace_memo = _TraceMemo()

#: single-flight guard: threads asking for the same trace resolve to one
#: generate/read/checksum, the others wait for the winner's memo entry
_trace_flight_guard = threading.Lock()
_trace_flights: Dict[Tuple, threading.Lock] = {}


def _trace_flight(key: Tuple) -> threading.Lock:
    with _trace_flight_guard:
        return _trace_flights.setdefault(key, threading.Lock())


def load_trace(bench: str, scale: float = 1.0, seed: int = 0,
               window: Optional[float] = 0.6,
               cache_dir: Optional[str] = None) -> Trace:
    """Generate (or load from the npz disk cache under ``cache_dir``) one
    trace and cut the leading evaluation window: a serve workload's trace
    (never windowed: its decode-step bounds cover every access), a
    multi-tenant pair's interleaved trace, or a benchmark's GMMU trace.

    A cached trace carries a content checksum; a truncated or corrupted
    cache file (a killed writer, disk rot, an injected ``trace.artifact``
    fault) is quarantined with a warning and the trace regenerated.  Loads
    are memoized in-process (:class:`_TraceMemo`), so repeated calls return
    the same object."""
    memo_key = (bench, scale, seed, window, cache_dir)
    memoized = _trace_memo.get(memo_key)
    if memoized is not None:
        return memoized
    with _trace_flight(memo_key):
        memoized = _trace_memo.get(memo_key)    # the winner filled it
        if memoized is not None:
            return memoized
        trace = _load_trace_uncached(bench, scale, seed, window, cache_dir)
        _trace_memo.put(memo_key, trace)
        return trace


def _load_trace_uncached(bench: str, scale: float, seed: int,
                         window: Optional[float],
                         cache_dir: Optional[str]) -> Trace:
    trace = None
    path = None
    if cache_dir:
        path = _trace_cache_path(cache_dir, bench, scale, seed)
        if os.path.exists(path):
            try:
                with np.load(path, allow_pickle=False) as z:
                    meta_json = str(z["meta"])
                    accesses = z["accesses"].astype(ACCESS_DTYPE,
                                                    copy=False)
                    stored_sha = str(z["sha"])
                if stored_sha != _trace_digest(accesses, meta_json):
                    raise ValueError("trace cache checksum mismatch")
                meta = json.loads(meta_json)
                trace = Trace(name=meta["name"], accesses=accesses,
                              array_bases=meta["array_bases"],
                              array_pages=meta["array_pages"],
                              n_instructions=meta["n_instructions"],
                              meta=meta.get("meta", {}))
            except Exception as e:
                quarantine_artifact(
                    path, f"invalid cached trace for {bench} ({e!r})")
                trace = None
    if trace is None:
        from repro_torch.offload.serve_trace import (build_serve_trace,
                                                     is_serve_bench)
        from repro_torch.traces.interleave import (build_mt_trace,
                                                   is_mt_bench)
        if is_serve_bench(bench):
            trace = build_serve_trace(bench, scale=scale, seed=seed)
        elif is_mt_bench(bench):
            trace = build_mt_trace(bench, scale=scale, seed=seed)
        else:
            from repro_torch.traces import GPUModel, generate_benchmark
            from repro_torch.traces.gpu_model import GPUModelConfig
            spec = generate_benchmark(bench, scale=scale, seed=seed)
            trace = GPUModel(GPUModelConfig(seed=seed)).run(spec)
        if path:
            os.makedirs(cache_dir, exist_ok=True)
            meta = json.dumps({
                "name": trace.name,
                "array_bases": trace.array_bases,
                "array_pages": trace.array_pages,
                "n_instructions": trace.n_instructions,
                "meta": trace.meta,
            })
            tmp = path + f".{os.getpid()}.{threading.get_ident()}.tmp.npz"
            np.savez(tmp, accesses=trace.accesses, meta=np.array(meta),
                     sha=np.array(_trace_digest(trace.accesses, meta)))
            os.replace(tmp, path)
            faults.corrupt("trace.artifact", path, os.path.basename(path))
    if window is not None and not (trace.meta and "serve" in trace.meta):
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


@spans.spanned("sweep.prepare_cell.working_set")
def _trace_and_capacity(cell: SweepCell, cache_dir: Optional[str] = None
                        ) -> Tuple[Trace, Optional[int]]:
    trace = load_trace(cell.bench, cell.scale, cell.seed, cell.window,
                       cache_dir=cache_dir)
    device_pages = cell.device_pages
    if device_pages is None and cell.device_frac is not None:
        device_pages = int(trace.working_set_pages * cell.device_frac)
    return trace, device_pages


@spans.spanned("sweep.resolve_evictions")
def resolve_evictions(cells: Sequence[SweepCell], device: str = "cuda",
                      cache_dir: Optional[str] = None) -> List[str]:
    """Each cell's concrete eviction policy; the probes of every adaptive
    cell run together as K1 lanes (``adaptive.resolve_all``)."""
    return adaptive.resolve_all(
        [(cell.eviction, cell.bench, *_trace_and_capacity(cell, cache_dir),
          cell.prefetcher) for cell in cells], device=device)


@spans.spanned("sweep.prepare_cell")
def prepare_cell(cell: SweepCell, *, cache_dir: Optional[str] = None,
                 device: str = "cuda",
                 timings: Optional[Dict[str, float]] = None):
    """One cell's (trace, config, prefetcher, device_pages).  The adaptive
    pseudo-policy resolves to a concrete one here, before the replay config
    exists: lane batches stay policy-homogeneous and the row's eviction
    column (from the stats) records what ran."""
    check_cell(cell)
    trace, device_pages = _trace_and_capacity(cell, cache_dir)
    with spans.span("sweep.prepare_cell.eviction"):
        eviction = adaptive.resolve_eviction(
            cell.eviction, cell.bench, trace, device_pages,
            prefetcher=cell.prefetcher, device=device)
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
    with spans.span("sweep.prepare_cell.prefetcher"):
        prefetcher = make_prefetcher(cell, trace, config, cache_dir, device,
                                     timings)
    return trace, config, prefetcher, device_pages


def _finish_row(cell: SweepCell, stats: UVMStats,
                device_pages: Optional[int], seconds: float,
                record_timeline: bool = False) -> Dict:
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
    if record_timeline and stats.timeline is not None:
        row["timeline"] = stats.timeline.tolist()
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


@spans.spanned("sweep._solo_requests")
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
        with spans.span("sweep._solo_requests.component"):
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
                with spans.span("sweep._solo_requests.component"):
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


def _chain(cell: SweepCell) -> str:
    """The backend chain a cell's replays take: ``legacy`` under the legacy
    engine, else the cell's backend."""
    return "legacy" if cell.engine == "legacy" else cell.backend


def _wants_lanes(cell: SweepCell) -> bool:
    """True when the cell's chain starts at K1: it is prepared in the
    driver and replays in a K1 lane batch there if K1 accepts it."""
    return backend_chain(_chain(cell))[0] == "cuda"


def _run_cells(cells: Sequence[SweepCell], *, cache_dir: Optional[str],
               device: str, verbose: bool = False,
               record_timeline: bool = False, lanes_only: bool = False,
               record: Optional[Callable[[int, Dict], None]] = None
               ) -> Dict[int, Dict]:
    """Prepare and replay ``cells`` in this process; returns ``{position:
    row}``.

    The adaptive cells' probes run first, together; then cells are
    prepared in order (learned cells train or hit the prediction cache),
    the tenants' solo replays of multi-tenant cells join them, and every
    replay whose chain starts at ``cuda`` and that K1 accepts replays in
    homogeneous K1 lane batches (``lane.flush`` fires before each); serve
    and multi-tenant cells carry their step bounds into K1.  Every other
    replay runs on its own through ``replay_core.dispatch`` (a solo replay
    takes the chain of the first cell that uses it).  With ``lanes_only``
    the cells whose own replay would leave K1 are left out of the result.
    ``record(position, row)`` receives each row as soon as its replay and
    the solo replays it needs have returned."""
    resolve_evictions(cells, device, cache_dir)
    prepared, timings = [], []
    for cell in cells:
        tm: Dict[str, float] = {}
        prepared.append(prepare_cell(cell, cache_dir=cache_dir,
                                     device=device, timings=tm))
        timings.append(tm)
    requests = [ReplayRequest(tr, pf, cfg, record_timeline=record_timeline,
                              step_bounds=_step_bounds(tr))
                for tr, cfg, pf, _ in prepared]
    backend = get_backend("cuda", device)
    pos = [i for i, (cell, req) in enumerate(zip(cells, requests))
           if not lanes_only or (_wants_lanes(cell)
                                 and backend.can_replay(req))]
    cells = [cells[i] for i in pos]
    prepared = [prepared[i] for i in pos]
    timings = [timings[i] for i in pos]
    requests = [requests[i] for i in pos]
    owner = list(range(len(cells)))     # the cell a request's chain is of
    solos, uses = _solo_requests(cells, prepared, timings, cache_dir, device)
    solo_index = {}
    for key, req in solos.items():
        solo_index[key] = len(requests)
        requests.append(req)
        owner.append(next(j for j, keys in enumerate(uses) if key in keys))
    chains = [_chain(cells[j]) for j in owner]
    from repro_torch.traces.interleave import mt_meta
    lanes = [i for i, req in enumerate(requests)
             if backend_chain(chains[i])[0] == "cuda"
             and backend.can_replay(req)]
    stats: List[Optional[UVMStats]] = [None] * len(requests)
    seconds = [0.0] * len(requests)
    users = collections.Counter(key for keys in uses for key in keys)
    rows: Dict[int, Dict] = {}

    @spans.spanned("sweep.finish_rows")
    def emit_ready() -> None:
        for j, (cell, (trace, config, _, device_pages)) in enumerate(
                zip(cells, prepared)):
            if j in rows or stats[j] is None or any(
                    stats[solo_index[key]] is None for key in uses[j]):
                continue
            row = _finish_row(cell, stats[j], device_pages, seconds[j] + sum(
                seconds[solo_index[key]] / users[key] for key in uses[j]),
                record_timeline)
            row.update(train_seconds=timings[j].get("train_s", 0.0),
                       predict_seconds=timings[j].get("predict_s", 0.0))
            if "top1" in timings[j]:
                # the fit's own metrics, on the row of the cell that trained
                row.update({f"fit_{m}": timings[j][m]
                            for m in ("top1", "f1", "coverage")})
            if _serve_step_bounds(trace) is not None:
                row.update(_serve_latency_row(cell, trace, config, stats[j],
                                              cache_dir, device))
            elif mt_meta(trace) is not None:
                solo_cycles = {key: int(stats[solo_index[key]].cycles)
                               for key in uses[j]}
                row.update(_mt_row(cell, trace, config, stats[j],
                                   device_pages, solo_cycles, cache_dir,
                                   device))
            rows[j] = row
            if record is not None:
                record(pos[j], row)

    for batch in backend.pack_lanes([requests[i] for i in lanes]):
        batch = [lanes[j] for j in batch]
        if verbose:
            print(f"[sweep] cuda lanes: replaying {len(batch)} cells in one "
                  "batch", flush=True)
        faults.fire("lane.flush",
                    f"{len(batch)}:{cells[owner[batch[0]]].key()}")
        t0 = time.perf_counter()
        got = backend.replay([requests[i] for i in batch])
        per_cell = (time.perf_counter() - t0) / len(batch)
        for i, st in zip(batch, got):
            stats[i], seconds[i] = st, per_cell
        emit_ready()
    for i, req in enumerate(requests):
        if stats[i] is not None:
            continue
        t0 = time.perf_counter()
        stats[i] = dispatch(req, chains[i], device)
        seconds[i] = time.perf_counter() - t0
        if verbose:
            print(f"[sweep] {stats[i].backend}: {req.trace.name}/"
                  f"{req.prefetcher.name}/{req.config.eviction} in "
                  f"{seconds[i]:.2f} s", flush=True)
        emit_ready()
    return {pos[j]: row for j, row in rows.items()}


@spans.records_pass
def run_sweep(cells: Sequence[SweepCell], *, out_dir: Optional[str] = None,
              workers: int = 1, resume: bool = True,
              cache_dir: Optional[str] = None, device: str = "cuda",
              verbose: bool = False, write_aggregate: bool = True,
              max_attempts: Optional[int] = None,
              lease_ttl_s: Optional[float] = None,
              record_timeline: bool = False) -> List[Dict]:
    """Run a grid of cells; returns rows in the order of ``cells``.

    Without ``out_dir`` and with one worker, every cell runs in this
    process as :func:`_run_cells` describes.  Otherwise the cells whose
    chain starts at ``cuda`` and that K1 accepts replay in K1 lane batches
    here, and every other cell runs on its own (:func:`simulate_cell`):
    with ``out_dir`` under a lease (in a pool of ``workers`` spawned lease
    workers when ``workers > 1``), else in a plain spawn pool.

    With ``out_dir`` each finished cell is persisted under
    ``out_dir/cells/<key>.json`` as a checksummed envelope and skipped on
    resume (a truncated, corrupt or cross-version cell file is quarantined
    to ``<key>.json.corrupt`` with a warning and the cell requeued);
    leased cells retry with backoff, and a cell still failing after
    ``max_attempts`` lease claims lands in ``out_dir/quarantine.json`` and
    contributes a ``quarantined=True`` stub row; ``results.json``,
    ``results.csv`` and ``quarantine.json`` are written at the end unless
    ``write_aggregate`` is false.  Traces and predictions are cached under
    ``cache_dir`` (default ``out_dir/trace_cache``).  ``resume=False``
    clears earlier results, attempt counts and quarantine verdicts.

    Row ``seconds`` is a lane cell's share of its batch's replay time, or a
    dispatched cell's own replay time, and on a multi-tenant row also its
    share of its solo replays' time.  Learned rows also carry
    ``train_seconds`` and ``predict_seconds`` (0.0 where the predictions
    came from the cache).  ``record_timeline`` asks every replay for its
    per-transfer timeline (K1 records none, so such cells take the NumPy
    engine) and puts it into the row as ``timeline``.

    A call made while a ``torch.profiler`` records is traced whole and
    leaves one pass record of its spans and counters
    (``repro_torch.spans``)."""
    for cell in cells:
        check_cell(cell)
    if cache_dir is None and out_dir is not None:
        cache_dir = os.path.join(out_dir, "trace_cache")
    pol = _exec_policy(max_attempts, lease_ttl_s)
    rows: Dict[int, Dict] = {}
    pending: List[int] = []
    for i, cell in enumerate(cells):
        if out_dir:
            path = _cell_path(out_dir, cell)
            if resume:
                row, reason = load_cell_row(path)
                if row is not None:
                    rows[i] = row
                    continue
                if reason in ("corrupt", "version"):
                    quarantine_artifact(
                        path, f"resume: invalid cell file for "
                        f"{cell.bench}/{cell.prefetcher} ({reason}); "
                        "requeueing")
                qdoc = _read_json(path + ".quarantine")
                if qdoc is not None:
                    rows[i] = _quarantine_stub(cell, qdoc)
                    continue
            else:
                # a fresh run must not inherit results, attempt counts or
                # quarantine verdicts: the leased path short-circuits on them
                for suffix in ("", ".quarantine", ".attempts"):
                    try:
                        os.unlink(path + suffix)
                    except OSError:
                        pass
        pending.append(i)

    def _record(i: int, row: Dict, persist: bool = True) -> None:
        rows[i] = row
        if out_dir and persist:
            write_cell_row(_cell_path(out_dir, cells[i]), row)
        kernels.log_launches()
        if verbose and row.get("quarantined"):
            print(f"[sweep] {row['bench']}/{row['prefetcher']}"
                  f" frac={row.get('device_frac')} QUARANTINED"
                  f" after {row.get('retries')} retries", flush=True)

    kw = dict(cache_dir=cache_dir, device=device, verbose=verbose,
              record_timeline=record_timeline)
    in_process = not out_dir and workers <= 1
    lane_pending = pending if in_process else [
        i for i in pending if _wants_lanes(cells[i])]
    if lane_pending:
        # K1 lane batches in the driver (they are batched already: a pool
        # would only serialise them again); each row is persisted as it is
        # recorded, so a kill loses at most the batches in flight
        got = _run_cells([cells[i] for i in lane_pending],
                         lanes_only=not in_process,
                         record=lambda j, row: _record(lane_pending[j], row),
                         **kw)
        handled = {lane_pending[j] for j in got}
        pending = [i for i in pending if i not in handled]
    run_cell = functools.partial(simulate_cell, cache_dir=cache_dir,
                                 device=device,
                                 record_timeline=record_timeline)
    if pending and out_dir:
        # leased execution: every cell resolves to a persisted result or a
        # quarantine verdict, whatever crashes along the way
        if workers > 1:
            _lease_pool(cells, pending, out_dir, run_cell, workers, pol,
                        _record, verbose)
        else:
            for i in pending:
                _, row = _run_cell_leased(cells[i], out_dir, run_cell, pol)
                _record(i, row, persist=False)
    elif pending:
        with _mp_context().Pool(min(workers, len(pending)),
                                initializer=_init_worker,
                                initargs=(list(sys.path),)) as pool:
            for i, row in zip(pending, pool.imap(
                    run_cell, [cells[i] for i in pending])):
                _record(i, row)

    out = [rows[i] for i in range(len(cells))]
    if out_dir and write_aggregate:
        write_results(out, out_dir)
        _write_json_atomic(
            os.path.join(out_dir, "quarantine.json"),
            {"cells": [q for q in
                       (_read_json(_cell_path(out_dir, c) + ".quarantine")
                        for c in cells) if q is not None]})
    return out


def simulate_cell(cell: SweepCell, *, cache_dir: Optional[str] = None,
                  device: str = "cuda",
                  record_timeline: bool = False) -> Dict:
    """Run one cell in this process and return its row (:func:`run_sweep`
    on one cell, with no ``out_dir``: its solo replays and probes come with
    it).  With ``record_timeline`` the row carries the replay's
    per-transfer ``timeline`` as (cycle, bytes) pairs; K1 records none, so
    the cell replays on the NumPy engine."""
    return _run_cells([cell], cache_dir=cache_dir, device=device,
                      record_timeline=record_timeline)[0]


def _init_worker(path: List[str]) -> None:
    """Spawned children need the parent's ``sys.path`` (the repository is a
    src layout without installation)."""
    for p in reversed(path):
        if p not in sys.path:
            sys.path.insert(0, p)


# ---------------------------------------------------------------------------
# crash-safe cell store: checksummed envelopes, leases, attempts, quarantine
# ---------------------------------------------------------------------------

def _cell_path(out_dir: str, cell: SweepCell) -> str:
    return os.path.join(out_dir, "cells", f"{cell.key()}.json")


def write_cell_row(path: str, row: Dict) -> None:
    """Persist one result row as a checksummed, versioned envelope
    (``{_v, sha256, row}``) by atomic write-rename, in the reference's
    format: readers verify checksum and version, so a resumed sweep never
    loads a torn, corrupted or cross-version row as a finished cell."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    payload = json.dumps(row, sort_keys=True)
    doc = {"_v": SWEEP_VERSION,
           "sha256": hashlib.sha256(payload.encode()).hexdigest(),
           "row": row}
    key = os.path.basename(path)
    tmp = path + f".tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f, sort_keys=True)
    faults.fire("cell.result.write", key)    # kill here = torn write
    os.replace(tmp, path)
    faults.corrupt("cell.result.artifact", path, key)


def load_cell_row(path: str) -> Tuple[Optional[Dict], str]:
    """Load a persisted cell row: ``(row, "ok")`` or ``(None, reason)``
    with reason ``missing``, ``corrupt`` (torn JSON, checksum mismatch,
    truncation) or ``version`` (another ``SWEEP_VERSION``, or a flat row
    without an envelope)."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except FileNotFoundError:
        return None, "missing"
    except (ValueError, OSError, UnicodeDecodeError):
        return None, "corrupt"
    if not isinstance(doc, dict):
        return None, "corrupt"
    if doc.get("_v") != SWEEP_VERSION:
        return None, "version"
    row = doc.get("row")
    if not isinstance(row, dict):
        return None, "corrupt"
    payload = json.dumps(row, sort_keys=True)
    if hashlib.sha256(payload.encode()).hexdigest() != doc.get("sha256"):
        return None, "corrupt"
    return row, "ok"


def _read_json(path: str) -> Optional[Dict]:
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    return doc if isinstance(doc, dict) else None


def _write_json_atomic(path: str, doc: Dict) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + f".tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f, sort_keys=True)
    os.replace(tmp, path)


@dataclasses.dataclass(frozen=True)
class _ExecPolicy:
    """Knobs of the leased execution layer (the reference's
    ``REPRO_SWEEP_*`` variables, same names and defaults)."""

    max_attempts: int        # lease claims per cell before quarantine
    lease_ttl_s: float       # lease expiry for remote/unkillable owners
    backoff_base_s: float    # exponential backoff base between retries
    backoff_cap_s: float
    hb_timeout_s: float      # silent-worker termination threshold
    max_worker_restarts: int


def _env_num(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def _exec_policy(max_attempts: Optional[int] = None,
                 lease_ttl_s: Optional[float] = None) -> _ExecPolicy:
    return _ExecPolicy(
        max_attempts=int(max_attempts if max_attempts is not None
                         else _env_num("REPRO_SWEEP_MAX_ATTEMPTS", 4)),
        lease_ttl_s=float(lease_ttl_s if lease_ttl_s is not None
                          else _env_num("REPRO_SWEEP_LEASE_TTL", 300.0)),
        backoff_base_s=_env_num("REPRO_SWEEP_BACKOFF", 0.25),
        backoff_cap_s=30.0,
        # must exceed the slowest single cell (training included): a
        # heartbeat is written per cell attempt, not mid-cell
        hb_timeout_s=_env_num("REPRO_SWEEP_HB_TIMEOUT", 900.0),
        max_worker_restarts=int(_env_num("REPRO_SWEEP_MAX_RESTARTS", 16)),
    )


def _backoff_s(pol: _ExecPolicy, attempt: int) -> float:
    return min(pol.backoff_cap_s,
               pol.backoff_base_s * (2 ** max(attempt - 1, 0)))


def _bump_attempts(path: str, error: Optional[str] = None) -> int:
    """Record one more lease claim (or a failure message) for a cell.
    Called only while holding the cell's lease, so the read-modify-write
    has one writer; the write itself is atomic."""
    apath = path + ".attempts"
    doc = _read_json(apath) or {}
    doc["attempts"] = int(doc.get("attempts", 0)) + (0 if error else 1)
    errors = doc.get("errors")
    doc["errors"] = list(errors) if isinstance(errors, list) else []
    if error:
        doc["errors"].append(error)
    _write_json_atomic(apath, doc)
    return doc["attempts"]


def _quarantine_stub(cell: SweepCell, qdoc: Dict) -> Dict:
    """The row a quarantined cell contributes: its identity columns, every
    stat None, ``quarantined=True``."""
    row = cell.to_dict()
    row.pop("service_steps", None)
    for f in ROW_FIELDS:
        row.setdefault(f, None)
    row["retries"] = max(int(qdoc.get("attempts", 0)) - 1, 0)
    row["quarantined"] = True
    return row


def _attempt_cell(cell: SweepCell, out_dir: str,
                  run_cell: Callable[[SweepCell], Dict],
                  pol: _ExecPolicy) -> Tuple[str, Optional[Dict]]:
    """One non-blocking leased attempt at a cell: ``("done", row)``
    (computed now or found persisted), ``("quarantined", stub_row)``,
    ``("busy", None)`` (a live owner holds the lease) or ``("retry",
    attempt_no)`` after a failure to back off from.  A SIGKILL at any point
    leaves at most a stale lease (reclaimed by the dead-pid check) and a
    counted attempt."""
    path = _cell_path(out_dir, cell)
    row, reason = load_cell_row(path)
    if row is not None:
        return "done", row
    if reason in ("corrupt", "version"):
        quarantine_artifact(path, f"invalid persisted cell "
                            f"{cell.bench}/{cell.prefetcher} ({reason})")
    qdoc = _read_json(path + ".quarantine")
    if qdoc is not None:
        return "quarantined", _quarantine_stub(cell, qdoc)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    lease = path + ".lease"
    if not ft.try_acquire_lease(lease, pol.lease_ttl_s,
                                extra={"cell": cell.key()}):
        return "busy", None
    att = 0
    try:
        spent = int((_read_json(path + ".attempts") or {})
                    .get("attempts", 0))
        if spent >= pol.max_attempts:
            qdoc = _read_json(path + ".attempts") or {}
            qdoc.update(key=cell.key(), cell=cell.to_dict())
            _write_json_atomic(path + ".quarantine", qdoc)
            warnings.warn(
                f"cell {cell.bench}/{cell.prefetcher} "
                f"(eviction={cell.eviction}, frac={cell.device_frac}) "
                f"quarantined after {spent} attempts: "
                f"{qdoc.get('errors') or 'worker crashes'}",
                RuntimeWarning)
            return "quarantined", _quarantine_stub(cell, qdoc)
        att = _bump_attempts(path)
        faults.fire("cell.start", cell.key())
        row = run_cell(cell)
        row["retries"] = att - 1
        write_cell_row(path, row)
        return "done", row
    except Exception as e:
        _bump_attempts(path, error=repr(e))
        return "retry", att
    finally:
        ft.release_lease(lease)
        kernels.log_launches()


def _run_cell_leased(cell: SweepCell, out_dir: str,
                     run_cell: Callable[[SweepCell], Dict],
                     pol: _ExecPolicy) -> Tuple[str, Dict]:
    """Drive one cell to a result or a quarantine verdict, blocking through
    retries, backoff and foreign leases."""
    while True:
        status, payload = _attempt_cell(cell, out_dir, run_cell, pol)
        if status in ("done", "quarantined"):
            return status, payload
        if status == "retry":
            time.sleep(_backoff_s(pol, payload))
        else:                                  # busy: foreign live owner
            time.sleep(min(0.2, max(pol.lease_ttl_s / 10, 0.01)))


# ---------------------------------------------------------------------------
# the lease worker pool
# ---------------------------------------------------------------------------

def _heartbeat(hb_dir: str, wid: int, done_n: int) -> None:
    try:
        _write_json_atomic(os.path.join(hb_dir, f"w{wid}.json"),
                           {"ts": time.time(), "pid": os.getpid(),
                            "done": done_n})
    except OSError:  # pragma: no cover - hb dir vanished
        pass


def _lease_worker_main(sys_path: List[str], cells: List[SweepCell],
                       out_dir: str, run_cell: Callable[[SweepCell], Dict],
                       pol: _ExecPolicy, wid: int, hb_dir: str) -> None:
    """A lease worker: loops over the grid claiming unleased, unfinished
    cells until every cell is resolved; the rotated start keeps workers
    off each other's cells."""
    _init_worker(sys_path)
    n = len(cells)
    done = [False] * n
    rot = wid % max(n, 1)
    order = list(range(rot, n)) + list(range(rot))
    while not all(done):
        progressed = False
        for j in order:
            if done[j]:
                continue
            faults.fire("worker.loop", f"w{wid}")
            status, payload = _attempt_cell(cells[j], out_dir, run_cell,
                                            pol)
            if status in ("done", "quarantined"):
                done[j] = True
                progressed = True
            elif status == "retry":
                progressed = True
                time.sleep(_backoff_s(pol, payload))
            _heartbeat(hb_dir, wid, sum(done))
        if not progressed:
            time.sleep(0.05)


def _mp_context():
    """Worker processes always start by spawn: a parent that has
    initialised CUDA (the sweep driver after its K1 lane batches) cannot
    fork safely.  Cells are pure functions of their spec, so the rows are
    the same as the reference's forked workers give."""
    return multiprocessing.get_context("spawn")


def _lease_pool(cells: Sequence[SweepCell], pending: List[int],
                out_dir: str, run_cell: Callable[[SweepCell], Dict],
                workers: int, pol: _ExecPolicy, record,
                verbose: bool) -> None:
    """Supervise a pool of lease workers over the pending cells.

    The parent computes nothing: it collects finished cell files into
    ``record`` and runs the failure detection (a ``HeartbeatMonitor`` over
    the workers' heartbeat files): dead workers restart up to a budget,
    silent-but-alive workers are terminated so their leases free up.  If
    every worker spends its restart budget, the parent finishes the rest
    serially (attempts are bounded, so that ends, in quarantine at
    worst)."""
    sub = [cells[i] for i in pending]
    ctx = _mp_context()
    hb_dir = os.path.join(out_dir, "hb")
    os.makedirs(hb_dir, exist_ok=True)
    monitor = ft.HeartbeatMonitor(timeout_s=pol.hb_timeout_s)
    n_workers = min(workers, len(sub))

    def _spawn(wid: int):
        p = ctx.Process(target=_lease_worker_main,
                        args=(list(sys.path), sub, out_dir, run_cell, pol,
                              wid, hb_dir),
                        daemon=True)
        p.start()
        # grace window until the first beat; heartbeat files carry
        # time.time() stamps, so the monitor lives in wall-clock time
        monitor.beat(wid, 0.0, now=time.time())
        return p

    procs = {wid: _spawn(wid) for wid in range(n_workers)}
    restarts = {wid: 0 for wid in procs}
    last_hb: Dict[int, float] = {}
    unresolved = set(pending)
    try:
        while unresolved:
            for i in sorted(unresolved):
                path = _cell_path(out_dir, cells[i])
                row, _reason = load_cell_row(path)
                if row is not None:
                    record(i, row, persist=False)
                    unresolved.discard(i)
                    continue
                qdoc = _read_json(path + ".quarantine")
                if qdoc is not None:
                    record(i, _quarantine_stub(cells[i], qdoc),
                           persist=False)
                    unresolved.discard(i)
            if not unresolved:
                break
            now = time.time()
            for wid, p in procs.items():
                hb = _read_json(os.path.join(hb_dir, f"w{wid}.json"))
                if hb and isinstance(hb.get("ts"), (int, float)):
                    ts = float(hb["ts"])
                    if last_hb.get(wid) != ts:
                        monitor.beat(wid, ts - last_hb.get(wid, ts), now=ts)
                        last_hb[wid] = ts
                if p.is_alive() and wid in monitor.dead_hosts(now=now):
                    if verbose:
                        print(f"[sweep] worker {wid} silent for "
                              f">{pol.hb_timeout_s}s; terminating so its "
                              "lease frees up", flush=True)
                    p.terminate()
                    p.join(timeout=5)
                if not p.is_alive() and restarts[wid] \
                        < pol.max_worker_restarts:
                    restarts[wid] += 1
                    if verbose:
                        print(f"[sweep] worker {wid} died; restart "
                              f"{restarts[wid]}/{pol.max_worker_restarts}",
                              flush=True)
                    procs[wid] = _spawn(wid)
            if all(not p.is_alive() for p in procs.values()):
                for i in sorted(unresolved):
                    _, row = _run_cell_leased(cells[i], out_dir, run_cell,
                                              pol)
                    record(i, row, persist=False)
                unresolved.clear()
                break
            time.sleep(0.05)
    finally:
        for p in procs.values():
            if p.is_alive():
                p.terminate()
            p.join(timeout=10)


# ---------------------------------------------------------------------------
# structured results
# ---------------------------------------------------------------------------

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


def read_results(out_dir: str) -> List[Dict]:
    """The aggregate rows.  A missing or corrupt ``results.json`` falls
    back to the per-cell store (checksum-valid, current-version cells
    only) with a warning."""
    try:
        with open(os.path.join(out_dir, "results.json")) as f:
            doc = json.load(f)
        rows = doc["rows"]
        if not isinstance(rows, list):
            raise ValueError("aggregate rows is not a list")
        return rows
    except (OSError, ValueError, KeyError, TypeError) as e:
        cell_dir = os.path.join(out_dir, "cells")
        if not os.path.isdir(cell_dir):
            raise
        warnings.warn(f"aggregate results.json unreadable ({e!r}); "
                      "rebuilding from the per-cell store", RuntimeWarning)
        rows = []
        for fname in sorted(os.listdir(cell_dir)):
            if not fname.endswith(".json"):
                continue
            row, _reason = load_cell_row(os.path.join(cell_dir, fname))
            if row is not None:
                rows.append(row)
        return rows


def read_results_csv(path: str) -> List[Dict]:
    """CSV round trip: numeric columns come back as numbers, ``True`` and
    ``False`` as booleans, empty and ``None`` as None."""
    out = []
    with open(path, newline="") as f:
        for row in csv.DictReader(f):
            parsed: Dict = {}
            for k, v in row.items():
                if v == "" or v == "None":
                    parsed[k] = None
                    continue
                if v in ("True", "False"):
                    parsed[k] = v == "True"
                    continue
                try:
                    fv = float(v)
                    parsed[k] = int(fv) if fv.is_integer() and "." not in v \
                        else fv
                except ValueError:
                    parsed[k] = v
            out.append(parsed)
    return out


def main(argv: Optional[List[str]] = None) -> None:
    from repro_torch.offload.serve_trace import (SERVE_WORKLOADS,
                                                 is_serve_bench)
    from repro_torch.traces.generators import BENCHMARKS
    from repro_torch.traces.interleave import is_mt_bench
    ap = argparse.ArgumentParser(
        description="Batched UVM sweep on the port (K1 lane batches, the "
                    "NumPy engine where K1 declines)")
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
                         "flags; --engine/--backend still apply")
    ap.add_argument("--engine", default="auto", choices=list(ENGINES),
                    help="replay style: auto/vectorized take the backend "
                         "chain, legacy forces the per-access loop")
    ap.add_argument("--backend", default="cuda", choices=list(BACKENDS),
                    help="first backend of each cell's chain: cuda or auto "
                         "(K1 lane batches, then the NumPy engine for the "
                         "cells K1 declines, then legacy) or numpy")
    ap.add_argument("--steps", type=int, default=150,
                    help="predictor training steps of learned cells")
    ap.add_argument("--device", default="cuda",
                    help="torch device of training, inference and replay")
    ap.add_argument("--out", default=None,
                    help="results directory: cells persist there and a "
                         "rerun resumes")
    ap.add_argument("--workers", type=int, default=1,
                    help="lease workers (spawned processes) for the cells "
                         "that do not replay in K1 lane batches")
    ap.add_argument("--no-resume", action="store_true",
                    help="recompute every cell of --out")
    args = ap.parse_args(argv)

    if args.scenario:
        from repro_torch.uvm.scenarios import (available_scenarios,
                                               expand_scenario)
        try:
            cells = expand_scenario(args.scenario, engine=args.engine,
                                    backend=args.backend)
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
            engine=args.engine, backend=args.backend,
            service_steps=args.steps)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda but no CUDA device is available "
                 "(pass --device cpu to run the plain versions)")
    t0 = time.time()
    rows = run_sweep(cells, out_dir=args.out, workers=args.workers,
                     resume=not args.no_resume, device=args.device,
                     verbose=True)
    per_backend = collections.Counter(r["backend"] for r in rows
                                      if not r.get("quarantined"))
    n_quar = sum(1 for r in rows if r.get("quarantined"))
    print(f"\n{len(rows)} cells in {time.time() - t0:.1f}s; rows per "
          f"backend {dict(per_backend)}"
          + (f" [{n_quar} QUARANTINED - see quarantine.json]"
             if n_quar else ""))
    cols = ["bench", "prefetcher", "device_frac", "eviction", "backend",
            "hit_rate", "ipc", "unity"]
    print(",".join(cols))
    for r in rows:
        print(",".join(f"{r[c]:.4f}" if isinstance(r[c], float) else str(r[c])
                       for c in cols))


if __name__ == "__main__":
    main()
