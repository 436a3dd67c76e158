"""The plain reference of a sweep pass, and the comparison that decides
``correct``.

It imports nothing of the program.  From the configuration, the traffic
mix and the seed alone it expands the grid, generates every trace again
with its frozen copy of the trace generators and GPU model, and replays a
sample of the grid's cells, drawn from the seed, on its frozen copy of the
legacy per-access engine (``uvmbench.reference.uvm.simulator``): the
prefetch and eviction decisions, the counters, the clock, and on a
two-tenant pair the step clocks at each tenant's last access and each
tenant's solo replay behind the slowdown columns.  The replays run in a
pool of spawned host processes.

Its readings, which the harness compares with the configuration's
``limits``:

* ``mismatches``: facts that must be equal and are not: a trace's length,
  instruction count or pages (one each), and the integer and identity
  fields of the sampled rows (a missing row counts every field);
* ``float_rel_gap``: the widest relative gap of a float field (cycles,
  IPC, PCIe bytes, the rates, the slowdowns) of the sampled rows.
"""
from __future__ import annotations

import functools
import json
import multiprocessing
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

ID_FIELDS = ("bench", "prefetcher", "scale", "seed", "window",
             "device_frac", "eviction", "capacity_split")
INT_FIELDS = ("device_pages", "n_accesses", "n_instructions", "hits",
              "late", "faults", "prefetch_issued", "prefetch_used",
              "pages_migrated", "pages_evicted", "tenants")
FLOAT_FIELDS = ("cycles", "ipc", "hit_rate", "accuracy", "coverage",
                "unity", "pcie_bytes", "hit_rate_t0", "hit_rate_t1",
                "slowdown_t0", "slowdown_t1", "interference_slowdown")
#: the clock types: the configuration's, and the control's one step below
CLOCK_TYPES = {"float64": float, "float32": np.float32}
#: salts of the random streams drawn from ``--seed``: the grid's order and
#: the sample of rows checked
ORDER_SALT = 0x0D3E
SAMPLE_SALT = 0x5A3B


def grid(config: Dict, traffic: Dict, seed: int) -> List[Dict]:
    """The grid's cells in the order the sweep's rows come back: the product
    of the axes, the last fastest, permuted by the seed's order stream."""
    cells = []
    for bench in config["benches"]:
        for ratio in traffic["ratios"]:
            for eviction in traffic["evictions"]:
                for split in traffic["capacity_splits"]:
                    for pf in traffic["prefetchers"]:
                        cells.append({
                            "bench": bench, "prefetcher": pf,
                            "scale": float(config["scale"]),
                            "seed": int(config["trace_seed"]),
                            "window": config["window"],
                            "device_frac": float(ratio),
                            "eviction": eviction, "capacity_split": split})
    order = np.random.default_rng([int(seed) % 2 ** 64,
                                   ORDER_SALT]).permutation(
        len(cells))
    return [cells[i] for i in order]


def draw_sample(cells: Sequence[Dict], n_passes: int, seed: int,
                per_group: int) -> List[Tuple[int, int]]:
    """(pass, cell) pairs to check: ``per_group`` cells of each (prefetcher,
    eviction, split) group, each from a pass, all drawn from the seed."""
    rng = np.random.default_rng([int(seed) % 2 ** 64, SAMPLE_SALT])
    groups: Dict[Tuple, List[int]] = {}
    for i, c in enumerate(cells):
        key = (c["prefetcher"], c["eviction"], str(c["capacity_split"]))
        groups.setdefault(key, []).append(i)
    out = []
    for key in sorted(groups):
        members = groups[key]
        take = rng.choice(len(members), size=min(per_group, len(members)),
                          replace=False)
        for k in sorted(int(t) for t in take):
            out.append((int(rng.integers(max(n_passes, 1))), members[k]))
    return sorted(out, key=lambda pc: (pc[1], pc[0]))


# ---------------------------------------------------------------------------
# the reference's replays (run in the pool's workers)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=16)
def _trace(bench: str, scale: float, seed: int, window: Optional[float]):
    from uvmbench.reference.traces import GPUModel, generate_benchmark
    from uvmbench.reference.traces.gpu_model import GPUModelConfig
    from uvmbench.reference.traces.interleave import (build_mt_trace,
                                                      is_mt_bench)
    if is_mt_bench(bench):
        trace = build_mt_trace(bench, scale=scale, seed=seed)
    else:
        spec = generate_benchmark(bench, scale=scale, seed=seed)
        trace = GPUModel(GPUModelConfig(seed=seed)).run(spec)
    if window is not None:
        trace, _ = trace.split(window)
    return trace


def _uvm_config(uvm: Dict, **kw):
    from uvmbench.reference.uvm.config import UVMConfig
    return UVMConfig(**{**uvm, **kw})


def _prefetcher(name: str, trace):
    from uvmbench.reference.uvm import prefetchers as pf
    if name == "oracle":
        return pf.OraclePrefetcher(np.asarray(trace.pages))
    kinds = {"none": pf.NoPrefetcher, "block": pf.BlockPrefetcher,
             "tree": pf.TreePrefetcher}
    if name not in kinds:
        raise ValueError(f"the reference replays no {name!r} prefetcher")
    return kinds[name]()


def _split(split: Optional[str]) -> Optional[Tuple[float, float]]:
    if split is None or split == "shared":
        return None
    a, b = split.split("/")
    return float(a), float(b)


@functools.lru_cache(maxsize=64)
def _solo_cycles(bench: str, scale: float, seed: int, window, tenant: int,
                 capacity: Optional[int], prefetcher: str, eviction: str,
                 uvm_json: str, clock: str) -> int:
    """Cycles of one tenant's accesses replayed alone at ``capacity``."""
    from uvmbench.reference.traces.interleave import mt_component_trace
    from uvmbench.reference.uvm.simulator import UVMSimulator
    solo = mt_component_trace(_trace(bench, scale, seed, window), tenant)
    cfg = _uvm_config(json.loads(uvm_json), device_pages=capacity,
                      eviction=eviction)
    stats = UVMSimulator(cfg, clock_dtype=CLOCK_TYPES[clock]).run(
        solo, _prefetcher(prefetcher, solo))
    return int(stats.cycles)


def reference_row(cell: Dict, uvm: Dict, clock: str = "float64") -> Dict:
    """The row the sweep must give for ``cell``, worked out from scratch."""
    from uvmbench.reference.traces.interleave import (N_TENANTS, mt_meta,
                                                      tenant_last_index)
    from uvmbench.reference.uvm.simulator import UVMSimulator
    trace = _trace(cell["bench"], cell["scale"], cell["seed"],
                   cell["window"])
    frac = cell["device_frac"]
    device_pages = (int(trace.working_set_pages * frac)
                    if frac is not None else None)
    fracs = _split(cell["capacity_split"])
    tenant_pages = (None if fracs is None else
                    (int(fracs[0] * device_pages),
                     int(fracs[1] * device_pages)))
    cfg = _uvm_config(uvm, device_pages=device_pages,
                      eviction=cell["eviction"], tenant_pages=tenant_pages)
    last = tenant_last_index(trace)
    bounds = (None if last is None else
              np.asarray(sorted({i + 1 for i in last if i >= 0}),
                         dtype=np.int64))
    st = UVMSimulator(cfg, clock_dtype=CLOCK_TYPES[clock]).run(
        trace, _prefetcher(cell["prefetcher"], trace), step_bounds=bounds)
    row = dict(cell)
    row.update(
        device_pages=device_pages, eviction=st.eviction,
        n_accesses=st.n_accesses, n_instructions=st.n_instructions,
        cycles=st.cycles, ipc=st.ipc, hits=st.hits, late=st.late,
        faults=st.faults, hit_rate=st.hit_rate,
        prefetch_issued=st.prefetch_issued,
        prefetch_used=st.prefetch_used, accuracy=st.accuracy,
        coverage=st.coverage, unity=st.unity,
        pages_migrated=st.pages_migrated, pages_evicted=st.pages_evicted,
        pcie_bytes=st.pcie_bytes)
    for f in ("tenants", "hit_rate_t0", "hit_rate_t1", "slowdown_t0",
              "slowdown_t1", "interference_slowdown"):
        row[f] = None
    if mt_meta(trace) is None:
        return row
    row["tenants"] = N_TENANTS
    row["capacity_split"] = cell["capacity_split"] or "shared"
    th, ta = st.tenant_hits, st.tenant_accesses
    for t in range(N_TENANTS):
        row[f"hit_rate_t{t}"] = (th[t] / ta[t]) if ta and ta[t] else None
    clock_at = {int(b): float(c) for b, c in zip(bounds, st.step_clocks)}
    slowdowns = []
    uvm_json = json.dumps(uvm, sort_keys=True)
    for t in range(N_TENANTS):
        if last[t] < 0:
            continue
        capacity = tenant_pages[t] if tenant_pages else device_pages
        solo = _solo_cycles(cell["bench"], cell["scale"], cell["seed"],
                            cell["window"], t, capacity, cell["prefetcher"],
                            cfg.eviction, uvm_json, clock)
        sd = clock_at[last[t] + 1] / solo if solo > 0 else None
        row[f"slowdown_t{t}"] = sd
        if sd is not None:
            slowdowns.append(sd)
    row["interference_slowdown"] = max(slowdowns) if slowdowns else None
    return row


def trace_facts(bench: str, scale: float, seed: int, window) -> Dict:
    """What the comparison reads of a trace: its length, instruction count
    and a digest of its pages."""
    import hashlib
    trace = _trace(bench, scale, seed, window)
    return {"n_accesses": int(len(trace.pages)),
            "n_instructions": int(trace.n_instructions),
            "sha256": hashlib.sha256(np.ascontiguousarray(
                trace.pages, dtype=np.int64).tobytes()).hexdigest()}


def _work(task: Tuple) -> Tuple:
    kind, key, args = task
    if kind == "trace":
        return kind, key, trace_facts(*args)
    return kind, key, reference_row(*args)


def _cost(task: Tuple) -> int:
    """Longest first: tree and oracle replays, two-tenant quota cells."""
    kind, _, args = task
    if kind == "trace":
        return 9
    cell = args[0]
    rank = {"tree": 0, "oracle": 2}.get(cell["prefetcher"], 4)
    return rank - (1 if _split(cell["capacity_split"]) else 0)


def run_tasks(tasks: List[Tuple], workers: int) -> List[Tuple]:
    """Run the reference's tasks, in a pool of spawned processes when
    ``workers > 1``; the pool is closed and joined before this returns."""
    tasks = sorted(tasks, key=_cost)
    if workers <= 1:
        return [_work(t) for t in tasks]
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(min(workers, len(tasks))) as pool:
        out = list(pool.imap_unordered(_work, tasks, chunksize=1))
        pool.close()
        pool.join()
    return out


def default_workers() -> int:
    """The host's cores less one for the process that waits on them."""
    try:
        n = len(os.sched_getaffinity(0))
    except AttributeError:
        n = os.cpu_count() or 2
    return max(1, n - 1)


def _rel_gap(a, b) -> float:
    a, b = float(a), float(b)
    if a == b:
        return 0.0
    return abs(a - b) / max(abs(b), 1e-12)


def compare_row(got: Optional[Dict], want: Dict) -> Tuple[int, float]:
    """(mismatched identity and integer fields, widest float gap)."""
    if got is None:
        return len(ID_FIELDS) + len(INT_FIELDS) + len(FLOAT_FIELDS), 0.0
    bad, gap = 0, 0.0
    for f in ID_FIELDS + INT_FIELDS:
        if got.get(f) != want.get(f):
            bad += 1
    for f in FLOAT_FIELDS:
        a, b = got.get(f), want.get(f)
        if a is None or b is None:
            bad += (a is None) != (b is None)
            continue
        g = _rel_gap(a, b)
        gap = max(gap, g if np.isfinite(g) else 1e300)
    return bad, gap


def check(config: Dict, traffic: Dict, seed: int,
          passes: Sequence[Sequence[Dict]], traces: Dict[str, Dict], *,
          workers: Optional[int] = None) -> Tuple[Dict[str, float], Dict]:
    """Judge the window's rows and traces against the reference.

    Returns the readings (``mismatches``, ``float_rel_gap``) and facts
    about the check (``trace_mismatch`` and ``counter_mismatch``, the two
    parts of ``mismatches``; ``rows_failed``: sampled rows with any field
    off its limit; ``sampled``, ``seconds``, ``workers``)."""
    t0 = time.perf_counter()
    cells = grid(config, traffic, seed)
    sample = draw_sample(cells, len(passes), seed,
                         int(traffic["check_per_group"]))
    uvm = config["uvm"]
    tasks = [("trace", b, (b, float(config["scale"]),
                           int(config["trace_seed"]), config["window"]))
             for b in dict.fromkeys(c["bench"] for c in cells)]
    tasks += [("row", i, (cells[i], uvm))
              for i in sorted({i for _, i in sample})]
    workers = default_workers() if workers is None else workers
    done = run_tasks(tasks, workers)
    ref_traces = {k: v for kind, k, v in done if kind == "trace"}
    ref_rows = {k: v for kind, k, v in done if kind == "row"}

    trace_bad = sum(sum(1 for k, v in facts.items()
                        if (traces.get(b) or {}).get(k) != v)
                    for b, facts in ref_traces.items())
    limit = float(config["limits"]["float_rel_gap"])
    bad_fields, widest, failed = 0, 0.0, 0
    for p, i in sample:
        rows = passes[p] if p < len(passes) else []
        got = rows[i] if i < len(rows) else None
        bad, gap = compare_row(got, ref_rows[i])
        bad_fields += bad
        widest = max(widest, gap)
        failed += bool(bad or gap > limit)
    readings = {"mismatches": trace_bad + bad_fields,
                "float_rel_gap": widest}
    info = {"trace_mismatch": trace_bad, "counter_mismatch": bad_fields,
            "rows_failed": failed, "sampled": len(sample),
            "seconds": time.perf_counter() - t0,
            "workers": min(workers, len(tasks))}
    return readings, info
