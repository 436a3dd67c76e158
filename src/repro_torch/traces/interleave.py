"""Multi-tenant trace interleaver: two benchmarks sharing one device.

Shared-virtual-memory studies (arXiv 2405.06811) show that interference
between diverse co-resident applications dominates paging behavior — an
axis the paper's one-benchmark-at-a-time evaluation never exercises.
This module zips two benchmark traces into ONE access stream so the UVM
replay sees what a multi-tenant deployment sees: two working sets
contending for a single device memory.

A multi-tenant bench is named ``"<A>+<B>"`` (e.g. ``"ATAX+Pathfinder"``);
:func:`is_mt_bench` is the routing predicate (mirroring
``repro.offload.serve_trace.is_serve_bench``) and :func:`build_mt_trace`
the pure builder the sweep's ``load_trace`` dispatches to.

Construction:

* **Disjoint page regions** — each component trace is rebased (root-window
  aligned, so the tree prefetcher's 2 MB root structure is preserved) into
  its own region: tenant 0 at a seeded 2 MB-aligned base, tenant 1
  immediately above tenant 0's span plus one guard root window.  The
  region *boundary* page is the whole tenancy encoding: the tenant of any
  access is simply ``page >= boundary``, which stays correct through
  window splits, npz cache round-trips, and dense-span rebasing inside
  the replay engines.
* **Clock-proportional interleave** — accesses merge in the order of
  their per-tenant progress fractions (access ``i`` of an ``n_a``-long
  trace sorts at key ``(i+1)*n_b`` against ``(j+1)*n_a``), so a long
  tenant dribbles between a short tenant's accesses the way two
  concurrently running kernels would, with tenant 0 winning exact ties.
  The merge is deterministic: no RNG beyond the seeded base placement.

The ``trace.meta["mt"]`` sidecar carries only JSON-safe scalars
(component names + the boundary) so cached npz traces round-trip it
losslessly.  Per-tenant access counts and streams are always *derived*
from pages vs. the boundary — never stored — so they remain correct on
any slice of the trace.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.traces.trace import ROOT_PAGES, Trace, concat_streams

#: separator of a multi-tenant bench name ("ATAX+Pathfinder")
MT_SEPARATOR = "+"

#: number of tenants an interleaved trace carries (the replay engines
#: support exactly two; a deeper mix is future work)
N_TENANTS = 2


def split_mt_bench(name: str) -> Optional[Tuple[str, str]]:
    """``"A+B"`` -> ``("A", "B")`` when both halves are known GPU
    benchmarks, else None (serve workloads and nested mixes excluded)."""
    if not isinstance(name, str) or MT_SEPARATOR not in name:
        return None
    parts = name.split(MT_SEPARATOR)
    if len(parts) != 2 or not all(parts):
        return None
    from repro_torch.traces.generators import BENCHMARKS
    if not all(p in BENCHMARKS for p in parts):
        return None
    return parts[0], parts[1]


def is_mt_bench(name: str) -> bool:
    """True for multi-tenant bench-pair names like ``"ATAX+Pathfinder"``."""
    return split_mt_bench(name) is not None


def _rebase(pages: np.ndarray, base: int) -> Tuple[np.ndarray, int]:
    """Shift a page stream so its root-aligned floor lands on ``base``
    (itself root-aligned), preserving every in-root-window offset; returns
    the shifted stream and its exclusive root-aligned span end."""
    lo = (int(pages.min()) // ROOT_PAGES) * ROOT_PAGES
    shifted = pages.astype(np.int64) + (base - lo)
    end = int(shifted.max()) + 1
    end = ((end + ROOT_PAGES - 1) // ROOT_PAGES) * ROOT_PAGES
    return shifted, end


def build_mt_trace(bench: str, scale: float = 1.0, seed: int = 0) -> Trace:
    """Build one interleaved multi-tenant trace for ``"<A>+<B>"``.

    Pure function of (bench, scale, seed) — the sweep's npz trace cache
    and the golden fixtures rely on that determinism.
    """
    parts = split_mt_bench(bench)
    if parts is None:
        raise ValueError(f"not a multi-tenant bench name: {bench!r} "
                         f"(expected '<A>{MT_SEPARATOR}<B>' with both "
                         "halves GPU benchmarks)")
    from repro_torch.traces import GPUModel, generate_benchmark
    from repro_torch.traces.gpu_model import GPUModelConfig
    traces = [GPUModel(GPUModelConfig(seed=seed)).run(
        generate_benchmark(p, scale=scale, seed=seed)) for p in parts]

    # seeded 2MB-aligned base for tenant 0 (same idiom as serve_trace);
    # tenant 1 starts one guard root window above tenant 0's span
    base_rng = np.random.default_rng([seed, 0x17E2])
    base0 = int(base_rng.integers(1 << 10, 1 << 18)) * ROOT_PAGES
    pages0, end0 = _rebase(np.asarray(traces[0].pages), base0)
    boundary = end0 + ROOT_PAGES
    pages1, _ = _rebase(np.asarray(traces[1].pages), boundary)

    rec0 = traces[0].accesses.copy()
    rec1 = traces[1].accesses.copy()
    rec0["page"] = pages0
    rec1["page"] = pages1

    # clock-proportional merge: sort by per-tenant progress fraction
    # (i+1)/n_a vs (j+1)/n_b on a common integer grid; the stable sort
    # over [tenant0 block, tenant1 block] breaks exact ties tenant0-first
    na, nb = len(rec0), len(rec1)
    keys = np.concatenate([
        (np.arange(1, na + 1, dtype=np.int64)) * nb,
        (np.arange(1, nb + 1, dtype=np.int64)) * na,
    ])
    order = np.argsort(keys, kind="stable")
    accesses = concat_streams([rec0, rec1])[order]

    array_bases: Dict[str, int] = {}
    array_pages: Dict[str, int] = {}
    for t, (part, tr, shifted) in enumerate(
            zip(parts, traces, (pages0, pages1))):
        delta = int(shifted[0]) - int(np.asarray(tr.pages)[0])
        for aname, abase in tr.array_bases.items():
            array_bases[f"t{t}/{part}/{aname}"] = int(abase) + delta
            array_pages[f"t{t}/{part}/{aname}"] = \
                int(tr.array_pages[aname])

    return Trace(
        name=bench,
        accesses=accesses,
        array_bases=array_bases,
        array_pages=array_pages,
        n_instructions=sum(t.n_instructions for t in traces),
        meta={"mt": {"benches": list(parts), "tenants": N_TENANTS,
                     "boundary": int(boundary)}},
    )


# ---------------------------------------------------------------------------
# derived tenancy views (always computed from pages vs. the boundary, so
# they stay correct on window-split or otherwise sliced traces)
# ---------------------------------------------------------------------------

def mt_meta(trace: Trace) -> Optional[Dict]:
    """The ``meta["mt"]`` sidecar, or None for single-tenant traces."""
    if trace.meta and isinstance(trace.meta.get("mt"), dict):
        return trace.meta["mt"]
    return None


def tenant_boundary(trace: Trace) -> Optional[int]:
    """Absolute page index where tenant 1's region begins (None when the
    trace is single-tenant)."""
    mt = mt_meta(trace)
    return int(mt["boundary"]) if mt else None


def tenant_stream(trace: Trace) -> Optional[np.ndarray]:
    """Per-access tenant ids as int8 (the pallas lanes feed this stream
    into the kernel verbatim), or None for single-tenant traces."""
    boundary = tenant_boundary(trace)
    if boundary is None:
        return None
    return (np.asarray(trace.pages) >= boundary).astype(np.int8)


def tenant_counts(trace: Trace) -> Optional[Tuple[int, int]]:
    """Per-tenant access counts of (this slice of) the trace."""
    stream = tenant_stream(trace)
    if stream is None:
        return None
    n1 = int(stream.sum())
    return len(stream) - n1, n1


def tenant_last_index(trace: Trace) -> Optional[Tuple[int, int]]:
    """Index of each tenant's last access (-1 when a tenant has none)."""
    stream = tenant_stream(trace)
    if stream is None:
        return None
    out = []
    for t in range(N_TENANTS):
        idx = np.nonzero(stream == t)[0]
        out.append(int(idx[-1]) if idx.size else -1)
    return out[0], out[1]


def mt_component_trace(trace: Trace, tenant: int) -> Trace:
    """One tenant's accesses extracted as a standalone trace (pages kept
    in the tenant's rebased region) — the *solo replay* the sweep's
    interference-slowdown column compares against."""
    stream = tenant_stream(trace)
    if stream is None:
        raise ValueError(f"{trace.name!r} is not a multi-tenant trace")
    mt = mt_meta(trace)
    mask = stream == tenant
    prefix = f"t{tenant}/"
    meta = {k: v for k, v in trace.meta.items() if k != "mt"}
    return dataclasses.replace(
        trace,
        name=f"{mt['benches'][tenant]}@t{tenant}",
        accesses=trace.accesses[mask],
        array_bases={k: v for k, v in trace.array_bases.items()
                     if k.startswith(prefix)},
        array_pages={k: v for k, v in trace.array_pages.items()
                     if k.startswith(prefix)},
        n_instructions=max(1, int(trace.n_instructions
                                  * mask.sum() / max(len(stream), 1))),
        meta=meta,
    )
