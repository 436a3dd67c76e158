"""Adaptive eviction: the ``adaptive`` pseudo-policy and its resolvers,
ported from the reference ``repro.uvm.adaptive``.

No single eviction policy wins across benchmarks (arXiv 2204.02974), so a
grid or scenario may request ``eviction="adaptive"``: the sweep resolves it
to a concrete policy per cell before the cell's replay config exists, and
the row's ``eviction`` column records the resolved policy, never the
literal ``adaptive``.

Resolution order, as in the reference:

1. **Selector table** (``REPRO_ADAPTIVE_TABLE``: path to a JSON
   ``{bench: policy}`` mapping, or ``{"selector": {...}}``, e.g. distilled
   from a scenario matrix's rows by :func:`selector_from_rows`).
2. **Probe replay**: a replay of the cell's trace prefix (its first
   :data:`PROBE_ACCESSES` accesses) under every concrete policy, at a
   capacity that keeps the cell's oversubscription ratio, under a proxy of
   the cell's prefetcher (:func:`probe_proxy`); the cheapest in cycles wins,
   ties broken by ``(cycles, policy index)``.  Memoized per (trace content,
   capacity, probe length, proxy family).
3. **No eviction pressure** (capacity absent or >= working set): ``lru``.

One departure, deliberate: the reference replays its probes on its NumPy
engine, one at a time; the port replays them as K1 lanes, every probe a
grid needs in one backend call (:func:`resolve_all`), which packs them
into one lane batch per (proxy family, policy).  K1's cycles equal the
legacy engine's, so the choice is the same.  A probe K1 declines (a prefix
whose page span is past K1's ceiling) replays through
``replay_core.dispatch`` on the NumPy engine, as every reference probe
does.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.uvm.eviction import EVICTION_POLICIES, validate_policy

#: the pseudo-policy name accepted by sweep grids and scenarios
ADAPTIVE_POLICY = "adaptive"

#: accesses replayed per policy by the probe resolver
PROBE_ACCESSES = 20000

#: probe memo: (trace content, capacity, probe accesses, proxy) ->
#: (chosen policy, cycles per policy in ``EVICTION_POLICIES`` order)
_MEMO: Dict[Tuple, Tuple[str, Tuple[float, ...]]] = {}


def is_adaptive(policy: Optional[str]) -> bool:
    return policy == ADAPTIVE_POLICY


def clear_memo() -> None:
    """Drop the probe memo and the parsed-table cache (tests)."""
    _MEMO.clear()
    _TABLE_CACHE.clear()


def selector_from_rows(rows: Iterable[Dict]) -> Dict[str, str]:
    """Distill sweep/scenario result rows into a ``{bench: policy}``
    selector: per benchmark, the concrete policy with the lowest mean
    ``cycles`` across its rows (ties break in ``EVICTION_POLICIES``
    order)."""
    sums: Dict[Tuple[str, str], Tuple[int, int]] = {}
    for row in rows:
        pol = row.get("eviction")
        if pol not in EVICTION_POLICIES or row.get("cycles") is None:
            continue
        k = (row["bench"], pol)
        total, n = sums.get(k, (0, 0))
        sums[k] = (total + int(row["cycles"]), n + 1)
    out: Dict[str, str] = {}
    for bench in sorted({b for b, _ in sums}):
        scored = [(sums[(bench, p)][0] / sums[(bench, p)][1], i, p)
                  for i, p in enumerate(EVICTION_POLICIES)
                  if (bench, p) in sums]
        out[bench] = min(scored)[2]
    return out


#: parsed selector tables keyed by (path, mtime_ns): re-read only when the
#: file changes on disk
_TABLE_CACHE: Dict[Tuple[str, int], Dict[str, str]] = {}


def _table() -> Dict[str, str]:
    path = os.environ.get("REPRO_ADAPTIVE_TABLE")
    if not path:
        return {}
    try:
        mtime = os.stat(path).st_mtime_ns
    except OSError as e:
        raise FileNotFoundError(
            f"REPRO_ADAPTIVE_TABLE points at an unreadable selector "
            f"table {path!r} ({e}); unset the variable or fix the path "
            "(the table format is the JSON written by "
            "'python -m repro_torch.uvm.adaptive')") from e
    key = (path, mtime)
    hit = _TABLE_CACHE.get(key)
    if hit is not None:
        return hit
    with open(path) as f:
        doc = json.load(f)
    if isinstance(doc, dict) and isinstance(doc.get("selector"), dict):
        doc = doc["selector"]
    table = {str(b): validate_policy(p) for b, p in doc.items()}
    _TABLE_CACHE.clear()              # one live table at a time
    _TABLE_CACHE[key] = table
    return table


#: probe prefetcher proxy per cell prefetcher family: ``learned`` probes
#: under an oracle over the prefix (training inside a probe would cost more
#: than the cell)
_PROBE_PROXIES = {"none": "none", "block": "block", "tree": "tree",
                  "oracle": "oracle", "learned": "oracle"}


def probe_proxy(prefetcher: Optional[str]) -> str:
    """The proxy family a cell's prefetcher probes under (also a memo key
    component, so oracle and learned cells share one probe)."""
    return _PROBE_PROXIES.get(prefetcher or "none", "none")


def _probe_prefetcher(proxy: str, prefix):
    from repro_torch.uvm.prefetchers import (BlockPrefetcher, NoPrefetcher,
                                             OraclePrefetcher, TreePrefetcher)
    if proxy == "block":
        return BlockPrefetcher()
    if proxy == "tree":
        return TreePrefetcher()
    if proxy == "oracle":
        return OraclePrefetcher(np.asarray(prefix.pages))
    return NoPrefetcher()


def probe_requests(trace, device_pages: int,
                   probe_accesses: int = PROBE_ACCESSES,
                   proxy: str = "none") -> List:
    """One replay request per concrete policy (``EVICTION_POLICIES``
    order): the prefix of ``trace`` under the proxy prefetcher, at a
    capacity that keeps the cell's oversubscription ratio."""
    from repro_torch.uvm.config import UVMConfig
    from repro_torch.uvm.replay_core import ReplayRequest
    n = len(trace.accesses)
    prefix = trace
    if n > probe_accesses:
        prefix = trace.split(probe_accesses / n)[0]
    ratio = device_pages / trace.working_set_pages
    probe_pages = max(1, int(prefix.working_set_pages * ratio))
    return [ReplayRequest(prefix, _probe_prefetcher(proxy, prefix),
                          UVMConfig(device_pages=probe_pages, eviction=p))
            for p in EVICTION_POLICIES]


def pick(cycles: Sequence[float]) -> str:
    """The cheapest policy of one probe, ties broken by policy index."""
    return min(zip(cycles, range(len(cycles)), EVICTION_POLICIES))[2]


def _memo_key(trace, device_pages: int, probe_accesses: int,
              prefetcher: Optional[str]) -> Tuple:
    from repro_torch.uvm import predcache
    return (predcache.trace_content_key(trace), device_pages, probe_accesses,
            probe_proxy(prefetcher))


def probed(trace, device_pages: int, prefetcher: Optional[str] = None,
           probe_accesses: int = PROBE_ACCESSES
           ) -> Optional[Tuple[str, Tuple[float, ...]]]:
    """The memoized probe of one cell: (chosen policy, cycles per policy),
    or None if it never ran."""
    return _MEMO.get(_memo_key(trace, device_pages, probe_accesses,
                               prefetcher))


def resolve_all(jobs: Iterable[Tuple], probe_accesses: int = PROBE_ACCESSES,
                device: str = "cuda") -> List[str]:
    """Resolve many cells' eviction policies at once.  ``jobs`` holds one
    ``(policy, bench, trace, device_pages, prefetcher)`` per cell; every
    probe the memo lacks that K1 accepts runs as a K1 lane in one backend
    call (on ``device``: the kernel on CUDA, its plain version on the CPU),
    and every other one down the chain through ``dispatch``."""
    from repro_torch.uvm.replay_core import dispatch, get_backend
    choices: List[Optional[str]] = []
    keys: List[Optional[Tuple]] = []
    pending: Dict[Tuple, List] = {}
    for policy, bench, trace, device_pages, prefetcher in jobs:
        choice, key = None, None
        if not is_adaptive(policy):
            choice = validate_policy(policy)
        elif bench in (table := _table()):
            choice = table[bench]
        elif (trace is None or device_pages is None
              or device_pages >= trace.working_set_pages):
            choice = EVICTION_POLICIES[0]
        else:
            key = _memo_key(trace, device_pages, probe_accesses, prefetcher)
            if key not in _MEMO and key not in pending:
                pending[key] = probe_requests(trace, device_pages,
                                              probe_accesses, key[3])
        choices.append(choice)
        keys.append(key)
    if pending:
        k1 = get_backend("cuda", device)
        reqs = [r for rs in pending.values() for r in rs]
        lanes = [i for i, r in enumerate(reqs) if k1.can_replay(r)]
        got = dict(zip(lanes, k1.replay([reqs[i] for i in lanes])))
        stats = iter([got[i] if i in got else dispatch(r, "cuda", device)
                      for i, r in enumerate(reqs)])
        for key, rs in pending.items():
            cycles = tuple(float(next(stats).cycles) for _ in rs)
            _MEMO[key] = (pick(cycles), cycles)
    return [c if k is None else _MEMO[k][0] for c, k in zip(choices, keys)]


def resolve_eviction(policy: str, bench: str, trace=None,
                     device_pages: Optional[int] = None,
                     probe_accesses: int = PROBE_ACCESSES,
                     prefetcher: Optional[str] = None,
                     device: str = "cuda") -> str:
    """Resolve one cell's eviction policy to a concrete one: non-adaptive
    policies validate and pass through; ``adaptive`` takes the selector
    table, then the probe (see :func:`resolve_all`), then ``lru`` when
    there is no eviction pressure."""
    return resolve_all([(policy, bench, trace, device_pages, prefetcher)],
                       probe_accesses, device)[0]


def main(argv=None) -> None:
    """Distill sweep results into a selector table::

        python -m repro_torch.uvm.adaptive results.json --out table.json

    ``results.json`` is a sweep output (``{"rows": [...]}`` or a bare row
    list); the table is the ``{bench: policy}`` JSON that
    ``REPRO_ADAPTIVE_TABLE`` consumes.
    """
    import argparse
    import sys

    ap = argparse.ArgumentParser(
        description="Distill sweep result rows into an adaptive-eviction "
                    "selector table (REPRO_ADAPTIVE_TABLE format)")
    ap.add_argument("results", help="sweep results.json (rows with "
                                    "bench/eviction/cycles)")
    ap.add_argument("--out", default=None,
                    help="write the table here (default: stdout)")
    args = ap.parse_args(argv)
    with open(args.results) as f:
        doc = json.load(f)
    rows = doc["rows"] if isinstance(doc, dict) else doc
    table = selector_from_rows(rows)
    if not table:
        ap.error("no usable rows (need bench, concrete eviction, cycles)")
    blob = json.dumps({"selector": table,
                       "note": "bench -> cheapest mean-cycles eviction "
                               "policy; consumed via REPRO_ADAPTIVE_TABLE"},
                      indent=1, sort_keys=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(blob + "\n")
    else:
        sys.stdout.write(blob + "\n")


if __name__ == "__main__":
    main()
