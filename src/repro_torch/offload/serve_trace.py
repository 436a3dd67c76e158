"""Serving-traffic trace source: PagedKVStore fault streams as first-class
UVM replay traces.

The paged KV store (``repro_torch.offload.paged_store``) is the serving-side
analogue of the paper's UVM page system, and its access/fault stream is the
same object the replay core consumes — so this module closes the loop and
makes serving workloads replayable on every registered backend:

* **block ↔ page** — one KV block (``BLOCK_TOKENS`` tokens, 64 KB) maps to
  one UVM page.  Each request's block space is laid out as its own
  2 MB-aligned (``ROOT_PAGES``) region, exactly like ``cudaMallocManaged``
  arrays in ``repro_torch.traces.generators._Alloc``: request *r*, block *b*
  lives at page ``base + r * region_pages + b``, so the tree prefetcher's
  2 MB root windows align with per-request KV caches and the ``array``
  feature is the request id.
* **DMA ↔ far-fault** — a host→HBM block DMA is a page migration; a block
  miss is a far fault; the learned offload prefetcher's lookahead is the
  paper's prediction distance.
* **decode step ↔ kernel launch** — the decode-step index rides in the
  ``kernel`` field of :data:`~repro_torch.traces.trace.ACCESS_DTYPE` (the access
  stream is step-major, so the column is non-decreasing);
  :func:`trace_step_bounds` recovers per-step access boundaries with one
  ``searchsorted``, and the replay core's ``step_bounds`` support
  (``repro_torch.uvm.replay_core``) turns them into per-step completion clocks —
  the p50/p95/p99 decode-latency and TTFT columns of serve sweep rows.

Workloads are registered in :data:`SERVE_WORKLOADS` (continuous-batching
decode, multi-tenant mixes, bursty open-loop arrivals); rate-parameterized
variants parse on demand (``"ServeBursty@r128"`` = 128 requests/s), so
spawn-based sweep workers resolve any serve bench name without import-time
side effects.  :func:`build_serve_trace` is the sweep's trace generator:
a pure function of (bench, scale, seed), which is what the npz trace cache
and multi-process workers require.

The access stream is a pure function of the *workload* (decode attention
sweeps every history block regardless of residency), so one serve trace
replays unchanged under every (prefetcher × eviction × capacity) cell —
the same trace-vs-policy separation the UVM benchmarks have.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.offload.paged_store import BLOCK_TOKENS
from repro_torch.traces.trace import ACCESS_DTYPE, ROOT_PAGES, Trace

#: decode-step compute time used to convert open-loop arrival times into
#: decode-step indices (a ~2 ms decode step at serving batch sizes)
DEFAULT_STEP_US = 2000.0

#: the ``kernel`` field of ACCESS_DTYPE is uint16 — a serve episode must
#: fit its step ids in it (with headroom below the 65535 ceiling)
MAX_SERVE_STEPS = 60_000


# ---------------------------------------------------------------------------
# workload specs + registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ServeWorkload:
    """One serving workload spec (continuous-batching decode traffic).

    ``tenants`` is a tuple of (weight, prompt_mult, gen_mult) classes:
    each request draws a class by weight and scales its prompt/decode
    lengths by the class multipliers (the multi-tenant request mix).
    ``arrival`` is ``"batch"`` (all requests queued at step 0 — closed
    loop) or ``"open"`` (Poisson arrivals at ``rate_rps`` requests/s;
    ``burstiness`` b > 1 collapses a 1-1/b fraction of inter-arrival gaps
    to zero and stretches the rest by b, keeping the mean rate while
    clustering arrivals).
    """

    name: str
    n_requests: int = 24
    slots: int = 8                  # continuous-batching width
    prompt_len: int = 384
    gen: int = 96                   # decode steps per request (x gen_mult)
    arrival: str = "batch"          # "batch" | "open"
    rate_rps: float = 64.0
    burstiness: float = 1.0
    step_us: float = DEFAULT_STEP_US
    tenants: Tuple[Tuple[float, float, float], ...] = ((1.0, 1.0, 1.0),)


SERVE_WORKLOADS: Dict[str, ServeWorkload] = {
    # continuous-batching decode: two admission waves through 8 slots, so
    # late-wave requests see real queueing in their TTFT
    "ServeDecode": ServeWorkload(name="ServeDecode"),
    # multi-tenant mix: 3:1 short interactive vs long analytical requests
    "ServeTenantMix": ServeWorkload(
        name="ServeTenantMix", prompt_len=256,
        tenants=((3.0, 0.5, 0.75), (1.0, 3.0, 1.5))),
    # bursty open-loop arrivals: Poisson at rate_rps with 4x clustering
    "ServeBursty": ServeWorkload(
        name="ServeBursty", n_requests=32, prompt_len=256, gen=64,
        arrival="open", rate_rps=64.0, burstiness=4.0),
}


def is_serve_bench(name: str) -> bool:
    """True when ``name`` resolves to a registered serve workload
    (including ``Base@r<rate>`` rate-parameterized variants)."""
    try:
        get_serve_workload(name)
        return True
    except (KeyError, ValueError):
        return False


def get_serve_workload(name: str) -> ServeWorkload:
    """Resolve a serve bench name, parsing ``@r<rate>`` suffixes on demand
    (``"ServeBursty@r128"`` -> the ServeBursty spec at 128 requests/s,
    open-loop).  Parsing instead of registering keeps resolution a pure
    function of the name — spawn-based sweep workers need that."""
    base, sep, suffix = name.partition("@")
    try:
        wl = SERVE_WORKLOADS[base]
    except KeyError:
        raise KeyError(
            f"unknown serve workload {base!r}; "
            f"available: {sorted(SERVE_WORKLOADS)}") from None
    if not sep:
        return wl
    if not suffix.startswith("r"):
        raise ValueError(f"bad serve workload suffix {suffix!r} in "
                         f"{name!r}; expected '@r<rate_rps>'")
    rate = float(suffix[1:])
    if rate <= 0:
        raise ValueError(f"serve workload rate must be > 0, got {rate}")
    return dataclasses.replace(wl, name=name, arrival="open", rate_rps=rate)


# ---------------------------------------------------------------------------
# load generator: workload spec -> access/step episode
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ServeEpisode:
    """One driven workload: the (request, block) access stream with its
    decode-step structure and per-request arrival/first-decode steps."""

    workload: ServeWorkload
    req: np.ndarray                 # int64 request id per access
    blk: np.ndarray                 # int64 block id per access
    step: np.ndarray                # int64 step id per access, non-decreasing
    n_steps: int
    prompt_lens: np.ndarray         # tokens, per request
    gen_lens: np.ndarray            # decode steps, per request
    arrival_steps: np.ndarray       # step index each request arrived at
    first_steps: np.ndarray         # step index of each request's first decode


def drive_workload(wl: ServeWorkload, *, scale: float = 1.0,
                   seed: int = 0) -> ServeEpisode:
    """Run the load generator: admit requests FIFO into ``wl.slots``
    continuous-batching slots and sweep every active request's history
    blocks each decode step (the ``PagedKVStore.on_decode_step`` access
    pattern, generalized to per-request positions).  ``scale`` multiplies
    decode lengths, keeping the arrival process — a pure function of
    (wl, scale, seed)."""
    if wl.slots <= 0 or wl.n_requests <= 0:
        raise ValueError(f"{wl.name}: slots and n_requests must be > 0")
    n = wl.n_requests
    rng = np.random.default_rng([seed, n, wl.slots])

    weights = np.asarray([t[0] for t in wl.tenants], dtype=np.float64)
    classes = rng.choice(len(wl.tenants), size=n, p=weights / weights.sum())
    p_mult = np.asarray([t[1] for t in wl.tenants])[classes]
    g_mult = np.asarray([t[2] for t in wl.tenants])[classes]
    prompt = np.maximum(
        BLOCK_TOKENS, np.rint(wl.prompt_len * p_mult)).astype(np.int64)
    gen = np.maximum(
        2, np.rint(max(wl.gen * scale, 2.0) * g_mult)).astype(np.int64)

    if wl.arrival == "batch":
        arrival_steps = np.zeros(n, dtype=np.int64)
    elif wl.arrival == "open":
        gaps = rng.exponential(1e6 / wl.rate_rps, size=n)
        gaps[0] = 0.0
        if wl.burstiness > 1.0:
            burst = rng.random(n) < (1.0 - 1.0 / wl.burstiness)
            gaps = np.where(burst, 0.0, gaps * wl.burstiness)
        arrival_steps = (np.cumsum(gaps) // wl.step_us).astype(np.int64)
    else:
        raise ValueError(f"{wl.name}: unknown arrival model {wl.arrival!r}")

    slots: List[Optional[int]] = [None] * wl.slots
    req_chunks: List[np.ndarray] = []
    blk_chunks: List[np.ndarray] = []
    step_chunks: List[np.ndarray] = []
    first_steps = np.full(n, -1, dtype=np.int64)
    decoded = np.zeros(n, dtype=np.int64)
    next_req = 0                    # arrivals are already time-ordered
    remaining = n
    t = 0
    while remaining > 0:
        while (next_req < n and arrival_steps[next_req] <= t
               and None in slots):
            slots[slots.index(None)] = next_req
            next_req += 1
        if all(s is None for s in slots):
            # idle gap before the next arrival: skip the empty steps
            # (they still exist in [0, n_steps) — their step bounds are
            # duplicates and their decode latency is zero-sized)
            t = int(arrival_steps[next_req])
            continue
        for slot in range(wl.slots):
            r = slots[slot]
            if r is None:
                continue
            if first_steps[r] < 0:
                first_steps[r] = t
            pos = int(prompt[r] + decoded[r])
            nb = pos // BLOCK_TOKENS + 1
            req_chunks.append(np.full(nb, r, dtype=np.int64))
            blk_chunks.append(np.arange(nb, dtype=np.int64))
            step_chunks.append(np.full(nb, t, dtype=np.int64))
            decoded[r] += 1
            if decoded[r] >= gen[r]:
                slots[slot] = None
                remaining -= 1
        t += 1
        if t > MAX_SERVE_STEPS:
            raise ValueError(
                f"{wl.name}: episode exceeds {MAX_SERVE_STEPS} decode "
                "steps (the uint16 kernel field); lower the request "
                "count or raise the arrival rate")
    return ServeEpisode(
        workload=wl,
        req=np.concatenate(req_chunks),
        blk=np.concatenate(blk_chunks),
        step=np.concatenate(step_chunks),
        n_steps=t,
        prompt_lens=prompt, gen_lens=gen,
        arrival_steps=arrival_steps, first_steps=first_steps)


# ---------------------------------------------------------------------------
# access log <-> Trace round-trip
# ---------------------------------------------------------------------------

def _serve_meta(*, n_requests: int, blocks_per_seq: int, base: int,
                region_pages: int, n_steps: int, step_us: float,
                arrival_steps: Sequence[int],
                first_steps: Sequence[int]) -> Dict:
    """The ``trace.meta["serve"]`` sidecar: pure-Python values only (the
    sweep's npz cache serializes meta through JSON)."""
    return {
        "n_requests": int(n_requests),
        "blocks_per_seq": int(blocks_per_seq),
        "base": int(base),
        "region_pages": int(region_pages),
        "n_steps": int(n_steps),
        "step_us": float(step_us),
        "arrival_steps": [int(x) for x in arrival_steps],
        "first_steps": [int(x) for x in first_steps],
    }


def _encode_trace(req: np.ndarray, blk: np.ndarray, step: np.ndarray, *,
                  name: str, seed: int, n_requests: int,
                  blocks_per_seq: int, n_steps: int, step_us: float,
                  arrival_steps: Sequence[int],
                  first_steps: Sequence[int]) -> Trace:
    if np.any(np.diff(step) < 0):
        raise ValueError("serve access stream must be step-major "
                         "(non-decreasing step ids)")
    if n_steps > MAX_SERVE_STEPS:
        raise ValueError(f"{n_steps} steps exceed the uint16 kernel field")
    if blk.size and int(blk.max()) >= blocks_per_seq:
        raise ValueError(
            f"block id {int(blk.max())} outside blocks_per_seq="
            f"{blocks_per_seq}: position and capacity accounting disagree")
    region = ((blocks_per_seq - 1) // ROOT_PAGES + 1) * ROOT_PAGES
    # seeded heap base, 2 MB-aligned — the same idiom as the benchmark
    # generators' cudaMallocManaged model (traces.generators._Alloc)
    base_rng = np.random.default_rng([seed, 0x5E12])
    base = int(base_rng.integers(1 << 10, 1 << 18)) * ROOT_PAGES

    n = req.size
    recs = np.zeros(n, dtype=ACCESS_DTYPE)
    recs["pc"] = (0x400000 + (req << 5)).astype(np.uint32)
    recs["sm"] = (req % 28).astype(np.uint16)
    recs["tpc"] = (recs["sm"] // 2).astype(np.uint16)
    recs["cta"] = req.astype(np.uint32)
    recs["warp"] = (req * 4 + blk % 4).astype(np.uint32)
    recs["kernel"] = step.astype(np.uint16)
    recs["array"] = req.astype(np.uint16)     # 'In' feature = request id
    recs["page"] = base + req * region + blk

    array_bases = {f"req{r}": int(base + r * region)
                   for r in range(n_requests)}
    array_pages = {f"req{r}": int(blocks_per_seq)
                   for r in range(n_requests)}
    meta = {"serve": _serve_meta(
        n_requests=n_requests, blocks_per_seq=blocks_per_seq, base=base,
        region_pages=region, n_steps=n_steps, step_us=step_us,
        arrival_steps=arrival_steps, first_steps=first_steps)}
    # each access is one coalesced attention block read; the instruction
    # budget amortizes the per-block attention math like the benchmark
    # generators amortize kernel arithmetic
    return Trace(name=name, accesses=recs, array_bases=array_bases,
                 array_pages=array_pages, n_instructions=n * 300, meta=meta)


def episode_to_trace(ep: ServeEpisode, *, name: Optional[str] = None,
                     seed: int = 0) -> Trace:
    """Encode a driven episode as a replay-core :class:`Trace`."""
    max_pos = int((ep.prompt_lens + ep.gen_lens - 1).max())
    return _encode_trace(
        ep.req, ep.blk, ep.step, name=name or ep.workload.name, seed=seed,
        n_requests=ep.workload.n_requests,
        blocks_per_seq=max_pos // BLOCK_TOKENS + 1, n_steps=ep.n_steps,
        step_us=ep.workload.step_us, arrival_steps=ep.arrival_steps,
        first_steps=ep.first_steps)


def access_log_to_trace(log: Sequence[Tuple[int, int]], *, n_requests: int,
                        blocks_per_seq: int, name: str = "serve-log",
                        seed: int = 0,
                        step_ends: Optional[Sequence[int]] = None,
                        step_us: float = 10.0) -> Trace:
    """Encode a raw ``PagedKVStore.access_log`` as a replay-core trace.

    ``step_ends[k]`` is the log length after decode step *k* (cumulative
    access counts), recovering the step structure the store itself does
    not record; without it the whole log is one step.  The inverse is
    :func:`trace_to_access_log`, and the round trip is byte-identical
    (pinned by ``tests/test_offload.py``).
    """
    arr = np.asarray(list(log), dtype=np.int64).reshape(-1, 2)
    req, blk = arr[:, 0], arr[:, 1]
    if step_ends is None:
        ends = np.asarray([req.size], dtype=np.int64)
    else:
        ends = np.asarray(list(step_ends), dtype=np.int64)
        if ends.size == 0 or int(ends[-1]) != req.size:
            raise ValueError("step_ends must end at len(log)")
    step = np.searchsorted(ends, np.arange(req.size), side="right")
    first = np.zeros(n_requests, dtype=np.int64)
    for r in range(n_requests):
        hits = np.nonzero(req == r)[0]
        first[r] = step[hits[0]] if hits.size else 0
    return _encode_trace(
        req, blk, step, name=name, seed=seed, n_requests=n_requests,
        blocks_per_seq=blocks_per_seq, n_steps=int(ends.size),
        step_us=step_us, arrival_steps=np.zeros(n_requests, dtype=np.int64),
        first_steps=first)


def is_serve_trace(trace: Trace) -> bool:
    return bool(trace.meta) and "serve" in trace.meta


def trace_to_access_log(trace: Trace) -> List[Tuple[int, int]]:
    """Decode a serve trace's pages back to the store's (request, block)
    access log — the inverse of the block ↔ page mapping."""
    sv = _serve_sidecar(trace)
    rel = trace.accesses["page"] - int(sv["base"])
    region = int(sv["region_pages"])
    if rel.size and (rel.min() < 0
                     or rel.max() >= sv["n_requests"] * region):
        raise ValueError(f"pages outside the serve regions of {trace.name}")
    return list(zip((rel // region).tolist(), (rel % region).tolist()))


def _serve_sidecar(trace: Trace) -> Dict:
    if not is_serve_trace(trace):
        raise ValueError(f"trace {trace.name!r} is not a serve trace "
                         "(no meta['serve'] sidecar)")
    return trace.meta["serve"]


# ---------------------------------------------------------------------------
# sweep integration: bench name -> trace, step bounds, latency columns
# ---------------------------------------------------------------------------

def build_serve_trace(bench: str, *, scale: float = 1.0,
                      seed: int = 0) -> Trace:
    """The sweep's serve trace generator — a pure function of
    (bench, scale, seed), like the GPUModel benchmark path, so the npz
    trace cache and spawn workers stay deterministic."""
    wl = get_serve_workload(bench)
    ep = drive_workload(wl, scale=scale, seed=seed)
    return episode_to_trace(ep, name=bench, seed=seed)


def trace_step_bounds(trace: Trace) -> np.ndarray:
    """Per-decode-step access boundaries: ``bounds[k]`` = number of
    accesses in steps 0..k (an exclusive end index; empty steps repeat
    the previous bound).  Feed to ``ReplayRequest.step_bounds`` to get
    per-step completion clocks from any backend (host-side on
    legacy/numpy, in-kernel on the pallas lanes)."""
    sv = _serve_sidecar(trace)
    kern = np.asarray(trace.accesses["kernel"], dtype=np.int64)
    bounds = np.searchsorted(kern, np.arange(int(sv["n_steps"])),
                             side="right").astype(np.int64)
    if bounds.size and int(bounds[-1]) != len(trace):
        raise ValueError(
            f"serve trace {trace.name!r} was truncated after encoding "
            "(window-split?): step bounds no longer cover the accesses")
    return bounds


def serve_latency_columns(trace: Trace, step_clocks: np.ndarray,
                          config) -> Dict[str, Optional[float]]:
    """SLO percentile columns for one serve replay.

    ``step_clocks[k]`` is the replay clock (GPU cycles) after the last
    access of decode step *k* (``UVMStats.step_clocks``).  Per-step decode
    latency is the clock delta across each non-empty step; TTFT is each
    request's first-decode-step completion measured from the completion of
    the step before its arrival step (both in replay time, so queueing
    behind busy slots is included).  Returns the six
    ``decode_lat_p{50,95,99}_us`` / ``ttft_p{50,95,99}_us`` row columns.
    """
    from repro_torch.uvm.metrics import slo_percentiles

    sv = _serve_sidecar(trace)
    bounds = trace_step_bounds(trace)
    clocks = np.asarray(step_clocks, dtype=np.float64)
    if clocks.size != bounds.size:
        raise ValueError(f"step_clocks has {clocks.size} steps, trace has "
                         f"{bounds.size}")
    t_us = config.us_from_cycles(clocks)
    lat = np.diff(np.concatenate([[0.0], t_us]))
    sizes = np.diff(np.concatenate([[0], bounds]))
    row = slo_percentiles(lat[sizes > 0], "decode_lat")
    arrival = np.asarray(sv["arrival_steps"], dtype=np.int64)
    first = np.asarray(sv["first_steps"], dtype=np.int64)
    start_us = np.where(arrival > 0, t_us[np.maximum(arrival - 1, 0)], 0.0)
    row.update(slo_percentiles(t_us[first] - start_us, "ttft"))
    return row


# ---------------------------------------------------------------------------
# npz persistence (the serve.py --dump-trace format == the sweep cache's)
# ---------------------------------------------------------------------------

def save_trace_npz(trace: Trace, path: str) -> None:
    """Persist a trace in the sweep cache's npz layout (accesses array +
    JSON meta), so dumped serving traces replay through the same loader."""
    meta = json.dumps({
        "name": trace.name,
        "array_bases": trace.array_bases,
        "array_pages": trace.array_pages,
        "n_instructions": trace.n_instructions,
        "meta": trace.meta,
    })
    np.savez(path, accesses=trace.accesses, meta=np.array(meta))


def load_trace_npz(path: str) -> Trace:
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        return Trace(name=meta["name"],
                     accesses=z["accesses"].astype(ACCESS_DTYPE, copy=False),
                     array_bases=meta["array_bases"],
                     array_pages=meta["array_pages"],
                     n_instructions=meta["n_instructions"],
                     meta=meta.get("meta", {}))
