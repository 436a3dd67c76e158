#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` and drives the
learned-prefetch sweep, the paper's tree-vs-learned tables, the
oversubscription matrix, the serving matrix, the multi-tenant matrix, the
predictor-family smoke and a full-width Transformer-family sweep on the
card:

1. the device, its power limit, and the kernel build;
2. K1 (multi-lane replay) against the legacy engine at full benchmark
   scale: none/block/learned lanes under lru on all 11 benchmarks, and every
   other family x policy (tree and oracle under lru/random/hotcold,
   none/block/learned under random/hotcold) at half the working set;
3. K1 against ``tests/golden/uvm_golden.json`` and against its plain
   version on whole batches of the 77 golden cells, one batch per kernel
   variant (maximum difference 0), with both timed;
4. K2 (HLSH attention), K3 (int4 matmul) and K4 (flash attention)
   against their plain versions, at the reference's test shapes and types,
   at the predictor's shapes and at the edges of K2's and K4's tilings (K2
   in both tilings and both types) and K3's variants;
5. the main path: the sweep over the 11 paper benchmarks x {none, tree,
   learned} x {all memory, half the working set}, predictors trained and
   served on the card (the quantized simplified predictor's weight products
   on K3), every row replayed by K1; tree and learned rows equal the legacy
   engine on the same inputs;
6. the paper's Table 10 and Table 11 (tree vs learned, unlimited memory);
   every tree row equals the legacy engine's;
7. the ``oversub-full`` scenario (660 cells) through the port's sweep,
   sharing the main path's prediction cache; the 2DCONV cells are held
   against the legacy engine;
8. K1 with step clocks against the legacy engine at scale 1.0: every
   family x policy on the five serve traces and ServeBursty@r8 (316 empty
   windows), window clocks bit for bit;
9. K1 with tenant quotas (and the tenants' completion clocks) against the
   legacy engine on each multi-tenant pair under the 0.4/0.4 split (with
   its spill pool), every family x policy; K1 against its plain version on
   a small step-clock batch and a small quota batch of every family x
   policy;
10. the ``serve-full`` scenario (300 cells): every row on cuda with its
    latency percentiles from K1's step clocks; the ServeBursty rows are
    held against the legacy engine;
11. the ``mt-full`` scenario (360 cells, the tenants' solo replays as K1
    lanes of the same sweep): per-tenant hit rates and slowdowns; the
    MVT+StreamTriad rows, solo replays included, are held against the
    legacy engine;
12. the ``transformer-smoke`` scenario under ``ADAPTIVE_selector.json``
    (the assertions of ``scripts/ci_check.sh``: 4 rows on cuda, both
    families, each bench's eviction its selector entry), its replays held
    against the legacy engine;
13. the family path: the 11 benchmarks x learned x the reference
    Transformer family (2 layers, 4 heads, d_model 200, full attention on
    K4) x {all memory, half the working set} under ``adaptive`` eviction
    with no selector table, so every half-memory cell probes on K1; each
    resolved policy equals the legacy engine's probe, cycles included;
    then top-1, F1 and coverage per bench against the simplified family;
14. kernel times from CUDA events beside the plain versions and a PyTorch
    yardstick: K1 against its plain version on the tables' tree batch
    (which never evicts: its slowest lane's time per access gives K1's
    chain bound, the longest lane's accesses at that rate), K1 per kernel
    variant on the largest batch of each path (the step-clock batches also
    without their capture, and through the quota specialisation), each with
    its slowest lane's accesses, evictions, victim-search chunk scans and
    covered slots, K1's per-eviction cost and chunk scans against the span
    its search covers, K1 against its plain version on the main path's
    learned batch, K2 (float32 and bf16, with its tiling), K3 and K4 at the
    predictor's shapes, each per call through its wrapper and as device
    time per launch (a CUDA graph of 20 launches; the profiler where a
    capture fails), in turns with its PyTorch call and its plain version,
    then the ``kernels`` line and the result line.

Each of the seven driven paths (5, 6, 7, 10, 11, 12, 13) zeroes the launch
counters just before it and reads them just after.  The legacy engine's
replays and the plain versions run in a pool of worker processes on the
host.

Usage: ``python3 chip_smoke.py [--out DIR]`` (``--out`` also writes the rows
and kernel records as JSON).  Exits non-zero without a result line when no
CUDA device is present or any check fails.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import itertools
import json
import math
import multiprocessing
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

BENCHES = ("AddVectors", "ATAX", "Backprop", "BICG", "Hotspot", "MVT", "NW",
           "Pathfinder", "Srad-v2", "StreamTriad", "2DCONV")
FRACS = (None, 0.5)
#: benches of the new family x policy lanes of phase 2 (the longest lane,
#: NW, and three of differing reuse)
NEW_LANE_BENCHES = ("ATAX", "NW", "Pathfinder", "2DCONV")
#: the matrix bench held against the legacy engine in phase 7
MATRIX_CHECK_BENCH = "2DCONV"
#: serve traces of the step-clock check (phase 8): serve-full's five and
#: ServeBursty@r8, whose windows are a third empty
STEP_CHECK_BENCHES = ("ServeDecode", "ServeTenantMix", "ServeBursty",
                      "ServeBursty@r32", "ServeBursty@r256", "ServeBursty@r8")
#: capacity ratio and quota splits of the quota check (phase 9)
QUOTA_CHECK_RATIO = 0.75
QUOTA_CHECK_SPLITS = ((0.5, 0.5), (0.4, 0.4))
#: the serve bench and the multi-tenant pair whose rows are held against
#: the legacy engine (phases 10 and 11)
SERVE_CHECK_BENCH = "ServeBursty"
MT_CHECK_BENCH = "MVT+StreamTriad"
#: worker processes of the legacy engine and the plain versions
HOST_WORKERS = 7
K1_SOURCE = "src/repro_torch/csrc/lane_replay.cu"
K2_SOURCE = "src/repro_torch/csrc/hlsh_attention.cu"
K3_SOURCE = "src/repro_torch/csrc/int4_matmul.cu"
K4_SOURCE = "src/repro_torch/csrc/flash_attention.cu"
K1_REPLACES = "src/repro/uvm/backends/pallas_backend.py:197"
K2_REPLACES = "src/repro/kernels/hlsh_attention.py:34"
K3_REPLACES = "src/repro/kernels/int4_matmul.py:22"
K4_REPLACES = "src/repro/kernels/flash_attention.py:26"
GOLDEN = os.path.join(ROOT, "tests", "golden", "uvm_golden.json")
SELECTOR = os.path.join(ROOT, "ADAPTIVE_selector.json")
#: the tolerances of tests/test_kernels.py: K2 and K4 absolute, K3
#: relative to |want| + 1
K2_ATOL = {"float32": 2e-4, "bfloat16": 3e-2}
K4_ATOL = {"float32": 2e-4, "bfloat16": 2e-2}
K3_RTOL = {"float32": 1e-4, "bfloat16": 2e-2}
#: K2's cases (B, N, D) and types: the path's shape first (timed in phase
#: 14), the warp-per-row tiling's edges, and the reference's test shapes
#: (the general tile); together both tilings in both types
K2_REF_SHAPES = ((1, 128, 32), (2, 256, 64), (1, 512, 128))
K2_CASES = tuple(((4096, 30, 12), dt) for dt in ("float32", "bfloat16")) + (
    ((64, 1, 12), "float32"), ((16, 32, 64), "float32"),
    ((33, 31, 13), "float32"), ((33, 31, 13), "bfloat16"),
    ((2, 256, 64), "float32")) + tuple(
    (shape, "bfloat16") for shape in K2_REF_SHAPES)
#: the reference's test shapes: K4 (B, H, Hkv, Sq, Sk, D), K3 (M, K, N)
K4_REF_SHAPES = ((1, 2, 1, 128, 128, 64), (2, 4, 2, 256, 256, 64),
                 (1, 8, 1, 128, 384, 128), (1, 4, 4, 256, 128, 32))
K3_REF_SHAPES = ((128, 128, 256), (128, 256, 256), (256, 128, 512))
#: the predictor's shapes: the Transformer family's heads at inference
#: (4096 sequences x 4 heads x 30 tokens x 200 / 4), the quantized
#: simplified predictor's layer products (4096 x 30 token rows of width 12
#: and 48) and its classification head at the largest class count and at an
#: odd one (padded by one zero column)
K4_PATH_SHAPE = (4096, 4, 4, 30, 30, 50)
#: edges of K3's variants (M = 1000, no tile multiple: odd K, K and N past
#: the narrow limit, rows of out no whole 16-byte chunks, a wide head), with
#: the path's shapes every compiled body in both types, and of K4's tilings
#: (S around a warp's 32 rows, D around its 64, grouped kv heads with Sq >
#: Sk)
K3_EDGE_CASES = tuple(((1000, k, n), "float32") for k, n in (
    (13, 12), (64, 64), (65, 12), (12, 66), (12, 130), (32, 20000),
    (48, 32), (12, 24), (48, 48), (16, 48))) + tuple(
    ((1000, k, n), "bfloat16") for k, n in (
        (48, 48), (16, 20000), (12, 12), (16, 16), (48, 32), (16, 32),
        (32, 48), (64, 64)))
K4_EDGE_SHAPES = ((2, 5, 5, 1, 1, 1), (2, 5, 5, 31, 31, 49),
                  (2, 5, 5, 33, 33, 64), (2, 5, 5, 129, 129, 100),
                  (2, 5, 5, 29, 29, 128), (2, 4, 2, 33, 29, 50))
K3_PATH_SHAPES = ((4096 * 30, 12, 12), (4096 * 30, 12, 48),
                  (4096 * 30, 48, 12), (4096, 12, 20000), (4096, 12, 19999))
#: the Transformer family's learned cells (phase 13)
FAMILY = "transformer"
#: the bench whose quantized simplified inference is timed with and without
#: K3 (phase 14): an HLSH bench with many windows
INFER_BENCH = "NW"
#: published H100 SXM peaks: HBM bytes/s, float32 FLOP/s outside the
#: tensor cores
HBM_BYTES_S = 3.35e12
F32_FLOPS = 67e12
#: bytes that timed calls touch before one touches the same memory again:
#: four times the H100's 50 MB L2, so each call reads and writes HBM
ROTATE_BYTES = 200e6
INT_FIELDS = ("hits", "late", "faults", "prefetch_issued", "prefetch_used",
              "pages_migrated", "pages_evicted")


class CheckFailed(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def same_stats(got, want, what: str) -> None:
    """Counters exact, cycles/pcie_bytes within 1e-6 relative, and the
    per-tenant hits and step clocks (where the replay has them) exact."""
    import numpy as np
    for f in INT_FIELDS:
        check(getattr(got, f) == getattr(want, f),
              f"{what}: {f} {getattr(got, f)} != {getattr(want, f)}")
    for f in ("cycles", "pcie_bytes"):
        g, w = getattr(got, f), getattr(want, f)
        check(abs(g - w) <= 1e-6 * abs(w),
              f"{what}: {f} {g!r} != {w!r} beyond 1e-6 relative")
    check(got.tenant_hits == want.tenant_hits
          and got.tenant_accesses == want.tenant_accesses,
          f"{what}: tenant hits {got.tenant_hits} != {want.tenant_hits}")
    check((got.step_clocks is None) == (want.step_clocks is None)
          and (want.step_clocks is None
               or np.array_equal(got.step_clocks, want.step_clocks)),
          f"{what}: step clocks differ from the legacy engine's")


def legacy_replay(req):
    """The legacy engine on one request (a host worker's job)."""
    from repro_torch.uvm.simulator import UVMSimulator
    return UVMSimulator(req.config).run(req.trace, req.prefetcher,
                                        step_bounds=req.step_bounds)


def plain_replay(kwargs):
    """K1's plain version on one lane batch's CPU arguments (a host
    worker's job): (result, seconds)."""
    from repro_torch.kernels.lane_replay import lane_replay_plain
    t0 = time.perf_counter()
    out = lane_replay_plain(**kwargs)
    return out, time.perf_counter() - t0


def init_worker() -> None:
    import torch
    torch.set_num_threads(1)


def same_row(row, want, what: str) -> None:
    """A sweep row against legacy ``UVMStats`` of the same inputs."""
    for f in INT_FIELDS:
        check(row[f] == getattr(want, f),
              f"{what}: {f} {row[f]} != legacy {getattr(want, f)}")
    for f in ("cycles", "pcie_bytes"):
        check(abs(row[f] - getattr(want, f)) <= 1e-6 * abs(getattr(want, f)),
              f"{what}: {f} {row[f]} != legacy {getattr(want, f)}")


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` on the card, from CUDA events
    after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def graph_ms(fn, reps: int = 20, replays: int = 5):
    """Device milliseconds per call of ``fn``: ``reps`` calls captured in
    one CUDA graph, the graph replayed ``replays`` times between CUDA
    events, so no host work sits between the launches.  None if the
    capture fails."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
    except Exception as exc:      # a launch that cannot be captured
        torch.cuda.synchronize()
        print(f"chip_smoke: CUDA graph capture failed ({type(exc).__name__}:"
              f" {exc}); timing with the profiler", flush=True)
        return None
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (reps * replays)


def profiled_ms(fn, reps: int):
    """Device milliseconds per call of ``fn`` from ``torch.profiler``: the
    device time of every kernel the ``reps`` calls ran.  None if the trace
    shows no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    return us / 1e3 / reps if us > 0 else None


def device_ms(fn, reps: int = 20):
    """(device milliseconds per call, method): a CUDA graph of ``reps``
    calls, else the profiler's device time, else (None, "not measured")."""
    ms = graph_ms(fn, reps)
    if ms is not None:
        return ms, "graph"
    ms = profiled_ms(fn, reps)
    return (ms, "profiler") if ms is not None else (None, "not measured")


def copies_of(inputs, call_bytes: float):
    """``inputs`` and enough clones of them that calls taking them in turn
    touch ``ROTATE_BYTES`` (each call ``call_bytes``) before they come back
    to the same copy."""
    n = max(1, math.ceil(ROTATE_BYTES / call_bytes))
    return [inputs] + [tuple(t.clone() for t in inputs)
                       for _ in range(n - 1)]


def rotating(fn, copies):
    """A call of ``fn`` on each of ``copies`` in turn, so that every call
    reads inputs and writes an output that are not in L2, as on a path that
    moves on through its data.  Each result is held until its copy comes
    round again, so that outputs do not share memory either (within a CUDA
    graph's capture as well)."""
    held = [None] * len(copies)
    turn = itertools.count()

    def call():
        i = next(turn) % len(copies)
        held[i] = fn(*copies[i])
    # one round and one call more, so that the allocator already holds
    # every output (and the one being replaced) when the timing starts
    for _ in range(len(copies) + 1):
        call()
    return call


def timed_in_turns(fns, reps: int = 20):
    """Per-call and device milliseconds of each of ``fns`` (name -> call),
    timed in turns (forward, then backward: a, b, c, c, b, a), each the
    mean of its two turns: {name: {"ms", "device_ms", "method"}}."""
    names = list(fns)
    runs = {n: {"ms": [], "device_ms": [], "method": set()} for n in names}
    for n in names + names[::-1]:
        runs[n]["ms"].append(cuda_ms(fns[n], reps))
        ms, method = device_ms(fns[n], reps)
        runs[n]["device_ms"].append(ms)
        runs[n]["method"].add(method)
    out = {}
    for n, r in runs.items():
        dev = None if None in r["device_ms"] else sum(r["device_ms"]) / 2
        out[n] = {"ms": sum(r["ms"]) / 2, "device_ms": dev,
                  "method": "/".join(sorted(r["method"]))}
    return out


def k1_bound_ms(batch) -> float:
    """Least time for K1's bytes: each input read once (the real accesses'
    pages, predictions and stream positions, the first-touch streams, the
    parameter blocks), each stat written once, over the HBM rate."""
    n_acc = int(batch.iparams[:, 0].sum())
    per_access = 4 + sum(4 for a in (batch.preds, batch.pos, batch.sids)
                         if a is not None)
    n_ft = int(batch.iparams[:, 4].clip(min=0).sum()) if (
        batch.ft is not None) else 0
    lanes = int((batch.iparams[:, 0] > 0).sum())
    nbytes = (n_acc * per_access + n_ft * 4 + lanes * (8 * 8 + 9 * 4)
              + lanes * 10 * 8 + lanes * batch.steps_len * 8)
    return nbytes / HBM_BYTES_S * 1e3


def lane_scan_end(batch, lane: int) -> int:
    """The slots K1's victim search covers in one lane of ``batch``: up to
    the root window of its highest page, prediction or first touch."""
    n = int(batch.iparams[lane, 0])
    hi = int(batch.pages[lane, :n].max()) if n else -1
    if batch.preds is not None and n:
        hi = max(hi, int(batch.preds[lane, :n].max()))
    n_ft = int(batch.iparams[lane, 4])
    if batch.ft is not None and n_ft > 0:
        hi = max(hi, int(batch.ft[lane, :n_ft].max()))
    return min(batch.span, (hi // 512 + 1) * 512)


def k1_lanes(batch):
    """One K1 launch on ``batch`` with its per-lane record: (the stats on
    the host, the slowest lane by the card's global timer: its
    microseconds, accesses, evictions, victim-search chunk scans and the
    slots its search covers)."""
    import torch
    from repro_torch.kernels.lane_replay import lane_replay
    info = torch.zeros((len(batch.pages), 2), dtype=torch.int64,
                       device="cuda")
    out = lane_replay(**batch.kernel_args("cuda"), lane_info=info)
    out = (out[0] if batch.steps_len else out).cpu()
    info = info.cpu()
    slow = int(info[:, 1].argmax())
    return out, {"us": int(info[slow, 1]) / 1e3,
                 "accesses": int(batch.iparams[slow, 0]),
                 "evictions": int(out[slow, 7]),
                 "chunk_scans": int(info[slow, 0]),
                 "scanned_slots": lane_scan_end(batch, slow)}


def lane_text(x) -> str:
    return (f"slowest lane {x['us'] / 1e3:.1f} ms: {x['accesses']} "
            f"accesses, {x['evictions']} evictions, {x['chunk_scans']} "
            f"chunk scans over {x['scanned_slots']} slots")


def variant_key(batch):
    """K1's variant of one lane batch: (family, policy[, steps][, quotas])."""
    from repro_torch.kernels.lane_replay import kind_key
    return kind_key(batch.family, batch.policy, batch.steps_len,
                    batch.quotas)


def new_variant(key, **fields):
    return {"family": key[0], "policy": key[1],
            "variant": "+".join(key[2:]) or "base", **fields}


def path_batches(backend, requests):
    """The lane batches a sweep of ``requests`` launches, by K1 variant."""
    by_key = {}
    for idx in backend.pack_lanes(requests):
        batch = backend.pack_batch([requests[i] for i in idx])
        by_key.setdefault(variant_key(batch), []).append(batch)
    return by_key


def plain_job(batch):
    """The CPU arguments of K1's plain version on one lane batch."""
    cpu = batch.kernel_args("cpu")
    cpu.pop("buf_len")
    return cpu


def k1_against(batch, plain):
    """K1 on one lane batch against its plain version's result ``plain``
    (from :func:`plain_replay`): (max abs difference of the stats and
    window clocks, kernel stats)."""
    from repro_torch.kernels.lane_replay import lane_replay
    got = lane_replay(**batch.kernel_args("cuda"))
    err = 0.0
    if batch.steps_len:
        (got, got_steps), (plain, plain_steps) = got, plain
        err = float((got_steps.cpu() - plain_steps).abs().max())
    got = got.cpu()
    return max(err, float((got - plain).abs().max())), got


def k1_vs_plain(batch):
    """K1 and its plain version on one lane batch, in this process: (max
    abs difference, kernel stats, plain seconds)."""
    want, plain_s = plain_replay(plain_job(batch))
    err, got = k1_against(batch, want)
    return err, got, plain_s


def cuda_randn(rng, shape, dtype):
    """Standard normal draws from the numpy generator ``rng``, on the card
    in ``dtype``."""
    import torch
    return torch.tensor(rng.normal(size=shape), dtype=torch.float32,
                        device="cuda").to(dtype)


def k4_against_plain(rng, shape, causal, dtype):
    """K4 and its plain version on one (B, H, Hkv, Sq, Sk, D) draw: (max
    abs difference, (q, k, v))."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    b, h, hkv, sq, sk, d = shape
    q = cuda_randn(rng, (b, h, sq, d), dtype)
    k = cuda_randn(rng, (b, hkv, sk, d), dtype)
    v = cuda_randn(rng, (b, hkv, sk, d), dtype)
    got = flash_attention(q, k, v, causal=causal)
    want = flash_attention_plain(q, k, v, causal=causal)
    return float((got.float() - want.float()).abs().max()), (q, k, v)


def rel_err(got, want) -> float:
    """The reference's K3 measure: max |got - want| / (|want| + 1)."""
    got, want = got.float(), want.float()
    return float(((got - want).abs() / (want.abs() + 1.0)).max())


def k3_against_plain(rng, m, kdim, n, dtype, packer: bool):
    """K3 and its plain version on one (M, K) x (K, N) draw: random bytes
    and scale 0.03 as the reference's tests draw them, or (``packer``) a
    weight packed by ``pack_int4_like_fake_quant`` (an odd N padded by one
    column), where the plain product must also equal ``x @
    fake_quant_tensor(w)``.  Returns (relative error, max abs difference,
    (x, packed, scale))."""
    import torch
    from repro_torch.core.quantize import (fake_quant_tensor,
                                           pack_int4_like_fake_quant)
    from repro_torch.kernels.int4_matmul import int4_matmul, int4_matmul_plain
    x = cuda_randn(rng, (m, kdim), dtype)
    if packer:
        w = cuda_randn(rng, (kdim, n), torch.float32) * 0.3
        packed, scale = pack_int4_like_fake_quant(w)
    else:
        packed = torch.tensor(rng.integers(0, 256, (kdim, n // 2)),
                              dtype=torch.uint8, device="cuda")
        scale = 0.03
    got = int4_matmul(x, packed, scale)[:, :n]
    want = int4_matmul_plain(x, packed, scale)[:, :n]
    err = rel_err(got, want)
    if packer:
        err = max(err, rel_err(want, x @ fake_quant_tensor(w).to(dtype)))
    return err, float((got.float() - want.float()).abs().max()), (
        x, packed, scale)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write rows and kernel records here as JSON")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "the card", file=sys.stderr)
        return 2
    pool = concurrent.futures.ProcessPoolExecutor(
        HOST_WORKERS, mp_context=multiprocessing.get_context("spawn"),
        initializer=init_worker)
    try:
        return smoke(args, pool)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


def smoke(args, pool) -> int:
    import numpy as np
    import torch
    from repro_torch.core.features import cluster_trace, delta_convergence
    from repro_torch.core.service import PredictorService
    from repro_torch.kernels import build
    from repro_torch.kernels import lane_replay as k1
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain,
                                                     flash_geometry)
    from repro_torch.kernels.hlsh_attention import (hlsh_attention,
                                                    hlsh_attention_plain,
                                                    hlsh_geometry)
    from repro_torch.kernels.int4_matmul import (int4_matmul,
                                                 int4_matmul_plain,
                                                 VARIANTS, int4_variant,
                                                 unpack_int4)
    from repro_torch.kernels.lane_replay import lane_replay
    from repro_torch.uvm import adaptive, paper_tables, sweep
    from repro_torch.uvm import golden as G
    from repro_torch.offload.serve_trace import (serve_latency_columns,
                                                 trace_step_bounds)
    from repro_torch.traces.interleave import (mt_component_trace,
                                               tenant_last_index)
    from repro_torch.uvm.backends.cuda_backend import (PORTED_FAMILIES,
                                                       PORTED_POLICIES,
                                                       lane_family)
    from repro_torch.uvm.config import UVMConfig
    from repro_torch.uvm.prefetchers import (BlockPrefetcher,
                                             LearnedPrefetcher, NoPrefetcher,
                                             OraclePrefetcher,
                                             TreePrefetcher)
    from repro_torch.uvm.replay_core import ReplayRequest, get_backend
    from repro_torch.uvm.scenarios import MT_BENCHES, expand_scenario

    # float32 products in full precision (TF32 off), stated and set
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # ---- phase 1: device and build --------------------------------------
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    card = f"[{smi}]"
    print(f"device: {kind} x{count}; nvidia-smi: {smi}", flush=True)
    t0 = time.perf_counter()
    build.build()
    print(f"phase 1: built {', '.join(build.FLAGS)} with nvcc in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    backend = get_backend("cuda", device="cuda")
    counted = {"lane_replay": lane_replay, "hlsh_attention": hlsh_attention,
               "int4_matmul": int4_matmul, "flash_attention": flash_attention}
    path_launches = {}

    def reset_counts():
        k1.reset_counts()
        for fn in counted.values():
            fn.launches = 0

    def read_counts():
        return {name: fn.launches for name, fn in counted.items()}

    def kind_of(req):
        return lane_family(req.prefetcher).split("/")[0], req.config.eviction

    # ---- phase 2: K1 against the legacy engine ----------------------------
    t0 = time.perf_counter()
    traces = {b: sweep.load_trace(b, 1.0, 0, 0.6) for b in BENCHES}
    makers = {
        "none": lambda tr, cfg: NoPrefetcher(),
        "block": lambda tr, cfg: BlockPrefetcher(),
        "tree": lambda tr, cfg: TreePrefetcher(),
        # perfect distance-32 predictions: the golden cells' stand-in model
        "learned": lambda tr, cfg: LearnedPrefetcher(
            G.perfect_preds(tr), extra_latency_cycles=cfg.cycles_per_us),
        "oracle": lambda tr, cfg: OraclePrefetcher(np.asarray(tr.pages)),
    }
    cells = []
    for bench, tr in traces.items():
        for frac in FRACS:
            cap = None if frac is None else int(tr.working_set_pages * frac)
            for name in ("none", "block", "learned"):
                cells.append((bench, frac, name, tr, UVMConfig(
                    device_pages=cap)))
    for bench in NEW_LANE_BENCHES:
        tr = traces[bench]
        cap = int(tr.working_set_pages * 0.5)
        for policy in PORTED_POLICIES:
            for name in ("tree", "oracle") + (
                    ("none", "block", "learned") if policy != "lru" else ()):
                cells.append((bench, 0.5, name, tr, UVMConfig(
                    device_pages=cap, eviction=policy)))
    requests = [ReplayRequest(tr, makers[name](tr, cfg), cfg)
                for _, _, name, tr, cfg in cells]
    legacy = pool.map(legacy_replay, requests)
    stats = backend.replay(requests)
    torch.cuda.synchronize()
    p2_kinds = set()
    for (bench, frac, name, tr, cfg), req, st, want in zip(
            cells, requests, stats, legacy):
        check(st.backend == "cuda", f"{bench}/{name}: backend {st.backend}")
        same_stats(st, want,
                   f"K1 vs legacy {bench}/{name}/{cfg.eviction}/frac={frac}")
        p2_kinds.add(kind_of(req))
    check(len(p2_kinds) == len(PORTED_FAMILIES) * len(PORTED_POLICIES),
          f"phase 2 covered {sorted(p2_kinds)} only")
    print(f"phase 2: K1 matched the legacy engine on {len(cells)} scale-1.0 "
          f"lanes ({len(backend.pack_lanes(requests))} batches, all "
          f"{len(p2_kinds)} family x policy kinds) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # ---- phase 3: K1 on the golden cells, against the fixture and plain --
    t0 = time.perf_counter()
    with open(GOLDEN) as f:
        golden = json.load(f)["cells"]
    gids = G.golden_cell_ids()
    greqs = []
    for c in gids:
        trace, cfg, factory = G.golden_cell(c)
        greqs.append(ReplayRequest(trace, factory(), cfg))
    gbatches = [(idx, backend.pack_batch([greqs[i] for i in idx]))
                for idx in backend.pack_lanes(greqs)]
    # the plain versions run in the host workers, all at once
    plains = pool.map(plain_replay, [plain_job(b) for _, b in gbatches])
    variants = {}
    k1_err = 0.0
    for (batch_idx, batch), (plain, plain_s) in zip(gbatches, plains):
        key = variant_key(batch)
        err, got = k1_against(batch, plain)
        check(err == 0.0, f"K1 vs plain on the golden {key} batch: max diff "
              f"{err}")
        k1_err = max(k1_err, err)
        for lane, i in enumerate(batch_idx):
            want = golden[gids[i]]
            row = got[lane].tolist()
            for j, f in enumerate(k1.STAT_FIELDS):
                ok = (row[j] == want[f] if f in INT_FIELDS
                      else abs(row[j] - want[f]) <= 1e-6 * abs(want[f]))
                check(ok, f"K1 golden {gids[i]}: {f} {row[j]} != "
                      f"{want[f]}")
            if "tenant_hits" in want:
                th0 = int(row[len(k1.STAT_FIELDS)])
                check([th0, int(row[1]) - th0] == want["tenant_hits"],
                      f"K1 golden {gids[i]}: tenant hits")
        args_ = batch.kernel_args("cuda")
        variants[key] = new_variant(
            key, golden_lanes=len(batch_idx),
            golden_accesses=int(batch.iparams[:, 0].sum()),
            golden_ms=cuda_ms(lambda: lane_replay(**args_), reps=3),
            golden_plain_ms=plain_s * 1e3,
            golden_bound_ms=k1_bound_ms(batch), golden_max_abs_err=err)
    n_base = len(PORTED_FAMILIES) * len(PORTED_POLICIES)
    check(len(variants) == n_base + len(PORTED_FAMILIES),
          f"golden batches covered {sorted(variants)} only")
    print(f"phase 3 {card}: K1 equal to the fixture on {len(gids)} golden "
          f"cells and to its plain version on {len(variants)} batches (max "
          f"diff {k1_err}), in {time.perf_counter() - t0:.1f} s", flush=True)
    for v in variants.values():
        print(f"  golden {v['family']}/{v['policy']}/{v['variant']}: "
              f"{v['golden_lanes']} lanes, {v['golden_accesses']} accesses: "
              f"K1 {v['golden_ms']:.3f} ms, plain {v['golden_plain_ms']:.1f} "
              "ms", flush=True)

    # ---- phase 4: K2 against its plain version ----------------------------
    # K2 in both tilings and both types: the path's shape and the warp
    # tiling's edges (N of 1 and 32, D of 64, odd D with unaligned row
    # spans), the reference's shapes on the general tile; every draw has a
    # row whose keys are all erased and, where N > 32, a whole erased key
    # tile.  bf16 is held against the plain version on float32 copies of
    # the same inputs (K2 keeps its logits in float32, the bf16 plain
    # version rounds them: at the path's shape it is the less exact one),
    # and at the reference's shapes against the bf16 plain version too
    rng = np.random.default_rng(0)
    k2_err = {"float32": 0.0, "bfloat16": 0.0}
    k2_bf16_plain = {}
    k2_geos = {}
    k2_main = None
    for (b, n, d), dt in K2_CASES:
        dt = getattr(torch, dt)
        q = cuda_randn(rng, (b, n, d), dt)
        v = cuda_randn(rng, (b, n, d), dt)
        keep = torch.tensor(rng.random((b, n)) > 0.3, dtype=dt,
                            device="cuda")
        keep[0] = 0.0
        if n > 32:
            keep[:, 32:64] = 0.0
        got = hlsh_attention(q, q, v, keep).float()
        err = float((got - hlsh_attention_plain(
            *(t.float() for t in (q, q, v, keep)))).abs().max())
        name = str(dt).split(".")[1]
        check(err <= K2_ATOL[name], f"K2 ({b},{n},{d}) {name}: max error "
              f"{err} (limit {K2_ATOL[name]})")
        if dt == torch.bfloat16:
            e16 = float((got - hlsh_attention_plain(q, q, v, keep).float()
                         ).abs().max())
            k2_bf16_plain[f"{b}x{n}x{d}"] = e16
            check((b, n, d) not in K2_REF_SHAPES or e16 <= K2_ATOL[name],
                  f"K2 ({b},{n},{d}) bfloat16: max error {e16} from the "
                  f"bf16 plain version (limit {K2_ATOL[name]})")
        k2_err[name] = max(k2_err[name], err)
        geo = hlsh_geometry(b, n, d, dt)
        k2_geos.setdefault((geo.tiling, name), []).append((b, n, d))
        if k2_main is None:
            k2_main = (q, v, keep)
    check(len(k2_geos) == 4, f"K2's cases reach only {sorted(k2_geos)}")
    # K4 at the reference's shapes x causal x both types, and at the
    # Transformer family's shape in its float32
    k4_err = {"float32": 0.0, "bfloat16": 0.0}
    k4_cases = [(shape, causal, dt) for shape in K4_REF_SHAPES
                for causal in (False, True)
                for dt in (torch.float32, torch.bfloat16)]
    k4_cases += [(shape, causal, torch.float32)
                 for shape in (K4_PATH_SHAPE,) + K4_EDGE_SHAPES
                 for causal in (False, True)]
    for shape, causal, dt in k4_cases:
        err, _ = k4_against_plain(rng, shape, causal, dt)
        name = str(dt).split(".")[1]
        check(err <= K4_ATOL[name], f"K4 {shape} causal={causal} {name}: "
              f"max error {err} (limit {K4_ATOL[name]})")
        k4_err[name] = max(k4_err[name], err)
    # bf16 at the path's shape, held against the plain version on float32
    # copies of the same inputs: the bf16 plain version rounds its logits
    # and probabilities to bf16 where K4 keeps them in float32, so at S = 30
    # it is the less exact of the two
    k4_bf16_path = {}
    for causal in (False, True):
        vs_plain, qkv = k4_against_plain(rng, K4_PATH_SHAPE, causal,
                                         torch.bfloat16)
        vs_f32 = float((flash_attention(*qkv, causal=causal).float()
                        - flash_attention_plain(*(t.float() for t in qkv),
                                                causal=causal)
                        ).abs().max())
        check(vs_f32 <= K4_ATOL["bfloat16"], f"K4 {K4_PATH_SHAPE} causal="
              f"{causal} bfloat16: max error {vs_f32} from the float32 "
              f"plain version (limit {K4_ATOL['bfloat16']})")
        k4_bf16_path[f"causal={causal}"] = {"vs_plain": vs_plain,
                                            "vs_float32_plain": vs_f32}
    # K3 at the reference's shapes x both types (random codes), and at the
    # predictor's shapes in float32 on packed weights
    k3_err = {"float32": 0.0, "bfloat16": 0.0}
    k3_abs = 0.0
    k3_cases = [(shape, dt, False) for shape in K3_REF_SHAPES
                for dt in (torch.float32, torch.bfloat16)]
    k3_cases += [(shape, torch.float32, True) for shape in K3_PATH_SHAPES]
    k3_cases += [(shape, getattr(torch, dt), False)
                 for shape, dt in K3_EDGE_CASES]
    reached = {(int4_variant(m, kd, n + n % 2, dt), dt)
               for (m, kd, n), dt, _ in k3_cases}
    missing = [(v, str(dt)) for dt in (torch.float32, torch.bfloat16)
               for v in VARIANTS if (v, dt) not in reached
               and (v, dt) != ("wide32", torch.bfloat16)]
    check(not missing, f"K3's cases reach no case of the bodies {missing}")
    for (m, kd, n), dt, packer in k3_cases:
        err, abs_err, _ = k3_against_plain(rng, m, kd, n, dt, packer)
        name = str(dt).split(".")[1]
        check(err < K3_RTOL[name], f"K3 ({m},{kd},{n}) {name}: relative "
              f"error {err} (limit {K3_RTOL[name]})")
        k3_err[name] = max(k3_err[name], err)
        k3_abs = max(k3_abs, abs_err)
    # x one element into its storage (not 16-byte aligned): the narrow
    # variant's shape takes the general one
    base = cuda_randn(rng, (1000 * 12 + 1,), torch.float32)
    x_off = base[1:].view(1000, 12)
    w_off = torch.tensor(rng.integers(0, 256, (12, 6)), dtype=torch.uint8,
                         device="cuda")
    check(int4_variant(1000, 12, 12, torch.float32, x_off.data_ptr())
          == "general", "K3 on an unaligned x does not take the general "
          "variant")
    err = rel_err(int4_matmul(x_off, w_off, 0.03),
                  int4_matmul_plain(x_off, w_off, 0.03))
    check(err < K3_RTOL["float32"], f"K3 on an unaligned x: relative error "
          f"{err}")
    k3_err["float32"] = max(k3_err["float32"], err)
    # bf16 heads of S x D = 1,500 (every other head's span unaligned),
    # against the float32 plain version on the same inputs
    for causal in (False, True):
        _, qkv = k4_against_plain(rng, (3, 3, 3, 30, 30, 50), causal,
                                  torch.bfloat16)
        err = float((flash_attention(*qkv, causal=causal).float()
                     - flash_attention_plain(*(t.float() for t in qkv),
                                             causal=causal)).abs().max())
        check(err <= K4_ATOL["bfloat16"], f"K4 bf16 (3,3,3,30,30,50) causal="
              f"{causal}: max error {err} from the float32 plain version")
        k4_err["bfloat16"] = max(k4_err["bfloat16"], err)
    torch.cuda.synchronize()
    print(f"phase 4: K2 matched its plain version on {len(K2_CASES)} cases, "
          f"max error {k2_err} (limits {K2_ATOL}; bf16 from the bf16 plain "
          f"version {k2_bf16_plain}; by tiling and type {k2_geos}); K4 on "
          f"{len(k4_cases)} cases, max error "
          f"{k4_err} (limits {K4_ATOL}; bf16 at the path's shape, from "
          f"the float32 plain version and from the bf16 one: "
          + ", ".join(f"{c} {e['vs_float32_plain']:.3g} / "
                      f"{e['vs_plain']:.3g}" for c, e in k4_bf16_path.items())
          + f"); K3 on {len(k3_cases)} cases, relative "
          f"error {k3_err} (limits {K3_RTOL})", flush=True)

    # ---- phase 5: the main path -----------------------------------------
    for bench in BENCHES:
        conv = delta_convergence(cluster_trace(traces[bench], "sm"))
        print(f"  {bench}: delta convergence {conv:.3f} -> "
              f"{'bypass' if conv >= 0.7 else 'hlsh'}", flush=True)
    grid = sweep.expand_grid(BENCHES, ["none", "tree", "learned"],
                             scales=[1.0], windows=[0.6],
                             device_fracs=list(FRACS),
                             service_steps=paper_tables.SERVICE_STEPS)
    reset_counts()
    t0 = time.perf_counter()
    rows = sweep.run_sweep(grid, device="cuda")
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = path_launches["main"] = read_counts()
    print(f"phase 5: main path, {len(rows)} rows in {main_s:.1f} s; "
          f"launches {launches} (K1 by family/policy "
          f"{dict(lane_replay.launches_by)})", flush=True)
    print("bench,prefetcher,frac,hit_rate,faults,pcie_bytes,accuracy,"
          "coverage,unity,backend,train_s,predict_s,replay_s")
    for r in rows:
        print(f"{r['bench']},{r['prefetcher']},{r['device_frac']},"
              f"{r['hit_rate']:.4f},{r['faults']},{r['pcie_bytes']:.0f},"
              f"{r['accuracy']:.4f},{r['coverage']:.4f},{r['unity']:.4f},"
              f"{r['backend']},{r['train_seconds']:.2f},"
              f"{r['predict_seconds']:.2f},{r['seconds']:.4f}")
    check(all(r["backend"] == "cuda" for r in rows),
          "a main-path row did not run on the cuda backend")
    check(launches["lane_replay"] > 0, "K1 never launched on the main path")
    check(launches["hlsh_attention"] > 0,
          "K2 never launched on the main path")
    check(launches["int4_matmul"] > 0,
          "K3 never launched on the main path's quantized inference")
    learned_reqs = []
    legacy_tree = {}
    checked = [(cell, r) for cell, r in zip(grid, rows)
               if cell.prefetcher != "none"]
    creqs = [ReplayRequest(trace, pf, config) for trace, config, pf, _ in
             (sweep.prepare_cell(cell, device="cuda") for cell, _ in checked)]
    for (cell, r), req, want in zip(checked, creqs,
                                    pool.map(legacy_replay, creqs)):
        same_row(r, want, f"main path {cell.bench}/{cell.prefetcher}/"
                 f"{cell.device_frac}")
        if cell.prefetcher == "learned":
            learned_reqs.append(req)
        elif cell.device_frac is None:
            legacy_tree[cell.bench] = want
    # K1's plain version on the main path's learned batch runs in a host
    # worker while the card drives the later paths (compared in phase 12)
    k1_batch = backend.pack_batch(
        [learned_reqs[i] for i in backend.pack_lanes(learned_reqs)[0]])
    main_plain = pool.submit(plain_replay, plain_job(k1_batch))
    print(f"phase 5: {len(learned_reqs)} learned and {2 * len(legacy_tree)} "
          "tree rows equal the legacy engine on the same inputs", flush=True)

    # ---- phase 6: the paper's Table 10 and Table 11 -----------------------
    reset_counts()
    t0 = time.perf_counter()
    t10, t11 = paper_tables.run(BENCHES, device="cuda")
    tables_s = time.perf_counter() - t0
    path_launches["tables"] = read_counts()
    tables_launches = lane_replay.launches
    check(tables_launches > 0, "K1 never launched for the paper tables")
    print(f"phase 6: Table 10 (page hit rate, U=UVMSmart tree, R=learned), "
          f"K1 launches {tables_launches}, {tables_s:.1f} s")
    print("bench,hit_U,hit_R,simulated_inst")
    for r in t10:
        print(f"{r['bench']},{r['hit_U']:.4f},{r['hit_R']:.4f},"
              f"{r['simulated_inst']}")
        check(r["hit_U"] == legacy_tree[r["bench"]].hit_rate,
              f"Table 10 {r['bench']}: tree hit rate {r['hit_U']} != legacy "
              f"{legacy_tree[r['bench']].hit_rate}")
    print(f"MEAN,{np.mean([r['hit_U'] for r in t10]):.4f},"
          f"{np.mean([r['hit_R'] for r in t10]):.4f},")
    print("phase 6: Table 11 (Unity = cbrt(accuracy x coverage x hit rate))")
    print("bench,prefetcher,acc,cov,hit,unity")
    for r in t11:
        print(f"{r['bench']},{r['prefetcher']},{r['acc']:.4f},"
              f"{r['cov']:.4f},{r['hit']:.4f},{r['unity']:.4f}")
        if r["prefetcher"] == "U" and r["bench"] != "MEAN":
            want = legacy_tree[r["bench"]]
            check((r["acc"], r["cov"], r["hit"], r["unity"]) == (
                want.accuracy, want.coverage, want.hit_rate, want.unity),
                f"Table 11 {r['bench']}: tree row != legacy")
    by_bench = {r["bench"]: r for r in rows
                if r["prefetcher"] == "learned" and r["device_frac"] is None}
    for r in t10:
        check(r["hit_R"] == by_bench[r["bench"]]["hit_rate"],
              f"Table 10 {r['bench']}: learned hit rate differs from the "
              "main path's row (checked against the legacy engine)")
    print("phase 6: every tree row equals the legacy engine's; every "
          "learned row equals the main path's", flush=True)

    # ---- phase 7: the oversub-full matrix ---------------------------------
    matrix = expand_scenario("oversub-full")
    reset_counts()
    t0 = time.perf_counter()
    mrows = sweep.run_sweep(matrix, device="cuda")
    torch.cuda.synchronize()
    matrix_s = time.perf_counter() - t0
    path_launches["oversub-full"] = read_counts()
    matrix_launches = lane_replay.launches
    matrix_by = dict(lane_replay.launches_by)
    replay_s = sum(r["seconds"] for r in mrows)
    check(len(mrows) == 660, f"oversub-full gave {len(mrows)} rows")
    check(all(r["backend"] == "cuda" for r in mrows),
          "an oversub-full row did not run on the cuda backend")
    check(matrix_launches > 0, "K1 never launched on oversub-full")
    # the matrix's requests, prepared once: the lane batches as run_sweep
    # packed them, the 2DCONV legacy check and the phase-8 timings
    mreqs = [ReplayRequest(trace, pf, config) for trace, config, pf, _ in
             (sweep.prepare_cell(c, device="cuda") for c in matrix)]
    mbatches = backend.pack_lanes(mreqs)
    lanes_per = {}
    for b in mbatches:
        lanes_per.setdefault(kind_of(mreqs[b[0]]), []).append(len(b))
    check({k: len(v) for k, v in lanes_per.items()} == matrix_by,
          f"lane batches per kind {lanes_per} != K1 launches {matrix_by}")
    print(f"phase 7 {card}: oversub-full, {len(mrows)} rows, all on cuda, "
          f"in {matrix_s:.1f} s (replay {replay_s:.1f} s, prepare "
          f"{matrix_s - replay_s:.1f} s); K1 launches {matrix_launches}",
          flush=True)
    for key in sorted(lanes_per):
        print(f"  {key[0]}/{key[1]}: {matrix_by.get(key, 0)} launches, "
              f"lanes per launch {lanes_per[key]}")
    print("prefetcher,eviction,ratio,mean_hit_rate,mean_unity,"
          "mean_pages_evicted")
    for pf in sweep.PREFETCHERS:
        for ev in PORTED_POLICIES:
            for ratio in sorted({c.device_frac for c in matrix}):
                sel = [r for c, r in zip(matrix, mrows) if c.prefetcher == pf
                       and c.eviction == ev and c.device_frac == ratio]
                print(f"{pf},{ev},{ratio},"
                      f"{np.mean([r['hit_rate'] for r in sel]):.4f},"
                      f"{np.mean([r['unity'] for r in sel]):.4f},"
                      f"{np.mean([r['pages_evicted'] for r in sel]):.0f}")
    chk = [i for i, c in enumerate(matrix) if c.bench == MATRIX_CHECK_BENCH]
    for i, want in zip(chk, pool.map(legacy_replay, [mreqs[i] for i in chk])):
        cell = matrix[i]
        same_row(mrows[i], want, f"oversub-full {cell.bench}/"
                 f"{cell.prefetcher}/{cell.eviction}/{cell.device_frac}")
    n_checked = len(chk)
    print(f"phase 7: the {n_checked} {MATRIX_CHECK_BENCH} rows equal the "
          f"legacy engine", flush=True)

    # ---- phase 8: K1 with step clocks against the legacy engine ---------
    t0 = time.perf_counter()
    sreqs = []
    for bench in STEP_CHECK_BENCHES:
        tr = sweep.load_trace(bench, 1.0, 0, None)
        bounds = trace_step_bounds(tr)
        cap = int(tr.working_set_pages * 0.5)
        for name in sweep.PREFETCHERS:
            for policy in PORTED_POLICIES:
                cfg = UVMConfig(device_pages=cap, eviction=policy)
                sreqs.append(ReplayRequest(tr, makers[name](tr, cfg), cfg,
                                           step_bounds=bounds))
    k1_s = time.perf_counter()
    stats = backend.replay(sreqs)
    torch.cuda.synchronize()
    k1_s = time.perf_counter() - k1_s
    empty = {}
    for req, st, want in zip(sreqs, stats, pool.map(legacy_replay, sreqs)):
        what = (f"K1 step clocks vs legacy {req.trace.name}/"
                f"{type(req.prefetcher).__name__}/{req.config.eviction}")
        check(st.backend == "cuda" and st.step_clocks is not None, what)
        same_stats(st, want, what)
        sizes = np.diff(np.concatenate([[0], req.step_bounds]))
        empty[req.trace.name] = int((sizes == 0).sum())
    p8_kinds = {variant_key(backend.pack_batch([r])) for r in sreqs}
    check(len(p8_kinds) == n_base, f"phase 8 covered {sorted(p8_kinds)}")
    print(f"phase 8 {card}: K1 step clocks equal the legacy engine's bit for "
          f"bit on {len(sreqs)} scale-1.0 serve lanes ({len(p8_kinds)} "
          f"family x policy kinds; empty windows per trace {empty}); K1 "
          f"{k1_s:.1f} s, whole phase {time.perf_counter() - t0:.1f} s",
          flush=True)

    # ---- phase 9: K1 with tenant quotas against the legacy engine --------
    t0 = time.perf_counter()
    qreqs = []
    for pair in MT_BENCHES:
        tr = sweep.load_trace(pair, 1.0, 0, 0.6)
        bounds = sweep._mt_step_bounds(tr)
        cap = int(tr.working_set_pages * QUOTA_CHECK_RATIO)
        for f0, f1 in QUOTA_CHECK_SPLITS:
            for name in sweep.PREFETCHERS:
                for policy in PORTED_POLICIES:
                    cfg = UVMConfig(device_pages=cap, eviction=policy,
                                    tenant_pages=(int(f0 * cap),
                                                  int(f1 * cap)))
                    qreqs.append(ReplayRequest(tr, makers[name](tr, cfg),
                                               cfg, step_bounds=bounds))
    # the legacy engine is slow on quota lanes: start it first
    q_legacy = pool.map(legacy_replay, qreqs)
    k1_s = time.perf_counter()
    stats = backend.replay(qreqs)
    torch.cuda.synchronize()
    k1_s = time.perf_counter() - k1_s
    # K1 against its plain version on a small batch of each new variant:
    # a step-clock lane of ServeBursty@r8 and a quota lane with the
    # tenants' completion clocks of ATAX+Pathfinder, both at scale 0.25
    small = []
    serve_small = sweep.load_trace("ServeBursty@r8", 0.25, 0, None)
    mt_small = sweep.load_trace("ATAX+Pathfinder", 0.25, 0, 0.6)
    for name in sweep.PREFETCHERS:
        for policy in PORTED_POLICIES:
            cap = int(serve_small.working_set_pages * 0.5)
            cfg = UVMConfig(device_pages=cap, eviction=policy)
            small.append([ReplayRequest(
                serve_small, makers[name](serve_small, cfg), cfg,
                step_bounds=trace_step_bounds(serve_small))])
            cap = int(mt_small.working_set_pages * 0.6)
            cfg = UVMConfig(device_pages=cap, eviction=policy,
                            tenant_pages=(int(0.4 * cap), int(0.4 * cap)))
            small.append([ReplayRequest(
                mt_small, makers[name](mt_small, cfg), cfg,
                step_bounds=sweep._mt_step_bounds(mt_small))])
    small = [b for b in small
             if type(b[0].prefetcher).__name__ != "BlockPrefetcher"]
    sbatches = [backend.pack_batch(reqs) for reqs in small]
    plains = pool.map(plain_replay, [plain_job(b) for b in sbatches])
    for req, st, want in zip(qreqs, stats, q_legacy):
        what = (f"K1 quotas vs legacy {req.trace.name}/"
                f"{type(req.prefetcher).__name__}/{req.config.eviction}/"
                f"{req.config.tenant_pages}")
        check(st.backend == "cuda" and st.tenant_hits is not None, what)
        same_stats(st, want, what)
    p9_kinds = {variant_key(backend.pack_batch([r])) for r in qreqs}
    check(len(p9_kinds) == n_base, f"phase 9 covered {sorted(p9_kinds)}")
    for batch, (plain, plain_s) in zip(sbatches, plains):
        key = variant_key(batch)
        err, _ = k1_against(batch, plain)
        check(err == 0.0, f"K1 vs plain on the small {key} batch: max diff "
              f"{err}")
        k1_err = max(k1_err, err)
        args_ = batch.kernel_args("cuda")
        variants.setdefault(key, new_variant(key)).update(
            plain_lanes=int((batch.iparams[:, 0] > 0).sum()),
            plain_accesses=int(batch.iparams[:, 0].sum()),
            plain_k1_ms=cuda_ms(lambda: lane_replay(**args_), reps=3),
            plain_ms=plain_s * 1e3, plain_bound_ms=k1_bound_ms(batch),
            plain_max_abs_err=err)
    print(f"phase 9 {card}: K1 with quotas equals the legacy engine on "
          f"{len(qreqs)} scale-1.0 lanes of the {len(MT_BENCHES)} pairs "
          f"(ratio {QUOTA_CHECK_RATIO}, splits {QUOTA_CHECK_SPLITS}; "
          f"{len(p9_kinds)} kinds), and its plain version on "
          f"{len(sbatches)} small step-clock and quota batches (max diff "
          f"{k1_err}); K1 {k1_s:.1f} s, whole phase "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # ---- phase 10: the serve-full matrix --------------------------------
    scells = expand_scenario("serve-full")
    reset_counts()
    t0 = time.perf_counter()
    srows = sweep.run_sweep(scells, device="cuda")
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    path_launches["serve-full"] = read_counts()
    serve_launches = lane_replay.launches
    serve_by = dict(lane_replay.launches_by)
    check(len(srows) == 300, f"serve-full gave {len(srows)} rows")
    check(serve_launches > 0 and all("steps" in k for k in serve_by),
          f"serve-full K1 launches {serve_by}")
    for r in srows:
        what = f"serve-full {r['bench']}/{r['prefetcher']}/{r['eviction']}"
        check(r["backend"] == "cuda" and r["slo_source"] == "kernel",
              f"{what}: backend {r['backend']}, slo {r['slo_source']}")
        for m in ("decode_lat", "ttft"):
            ps = [r[f"{m}_p{q}_us"] for q in (50, 95, 99)]
            check(None not in ps and ps[0] <= ps[1] <= ps[2],
                  f"{what}: {m} percentiles {ps}")
    sprep = [sweep.prepare_cell(c, device="cuda") for c in scells]
    sreqs = [ReplayRequest(tr, pf, cfg, step_bounds=sweep._step_bounds(tr))
             for tr, cfg, pf, _ in sprep]
    serve_batches = path_batches(backend, sreqs)
    check({k: len(v) for k, v in serve_batches.items()} == serve_by,
          f"serve-full lane batches != K1 launches {serve_by}")
    chk = [i for i, c in enumerate(scells) if c.bench == SERVE_CHECK_BENCH]
    for i, want in zip(chk, pool.map(legacy_replay, [sreqs[i] for i in chk])):
        r, (tr, cfg, _, _) = srows[i], sprep[i]
        same_row(r, want, f"serve-full {r['bench']}/{r['prefetcher']}/"
                 f"{r['eviction']}/{r['device_frac']}")
        for f, v in serve_latency_columns(tr, want.step_clocks, cfg).items():
            check(r[f] == v, f"serve-full {r['bench']}/{r['prefetcher']}: "
                  f"{f} {r[f]} != legacy {v}")
    serve_train = sum(r["train_seconds"] for r in srows)
    serve_replay = sum(r["seconds"] for r in srows)
    print(f"phase 10 {card}: serve-full, {len(srows)} rows, all on cuda "
          f"with kernel step clocks and ordered percentiles, in "
          f"{serve_s:.1f} s (training {serve_train:.1f} s, replay "
          f"{serve_replay:.1f} s); K1 launches {serve_launches}; the "
          f"{len(chk)} {SERVE_CHECK_BENCH} rows equal the legacy engine",
          flush=True)
    print("bench,prefetcher,eviction,ratio,hit_rate,decode_p50_us,"
          "decode_p99_us,ttft_p50_us,ttft_p99_us")
    for r in srows:
        if r["device_frac"] in (1.0, 0.5):
            print(f"{r['bench']},{r['prefetcher']},{r['eviction']},"
                  f"{r['device_frac']},{r['hit_rate']:.4f},"
                  f"{r['decode_lat_p50_us']:.1f},{r['decode_lat_p99_us']:.1f},"
                  f"{r['ttft_p50_us']:.1f},{r['ttft_p99_us']:.1f}")

    # ---- phase 11: the mt-full matrix -----------------------------------
    tcells = expand_scenario("mt-full")
    reset_counts()
    t0 = time.perf_counter()
    trows = sweep.run_sweep(tcells, device="cuda")
    torch.cuda.synchronize()
    mt_s = time.perf_counter() - t0
    path_launches["mt-full"] = read_counts()
    mt_launches = lane_replay.launches
    mt_by = dict(lane_replay.launches_by)
    check(len(trows) == 360, f"mt-full gave {len(trows)} rows")
    for r in trows:
        what = (f"mt-full {r['bench']}/{r['prefetcher']}/{r['eviction']}/"
                f"{r['capacity_split']}/{r['device_frac']}")
        check(r["backend"] == "cuda", f"{what}: backend {r['backend']}")
        sds = [r[f] for f in ("hit_rate_t0", "hit_rate_t1", "slowdown_t0",
                              "slowdown_t1")]
        check(all(isinstance(x, float) for x in sds), f"{what}: {sds}")
        check(r["interference_slowdown"] == max(sds[2:]),
              f"{what}: interference {r['interference_slowdown']}")
    tprep = [sweep.prepare_cell(c, device="cuda") for c in tcells]
    treqs = [ReplayRequest(tr, pf, cfg, step_bounds=sweep._step_bounds(tr))
             for tr, cfg, pf, _ in tprep]
    solos, _ = sweep._solo_requests(tcells, tprep, [{} for _ in tcells],
                                    None, "cuda")
    # the cells' lanes and the solo replays' lanes pack into exactly the
    # batches K1 launched: no replay of the path ran outside K1
    mt_batches = path_batches(backend, treqs + list(solos.values()))
    check({k: len(v) for k, v in mt_batches.items()} == mt_by,
          f"mt-full lane batches != K1 launches {mt_by}")
    mt_lanes = sum(int((b.iparams[:, 0] > 0).sum())
                   for bs in mt_batches.values() for b in bs)
    # the MVT+StreamTriad rows against the legacy engine, solo replays too
    chk = [i for i, c in enumerate(tcells) if c.bench == MT_CHECK_BENCH]
    solo_want = {}
    for i in chk:
        cell, (tr, cfg, _, dp) = tcells[i], tprep[i]
        for t in range(2):
            cap = sweep._solo_capacity(cfg, dp, t)
            key = sweep._solo_key(cell, t, cap, cfg.eviction)
            if key not in solo_want:
                solo = mt_component_trace(tr, t)
                scfg = UVMConfig(prediction_overhead_us=cell.prediction_us,
                                 device_pages=cap, eviction=cfg.eviction)
                solo_want[key] = ReplayRequest(solo, sweep.make_prefetcher(
                    cell, solo, scfg, None, "cuda"), scfg)
    jobs = [treqs[i] for i in chk] + list(solo_want.values())
    legacy = list(pool.map(legacy_replay, jobs))
    solo_cycles = dict(zip(solo_want, (int(st.cycles)
                                       for st in legacy[len(chk):])))
    for i, want in zip(chk, legacy):
        r, cell, (tr, cfg, _, dp) = trows[i], tcells[i], tprep[i]
        what = (f"mt-full {r['bench']}/{r['prefetcher']}/{r['eviction']}/"
                f"{r['capacity_split']}/{r['device_frac']}")
        same_row(r, want, what)
        last = tenant_last_index(tr)
        bounds = list(sweep._mt_step_bounds(tr))
        for t in range(2):
            th, ta = want.tenant_hits[t], want.tenant_accesses[t]
            check(r[f"hit_rate_t{t}"] == th / ta, f"{what}: hit rate t{t}")
            solo = solo_cycles[sweep._solo_key(
                cell, t, sweep._solo_capacity(cfg, dp, t), cfg.eviction)]
            sd = float(want.step_clocks[bounds.index(last[t] + 1)]) / solo
            check(abs(r[f"slowdown_t{t}"] - sd) <= 1e-6 * sd,
                  f"{what}: slowdown t{t} {r[f'slowdown_t{t}']} != legacy "
                  f"{sd}")
    mt_train = sum(r["train_seconds"] for r in trows)
    mt_replay = sum(r["seconds"] for r in trows)
    print(f"phase 11 {card}: mt-full, {len(trows)} rows, all on cuda with "
          f"per-tenant hit rates and slowdowns, in {mt_s:.1f} s (training "
          f"{mt_train:.1f} s, replay {mt_replay:.1f} s); K1 launches "
          f"{mt_launches}, {mt_lanes} lanes ({len(solos)} solo replays); "
          f"the {len(chk)} {MT_CHECK_BENCH} rows and their "
          f"{len(solo_want)} solo replays equal the legacy engine",
          flush=True)
    print("split,prefetcher,eviction,mean_hit_t0,mean_hit_t1,"
          "mean_slowdown_t0,mean_slowdown_t1,max_interference")
    for split in ("shared", "0.5/0.5", "0.4/0.4"):
        for pf in sweep.PREFETCHERS:
            for ev in PORTED_POLICIES:
                sel = [r for r in trows if r["capacity_split"] == split
                       and r["prefetcher"] == pf and r["eviction"] == ev]
                print(f"{split},{pf},{ev},"
                      f"{np.mean([r['hit_rate_t0'] for r in sel]):.4f},"
                      f"{np.mean([r['hit_rate_t1'] for r in sel]):.4f},"
                      f"{np.mean([r['slowdown_t0'] for r in sel]):.4f},"
                      f"{np.mean([r['slowdown_t1'] for r in sel]):.4f},"
                      f"{max(r['interference_slowdown'] for r in sel):.4f}")

    # ---- phase 12: transformer-smoke under the committed selector --------
    xcells = expand_scenario("transformer-smoke")
    with open(SELECTOR) as f:
        selector = json.load(f)["selector"]
    os.environ["REPRO_ADAPTIVE_TABLE"] = SELECTOR
    try:
        reset_counts()
        t0 = time.perf_counter()
        xrows = sweep.run_sweep(xcells, device="cuda")
        torch.cuda.synchronize()
        smoke_s = time.perf_counter() - t0
        path_launches["transformer-smoke"] = read_counts()
        xprep = [sweep.prepare_cell(c, device="cuda") for c in xcells]
    finally:
        del os.environ["REPRO_ADAPTIVE_TABLE"]
    # the assertions of scripts/ci_check.sh on the same scenario
    check(len(xrows) == 4, f"transformer-smoke gave {len(xrows)} rows")
    check(all(r["backend"] == "cuda" for r in xrows),
          "a transformer-smoke row did not run on the cuda backend")
    fams = {r["model_family"] for r in xrows}
    check(fams == {"simplified", FAMILY}, f"transformer-smoke families {fams}")
    check(not [r for r in xrows if r["eviction"] == "adaptive"],
          "a transformer-smoke row recorded the adaptive literal")
    by_bench = {}
    for r in xrows:
        by_bench.setdefault(r["bench"], set()).add(r["eviction"])
    check(by_bench == {b: {selector[b]} for b in by_bench},
          f"transformer-smoke evictions {by_bench} != the selector's picks")
    smoke_counts = path_launches["transformer-smoke"]
    check(smoke_counts["flash_attention"] > 0
          and smoke_counts["int4_matmul"] > 0,
          f"transformer-smoke launches {smoke_counts}: K4 (Transformer "
          "inference) or K3 (quantized simplified inference) never ran")
    xreqs = [ReplayRequest(tr, pf, cfg) for tr, cfg, pf, _ in xprep]
    for r, want in zip(xrows, pool.map(legacy_replay, xreqs)):
        same_row(r, want, f"transformer-smoke {r['bench']}/"
                 f"{r['model_family']}")
    print(f"phase 12 {card}: transformer-smoke, {len(xrows)} rows on cuda in "
          f"{smoke_s:.1f} s, families {sorted(fams)}, evictions "
          f"{ {b: sorted(p) for b, p in by_bench.items()} } as "
          f"ADAPTIVE_selector.json picks; launches {smoke_counts}; every "
          "row equals the legacy engine on the same inputs", flush=True)

    # ---- phase 13: the Transformer family at full width --------------------
    fcells = sweep.expand_grid(BENCHES, ["learned"], scales=[1.0],
                               windows=[0.6], device_fracs=list(FRACS),
                               evictions=["adaptive"],
                               model_families=[FAMILY],
                               service_steps=paper_tables.SERVICE_STEPS)
    check("REPRO_ADAPTIVE_TABLE" not in os.environ,
          "the family path must probe: no selector table")
    reset_counts()
    t0 = time.perf_counter()
    frows = sweep.run_sweep(fcells, device="cuda")
    torch.cuda.synchronize()
    family_s = time.perf_counter() - t0
    family_counts = path_launches["family"] = read_counts()
    check(len(frows) == 2 * len(BENCHES), f"family path gave {len(frows)} "
          "rows")
    check(all(r["backend"] == "cuda" and r["model_family"] == FAMILY
              for r in frows), "a family-path row is off cuda or the family")
    check(family_counts["flash_attention"] > 0,
          f"K4 never launched on the family path: {family_counts}")
    # every probe-resolved policy against the legacy engine's probe
    probe_jobs = []
    for cell, r in zip(fcells, frows):
        if cell.device_frac is None:
            check(r["eviction"] == "lru", f"family {cell.bench}: no eviction "
                  f"pressure but {r['eviction']}")
            continue
        tr = traces[cell.bench]
        dp = int(tr.working_set_pages * cell.device_frac)
        probe_jobs.append((cell, r, tr, dp))
    preqs = [adaptive.probe_requests(tr, dp, adaptive.PROBE_ACCESSES,
                                     adaptive.probe_proxy("learned"))
             for _, _, tr, dp in probe_jobs]
    plegacy = iter(pool.map(legacy_replay, [q for qs in preqs for q in qs]))
    for (cell, r, tr, dp), qs in zip(probe_jobs, preqs):
        cycles = tuple(float(next(plegacy).cycles) for _ in qs)
        got = adaptive.probed(tr, dp, "learned")
        check(got == (adaptive.pick(cycles), cycles)
              and r["eviction"] == got[0],
              f"family {cell.bench}: K1 probe {got}, row {r['eviction']}, "
              f"legacy probe {adaptive.pick(cycles)} {cycles}")
    resolved = {j[0].bench: j[1]["eviction"] for j in probe_jobs}
    family_train = sum(r["train_seconds"] for r in frows)
    print(f"phase 13 {card}: {FAMILY} family, {len(frows)} rows on cuda in "
          f"{family_s:.1f} s (training {family_train:.1f} s, "
          f"{sum(1 for r in frows if r['train_seconds'])} fits); launches "
          f"{family_counts}; adaptive at half the working set resolved by "
          f"{len(probe_jobs)} probes on K1 to {resolved}, each equal to the "
          "legacy engine's probe, cycles included", flush=True)
    # the family comparison of benchmarks/family_accuracy.py, from the fits
    # of the main path (simplified) and of this path (the family): each
    # fit's metrics stand on the row of the cell that trained it
    family_cmp = []
    print("bench,family,top1,f1,coverage,hit_rate_half")
    for bench in BENCHES:
        learned = [r for r in rows + frows
                   if r["bench"] == bench and r["prefetcher"] == "learned"]
        half = {r["model_family"]: r for r in learned
                if r["device_frac"] == 0.5}
        fits = {r["model_family"]: r for r in learned if "fit_top1" in r}
        entry = {"bench": bench}
        for fam in ("simplified", FAMILY):
            check(fam in fits, f"no {fam} fit for {bench} on its path")
            m = {k: fits[fam][f"fit_{k}"] for k in ("top1", "f1", "coverage")}
            entry[fam] = dict(m, hit_rate_half=half[fam]["hit_rate"])
            print(f"{bench},{fam},{m['top1']:.4f},{m['f1']:.4f},"
                  f"{m['coverage']:.4f},{half[fam]['hit_rate']:.4f}")
        entry["bar_held"] = (entry[FAMILY]["top1"]
                             >= entry["simplified"]["top1"] - 1e-9)
        family_cmp.append(entry)
    held = [e["bench"] for e in family_cmp if e["bar_held"]]
    print(f"phase 13: the reference's bar ({FAMILY} top-1 >= simplified "
          f"top-1) held on {len(held)} of {len(family_cmp)} benches; missed "
          f"on {[e['bench'] for e in family_cmp if not e['bar_held']]} "
          "(reported, not a check: the port's training draws are torch's)",
          flush=True)

    # ---- phase 14: kernel times -----------------------------------------
    # K1 on the tables' tree batch (11 scale-1.0 lanes, no evictions)
    # against its plain version: the tree family at a driven path's shapes.
    # Its slowest lane sets K1's chain bound: a lane is one dependent chain
    # of accesses, so a batch takes at least its longest lane's accesses
    # times the time an access takes in a lane that never evicts
    treqs = []
    for bench in BENCHES:
        trace, config, pf, _ = sweep.prepare_cell(
            paper_tables.eval_cell(bench, "tree"), device="cuda")
        treqs.append(ReplayRequest(trace, pf, config))
    (tidx,) = backend.pack_lanes(treqs)
    t_batch = backend.pack_batch([treqs[i] for i in tidx])
    err, _, t_plain_s = k1_vs_plain(t_batch)
    check(err == 0.0, f"K1 vs plain on the tables' tree batch: max diff "
          f"{err}")
    k1_err = max(k1_err, err)
    t_args = t_batch.kernel_args("cuda")
    t_out, t_lane = k1_lanes(t_batch)
    check(int(t_out[:, 7].max()) == 0, "the tables' tree batch evicted")
    access_us = t_lane["us"] / t_lane["accesses"]

    def chain_bound_ms(batch):
        return int(batch.iparams[:, 0].max()) * access_us / 1e3

    variants[("tree", "lru")].update(
        tables_lanes=len(tidx),
        tables_accesses=int(t_batch.iparams[:, 0].sum()),
        tables_ms=cuda_ms(lambda: lane_replay(**t_args), reps=3),
        tables_plain_ms=t_plain_s * 1e3, tables_bound_ms=k1_bound_ms(t_batch),
        tables_chain_bound_ms=chain_bound_ms(t_batch),
        tables_slowest_lane=t_lane, tables_max_abs_err=err)
    tv = variants[("tree", "lru")]
    print(f"phase 14 {card}: K1 tree/lru {tv['tables_ms']:.3f} ms per launch "
          f"on the tables' tree batch ({len(tidx)} lanes, "
          f"{tv['tables_accesses']} accesses; {lane_text(t_lane)}), equal to "
          f"its plain version ({tv['tables_plain_ms']:.1f} ms on the host); "
          f"chain bound {access_us * 1e3:.1f} ns per access", flush=True)
    # K1 per family x policy on the largest batch of the matrix
    for key, v in variants.items():
        if len(key) > 2:
            continue
        cand = [b for b in mbatches if kind_of(mreqs[b[0]]) == key]
        big = max(cand, key=lambda b: sum(len(mreqs[i].trace) for i in b))
        batch = backend.pack_batch([mreqs[i] for i in big])
        args_ = batch.kernel_args("cuda")
        _, lane = k1_lanes(batch)
        v.update(matrix_launches=matrix_by.get(key, 0),
                 matrix_lanes=len(big),
                 matrix_accesses=int(batch.iparams[:, 0].sum()),
                 ms=cuda_ms(lambda: lane_replay(**args_), reps=2),
                 bound_ms=k1_bound_ms(batch),
                 chain_bound_ms=chain_bound_ms(batch), slowest_lane=lane)
        v["chain_share"] = v["chain_bound_ms"] / v["ms"]
        print(f"phase 14 {card}: K1 {key[0]}/{key[1]} {v['ms']:.2f} ms per "
              f"launch on the matrix's largest batch ({len(big)} lanes, "
              f"{v['matrix_accesses']} accesses; {lane_text(lane)}; chain "
              f"bound {v['chain_bound_ms']:.2f} ms, "
              f"{100 * v['chain_share']:.0f}% of it; bytes bound "
              f"{v['bound_ms']:.5f} ms); golden batch {v['golden_ms']:.3f} "
              f"ms, plain {v['golden_plain_ms']:.1f} ms", flush=True)
    # the step-clock and quota variants on the largest batch of each path,
    # with the slowest lane's evictions; the serve batches also without
    # their step capture, and the shared multi-tenant batches also through
    # the quota specialisation, to cost each variant's own branch on the
    # same lanes
    for path, by_key, by in (("serve", serve_batches, serve_by),
                             ("mt", mt_batches, mt_by)):
        for key, batches in sorted(by_key.items()):
            big = max(batches, key=lambda b: int(b.iparams[:, 0].sum()))
            args_ = big.kernel_args("cuda")
            out, lane = k1_lanes(big)
            v = variants.setdefault(key, new_variant(key))
            v.update({f"{path}_launches": by.get(key, 0),
                      f"{path}_lanes": int((big.iparams[:, 0] > 0).sum()),
                      f"{path}_accesses": int(big.iparams[:, 0].sum()),
                      f"{path}_max_lane_evictions": int(out[:, 7].max()),
                      f"{path}_slowest_lane": lane,
                      f"{path}_ms": cuda_ms(lambda: lane_replay(**args_),
                                            reps=1),
                      f"{path}_bound_ms": k1_bound_ms(big),
                      f"{path}_chain_bound_ms": chain_bound_ms(big)})
            same = None
            if key[2:] == ("steps",):
                other = (dataclasses.replace(big, sids=None, steps_len=0)
                         if path == "serve"
                         else dataclasses.replace(big, quotas=True))
                o_args = other.kernel_args("cuda")
                same = "without steps" if path == "serve" else "as quotas"
                v[f"{path}_ms_{same.replace(' ', '_')}"] = cuda_ms(
                    lambda: lane_replay(**o_args), reps=1)
            print(f"phase 14 {card}: K1 {'/'.join(key)} "
                  f"{v[path + '_ms']:.2f} ms per launch on {path}-full's "
                  f"largest batch ({v[path + '_lanes']} lanes, "
                  f"{v[path + '_accesses']} accesses, at most "
                  f"{v[path + '_max_lane_evictions']} evictions a lane; "
                  f"{lane_text(lane)}; chain bound "
                  f"{v[path + '_chain_bound_ms']:.2f} ms, "
                  f"{100 * v[path + '_chain_bound_ms'] / v[path + '_ms']:.0f}"
                  f"% of it); {v[path + '_launches']} launches"
                  + ("" if same is None else
                     f"; {same}: "
                     f"{v[path + '_ms_' + same.replace(' ', '_')]:.2f} ms"),
                  flush=True)
    # the victim search against the span: one serve lane (ServeDecode,
    # tree/lru at half its working set), its pages moved up by whole spans
    # so that the search covers more empty chunks while the replay stays
    # the same (lru and the tree's node counts see only page differences
    # within 2 MB windows)
    tr = sweep.load_trace("ServeDecode", 1.0, 0, None)
    cfg = UVMConfig(device_pages=int(tr.working_set_pages * 0.5))
    base = backend.pack_batch([ReplayRequest(tr, TreePrefetcher(), cfg)])
    base_out = None
    scan_span = []
    for extra in (0, 1, 3, 7):
        shifted = dataclasses.replace(
            base, pages=base.pages + extra * base.span,
            span=base.span * (1 + extra))
        s_args = shifted.kernel_args("cuda")
        out, lane = k1_lanes(shifted)
        base_out = out if base_out is None else base_out
        check(torch.equal(out, base_out), f"the shifted lane (span "
              f"{shifted.span}) replays differently")
        ms = cuda_ms(lambda: lane_replay(**s_args), reps=2)
        ev = float(out[0, 7])
        scan_span.append({
            "span": shifted.span, "scanned": lane["scanned_slots"],
            "ms": ms, "evictions": int(ev),
            "chunk_scans": lane["chunk_scans"],
            "scans_per_eviction": lane["chunk_scans"] / ev,
            "us_per_eviction": ms * 1e3 / ev})
    flat = scan_span[-1]["us_per_eviction"] / scan_span[0]["us_per_eviction"]
    print(f"phase 14 {card}: K1 tree/lru on one ServeDecode lane "
          f"({int(base_out[0, 7])} evictions in {len(tr)} accesses, "
          f"{tr.working_set_pages} pages of working set, the same at every "
          "span) against the slots its victim search covers: " + ", ".join(
              f"{x['scanned']} slots {x['ms']:.1f} ms "
              f"({x['us_per_eviction']:.2f} us and "
              f"{x['scans_per_eviction']:.2f} chunk scans per eviction)"
              for x in scan_span)
          + f"; the largest span's us per eviction is {flat:.2f}x the "
          "smallest's", flush=True)
    # K1 on the main path's learned batch against its plain version
    plain, plain_s = main_plain.result()
    err, _ = k1_against(k1_batch, plain)
    check(err == 0.0, f"K1 vs plain on the main-path batch: max diff {err}")
    k1_err = max(k1_err, err)
    k1_args = k1_batch.kernel_args("cuda")
    k1_ms = cuda_ms(lambda: lane_replay(**k1_args), reps=3)
    # one launch is about 0.15 s: the profiler's device time, no graph
    k1_dev = profiled_ms(lambda: lane_replay(**k1_args), reps=1)
    k1_bound = k1_bound_ms(k1_batch)
    k1_chain = chain_bound_ms(k1_batch)
    n_acc = int(k1_batch.iparams[:, 0].sum())
    # K2, K3 and K4 at the predictor's shapes: per call through the wrapper
    # (what a path pays) and device time per launch (a CUDA graph of the
    # launches), the kernel, its PyTorch call and its plain version in
    # turns; K2 and K3 rotate through copies of their inputs so that no
    # call finds its data in L2 (one K4 call already moves 393 MB)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def timing_fields(t, bound_ms):
        dev = t["kernel"]["device_ms"]
        return {"ms": t["kernel"]["ms"], "device_ms": dev,
                "plain_ms": t["plain"]["ms"],
                "plain_device_ms": t["plain"]["device_ms"],
                "library_ms": t["library"]["ms"],
                "library_device_ms": t["library"]["device_ms"],
                "share_of_bound": None if dev is None else bound_ms / dev,
                "timing": t["kernel"]["method"]}

    # K2: the yardstick is one scaled_dot_product_attention call on
    # pre-masked q/k (the port never calls it).  k holds q's values in a
    # tensor of its own, as on the path (the layer's shared QK is split into
    # head-major copies), so every call reads q, k, v and keep and writes
    # the output
    q, v, keep = k2_main
    b, n, d = q.shape
    k = q.clone()
    qm = (q * keep[..., None]).contiguous()
    km = qm.clone()
    k2_bytes = 4 * b * n * d * 4 + b * n * 4
    k2_geo = hlsh_geometry(b, n, d, q.dtype).name()

    def k2_calls(copies):
        """K2, its PyTorch call and its plain version over ``copies`` of
        (q, k, v, keep, q and k pre-masked)."""
        return {
            "kernel": rotating(lambda q, k, v, kp, qm, km: hlsh_attention(
                q, k, v, kp), copies),
            "library": rotating(lambda q, k, v, kp, qm, km: sdpa(qm, km, v),
                                copies),
            "plain": rotating(lambda q, k, v, kp, qm, km:
                              hlsh_attention_plain(q, k, v, kp), copies)}

    k2_t = timed_in_turns(
        k2_calls(copies_of((q, k, v, keep, qm, km), k2_bytes)), reps=50)
    # the products this keep mask needs: a logit for each pair of kept
    # query and kept key (an erased one is 0), a value product for every
    # pair
    kept = (keep > 0).sum(1).double()
    k2_flops = float((2 * d * kept * kept + 2 * d * n * n).sum())
    k2_bound_bytes = k2_bytes / HBM_BYTES_S * 1e3
    k2_bound_ops = k2_flops / F32_FLOPS * 1e3
    k2_bound = max(k2_bound_bytes, k2_bound_ops)
    # K2 in bf16 at the same shape and keep mask
    k2_bf16_in = tuple(t.to(torch.bfloat16) for t in (q, k, v, keep, qm, km))
    k2b_t = timed_in_turns(k2_calls(copies_of(k2_bf16_in, k2_bytes / 2)),
                           reps=50)
    b2_bytes = (4 * b * n * d + b * n) * 2 / HBM_BYTES_S * 1e3
    k2b_bound = max(b2_bytes, k2_bound_ops)
    k2_bf16 = {"dtype": "bfloat16", "shape": [b, n, d],
               "max_abs_err": k2_err["bfloat16"],
               "max_abs_err_from_bf16_plain": k2_bf16_plain,
               "variant": k2_geo,
               "bound_ms": k2b_bound,
               "bound_by": "bytes" if b2_bytes >= k2_bound_ops
               else "operations",
               **timing_fields(k2b_t, k2b_bound)}
    # K4 at the Transformer family's shape; the yardstick is one
    # scaled_dot_product_attention call on the same (B, H, S, D) tensors
    fb, fh, _, fs, _, fd = K4_PATH_SHAPE
    _, (fq, fk, fv) = k4_against_plain(rng, K4_PATH_SHAPE, False,
                                        torch.float32)
    k4_t = timed_in_turns({
        "kernel": lambda: flash_attention(fq, fk, fv),
        "library": lambda: sdpa(fq, fk, fv),
        "plain": lambda: flash_attention_plain(fq, fk, fv)})
    k4_bytes = 4 * fb * fh * fs * fd * 4 / HBM_BYTES_S * 1e3
    k4_ops = 4 * fb * fh * fs * fs * fd / F32_FLOPS * 1e3
    k4_bound = max(k4_bytes, k4_ops)
    k4_fields = timing_fields(k4_t, k4_bound)
    k4_variant = flash_geometry(fb * fh, fs, fs, fd).name()
    # K3 at the classification head's shape and the layer products; the
    # yardstick is one torch.matmul on the dequantized weight
    k3_times = []
    for m, kd, n3 in ((4096, 12, 20000),) + K3_PATH_SHAPES[:3]:
        _, _, (x3, w3, s3) = k3_against_plain(rng, m, kd, n3,
                                              torch.float32, True)
        w_deq = unpack_int4(w3).float() * s3
        by3 = m * kd * 4 + w3.numel() + m * n3 * 4 + 4
        b3 = by3 / HBM_BYTES_S * 1e3
        o3 = 2 * m * kd * n3 / F32_FLOPS * 1e3
        x3_in = copies_of((x3,), by3)
        t3 = timed_in_turns({
            "kernel": rotating(lambda x: int4_matmul(x, w3, s3), x3_in),
            "library": rotating(lambda x: torch.matmul(x, w_deq), x3_in),
            "plain": rotating(lambda x: int4_matmul_plain(x, w3, s3), x3_in)})
        k3_times.append({
            "shape": [m, kd, n3],
            "variant": int4_variant(m, kd, n3, x3.dtype, x3.data_ptr()),
            "bound_ms": max(b3, o3),
            "bound_by": "bytes" if b3 >= o3 else "operations",
            **timing_fields(t3, max(b3, o3))})
    k3_head = k3_times[0]
    # K3 on its path: one bench's quantized simplified inference
    # (predict_trace, HLSH: six weight products a batch) with the products
    # on K3 and as the plain fake-quant product, in turns on one model
    svc = PredictorService(steps=paper_tables.SERVICE_STEPS, device="cuda")
    svc.fit(traces[INFER_BENCH])
    model = svc.result.model
    infer_s = {"k3": [], "fake_quant": []}
    infer_preds = {}
    for which in ("fake_quant", "k3", "k3", "fake_quant"):
        if which == "fake_quant":
            model._mm = lambda x, w: x @ model._qw(w)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        infer_preds[which] = svc.predict_trace()
        torch.cuda.synchronize()
        infer_s[which].append(time.perf_counter() - t0)
        model.__dict__.pop("_mm", None)
    agree = float(np.mean(infer_preds["k3"] == infer_preds["fake_quant"]))
    check(agree >= 0.99, f"{INFER_BENCH} predictions with K3 agree with the "
          f"fake-quant product's on {agree:.4f} of accesses")
    print(f"phase 14 {card}: {INFER_BENCH} quantized simplified inference "
          f"({len(traces[INFER_BENCH])} accesses): K3 "
          f"{', '.join(f'{x:.3f}' for x in infer_s['k3'])} s, fake-quant "
          f"product {', '.join(f'{x:.3f}' for x in infer_s['fake_quant'])} "
          f"s; predictions equal on {agree:.4f} of accesses", flush=True)

    def by_path(name):
        return {p: c[name] for p, c in path_launches.items()}

    kernels = [
        {"name": "lane_replay", "route": "cuda", "source": K1_SOURCE,
         "replaces": K1_REPLACES,
         "launches": sum(by_path("lane_replay").values()),
         "launches_by_path": by_path("lane_replay"),
         "max_abs_err": k1_err, "ms": k1_ms, "device_ms": k1_dev,
         "timing": "profiler" if k1_dev is not None else "not measured",
         "plain_ms": plain_s * 1e3, "bound_ms": k1_bound,
         "bound_by": "bytes", "library_ms": None, "library_device_ms": None,
         "share_of_bound": None if k1_dev is None else k1_bound / k1_dev,
         "chain_bound_ms": k1_chain, "access_us": access_us,
         "chain_share": None if k1_dev is None else k1_chain / k1_dev,
         "variant": "learned/lru",
         "variants": [dict(v, bound_by="bytes", library_ms=None)
                      for v in variants.values()],
         "scan_vs_span": scan_span},
        {"name": "hlsh_attention", "route": "cuda", "source": K2_SOURCE,
         "replaces": K2_REPLACES,
         "launches": sum(by_path("hlsh_attention").values()),
         "launches_by_path": by_path("hlsh_attention"),
         "max_abs_err": k2_err["float32"], "max_abs_err_by_dtype": k2_err,
         "shape": [b, n, d], "dtype": "float32", "variant": k2_geo,
         "bound_ms": k2_bound,
         "bound_by": "bytes" if k2_bound_bytes >= k2_bound_ops
         else "operations",
         **timing_fields(k2_t, k2_bound),
         "variants": [k2_bf16]},
        {"name": "int4_matmul", "route": "cuda", "source": K3_SOURCE,
         "replaces": K3_REPLACES,
         "launches": sum(by_path("int4_matmul").values()),
         "launches_by_path": by_path("int4_matmul"),
         "max_abs_err": k3_abs, "max_rel_err": k3_err, **k3_head,
         "variants": k3_times[1:],
         "inference_s": dict(infer_s, bench=INFER_BENCH,
                             predictions_equal=agree)},
        {"name": "flash_attention", "route": "cuda", "source": K4_SOURCE,
         "replaces": K4_REPLACES,
         "launches": sum(by_path("flash_attention").values()),
         "launches_by_path": by_path("flash_attention"),
         "max_abs_err": max(k4_err.values()), "max_abs_err_by_dtype": k4_err,
         "bf16_path_shape_err": k4_bf16_path, "shape": list(K4_PATH_SHAPE),
         "variant": k4_variant, "bound_ms": k4_bound,
         "bound_by": "bytes" if k4_bytes >= k4_ops else "operations",
         **k4_fields},
    ]

    def times(t):
        """One kernel's times: per call / device per launch."""
        def ms(x):
            return "not measured" if x is None else f"{x:.4f}"
        share = ("not measured" if t["share_of_bound"] is None
                 else f"{100 * t['share_of_bound']:.0f}%")
        return (f"{ms(t['ms'])} / {ms(t['device_ms'])} ms per call / device "
                f"({t['timing']}), plain "
                f"{ms(t['plain_ms'])} / {ms(t['plain_device_ms'])}, library "
                f"{ms(t['library_ms'])} / {ms(t['library_device_ms'])}, bound "
                f"{t['bound_ms']:.4f} by {t['bound_by']} ({share} of it)")

    k1_dev_txt = "not measured" if k1_dev is None else f"{k1_dev:.3f}"
    print(f"phase 14 {card}: K1 {k1_ms:.3f} ms per launch ({k1_dev_txt} ms "
          f"device) on the main path's learned batch "
          f"({len(k1_batch.pages)} lanes padded, {n_acc} accesses; chain "
          f"bound {k1_chain:.2f} ms; plain version {plain_s * 1e3:.1f} ms on "
          "the host)", flush=True)
    print(f"phase 14 {card}: K2 at ({b},{n},{d}) [{k2_geo}] float32 "
          f"{times(kernels[1])}; bf16 {times(k2_bf16)} (library: "
          "scaled_dot_product_attention)", flush=True)
    print(f"phase 14 {card}: K4 at {K4_PATH_SHAPE} float32 [{k4_variant}] "
          f"{times(kernels[3])} (library: scaled_dot_product_attention); "
          f"launches by path {by_path('flash_attention')}", flush=True)
    for t in k3_times:
        print(f"phase 14 {card}: K3 at {tuple(t['shape'])} float32 "
              f"[{t['variant']}] {times(t)} (library: torch.matmul on the "
              "dequantized weight)", flush=True)
    print(f"phase 14: K3 launches by path {by_path('int4_matmul')}; K2 "
          f"{by_path('hlsh_attention')}; whole run "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump({"device": kind, "nvidia_smi": smi, "rows": rows,
                       "table10": t10, "table11": t11,
                       "oversub_full": mrows, "serve_full": srows,
                       "mt_full": trows, "transformer_smoke": xrows,
                       "family": frows, "family_accuracy": family_cmp,
                       "kernels": kernels, "launches_by_path": path_launches,
                       "main_path_s": main_s, "tables_s": tables_s,
                       "oversub_full_s": matrix_s, "serve_full_s": serve_s,
                       "mt_full_s": mt_s, "transformer_smoke_s": smoke_s,
                       "family_s": family_s}, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
