#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` and drives the
learned-prefetch sweep, the paper's tree-vs-learned tables and the
oversubscription matrix on the card:

1. the device, its power limit, and the kernel build;
2. K1 (multi-lane replay) against the legacy engine at full benchmark
   scale: none/block/learned lanes under lru on all 11 benchmarks, and every
   other family x policy (tree and oracle under lru/random/hotcold,
   none/block/learned under random/hotcold) at half the working set;
3. K1 against ``tests/golden/uvm_golden.json`` and against its plain
   version on whole batches of the 70 non-quota golden cells, one batch per
   family x policy (maximum difference 0), with both timed;
4. K2 (HLSH attention) against its plain version;
5. the main path: the sweep over the 11 paper benchmarks x {none, tree,
   learned} x {all memory, half the working set}, predictors trained and
   served on the card, every row replayed by K1; tree and learned rows
   equal the legacy engine on the same inputs;
6. the paper's Table 10 and Table 11 (tree vs learned, unlimited memory);
   every tree row equals the legacy engine's;
7. the ``oversub-full`` scenario (660 cells) through the port's sweep,
   sharing the main path's prediction cache; the 2DCONV cells are held
   against the legacy engine;
8. kernel times from CUDA events beside the plain versions and a PyTorch
   yardstick: K1 per family x policy on the largest batch of the matrix,
   K1 against its plain version on the main path's learned batch and on
   the tables' tree batch, then the ``kernels`` line and the result line.

Each of the three driven paths (5, 6, 7) zeroes the launch counters just
before it and reads them just after.

Usage: ``python3 chip_smoke.py [--out DIR]`` (``--out`` also writes the rows
and kernel records as JSON).  Exits non-zero without a result line when no
CUDA device is present or any check fails.
"""
from __future__ import annotations

import argparse
import json
import math
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
K1_SOURCE = "src/repro_torch/csrc/lane_replay.cu"
K2_SOURCE = "src/repro_torch/csrc/hlsh_attention.cu"
K1_REPLACES = "src/repro/uvm/backends/pallas_backend.py:197"
K2_REPLACES = "src/repro/kernels/hlsh_attention.py:34"
GOLDEN = os.path.join(ROOT, "tests", "golden", "uvm_golden.json")
K2_ATOL = 2e-4                     # the tolerance of tests/test_kernels.py
#: published H100 SXM peaks: HBM bytes/s, float32 FLOP/s outside the
#: tensor cores
HBM_BYTES_S = 3.35e12
F32_FLOPS = 67e12
INT_FIELDS = ("hits", "late", "faults", "prefetch_issued", "prefetch_used",
              "pages_migrated", "pages_evicted")


class CheckFailed(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def same_stats(got, want, what: str) -> None:
    for f in INT_FIELDS:
        check(getattr(got, f) == getattr(want, f),
              f"{what}: {f} {getattr(got, f)} != {getattr(want, f)}")
    for f in ("cycles", "pcie_bytes"):
        g, w = getattr(got, f), getattr(want, f)
        check(abs(g - w) <= 1e-6 * abs(w),
              f"{what}: {f} {g!r} != {w!r} beyond 1e-6 relative")


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


def k1_bound_ms(batch) -> float:
    """Least time for K1's bytes: each input read once (the real accesses'
    pages, predictions and stream positions, the first-touch streams, the
    parameter blocks), each stat written once, over the HBM rate."""
    n_acc = int(batch.iparams[:, 0].sum())
    per_access = 4 + (4 if batch.preds is not None else 0) + (
        4 if batch.pos is not None else 0)
    n_ft = int(batch.iparams[:, 4].clip(min=0).sum()) if (
        batch.ft is not None) else 0
    lanes = int((batch.iparams[:, 0] > 0).sum())
    nbytes = (n_acc * per_access + n_ft * 4 + lanes * (8 * 8 + 9 * 4)
              + lanes * 10 * 8)
    return nbytes / HBM_BYTES_S * 1e3


def k1_vs_plain(batch):
    """K1 and its plain version on one lane batch: (max abs difference of
    the stats, kernel stats, plain seconds)."""
    from repro_torch.kernels.lane_replay import lane_replay, lane_replay_plain
    args = batch.kernel_args("cuda")
    got = lane_replay(**args).cpu()
    cpu = batch.kernel_args("cpu")
    cpu.pop("buf_len")
    t0 = time.perf_counter()
    want = lane_replay_plain(**cpu)
    plain_s = time.perf_counter() - t0
    return float((got - want).abs().max()), got, plain_s


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write rows and kernel records here as JSON")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "the card", file=sys.stderr)
        return 2
    from repro_torch.core.features import cluster_trace, delta_convergence
    from repro_torch.kernels import build
    from repro_torch.kernels import lane_replay as k1
    from repro_torch.kernels.hlsh_attention import (hlsh_attention,
                                                    hlsh_attention_plain)
    from repro_torch.kernels.lane_replay import lane_replay
    from repro_torch.uvm import golden as G
    from repro_torch.uvm import paper_tables, sweep
    from repro_torch.uvm.backends.cuda_backend import (PORTED_FAMILIES,
                                                       PORTED_POLICIES,
                                                       lane_family)
    from repro_torch.uvm.config import UVMConfig
    from repro_torch.uvm.prefetchers import (BlockPrefetcher,
                                             LearnedPrefetcher, NoPrefetcher,
                                             OraclePrefetcher,
                                             TreePrefetcher)
    from repro_torch.uvm.replay_core import ReplayRequest, get_backend
    from repro_torch.uvm.scenarios import expand_scenario
    from repro_torch.uvm.simulator import UVMSimulator

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
    stats = backend.replay(requests)
    torch.cuda.synchronize()
    p2_kinds = set()
    for (bench, frac, name, tr, cfg), req, st in zip(cells, requests, stats):
        check(st.backend == "cuda", f"{bench}/{name}: backend {st.backend}")
        same_stats(st, UVMSimulator(cfg).run(tr, makers[name](tr, cfg)),
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
    gids = [c for c in G.golden_cell_ids()
            if not G.golden_cell(c)[1].tenant_pages]
    greqs = []
    for c in gids:
        trace, cfg, factory = G.golden_cell(c)
        greqs.append(ReplayRequest(trace, factory(), cfg))
    variants = {}
    k1_err = 0.0
    for batch_idx in backend.pack_lanes(greqs):
        reqs = [greqs[i] for i in batch_idx]
        fam, pol = kind_of(reqs[0])
        batch = backend.pack_batch(reqs)
        err, got, plain_s = k1_vs_plain(batch)
        check(err == 0.0, f"K1 vs plain on the golden {fam}/{pol} batch: "
              f"max diff {err}")
        k1_err = max(k1_err, err)
        for lane, i in enumerate(batch_idx):
            want = golden[gids[i]]
            row = got[lane].tolist()
            for j, f in enumerate(k1.STAT_FIELDS):
                ok = (row[j] == want[f] if f in INT_FIELDS
                      else abs(row[j] - want[f]) <= 1e-6 * abs(want[f]))
                check(ok, f"K1 golden {gids[i]}: {f} {row[j]} != "
                      f"{want[f]}")
        args_ = batch.kernel_args("cuda")
        variants[(fam, pol)] = {
            "family": fam, "policy": pol,
            "golden_lanes": len(batch_idx),
            "golden_accesses": int(batch.iparams[:, 0].sum()),
            "golden_ms": cuda_ms(lambda: lane_replay(**args_), reps=3),
            "golden_plain_ms": plain_s * 1e3,
            "golden_bound_ms": k1_bound_ms(batch),
            "golden_max_abs_err": err}
    check(len(variants) == len(PORTED_FAMILIES) * len(PORTED_POLICIES),
          f"golden batches covered {sorted(variants)} only")
    print(f"phase 3 {card}: K1 equal to the fixture on {len(gids)} golden "
          f"cells and to its plain version on {len(variants)} batches (max "
          f"diff {k1_err}), in {time.perf_counter() - t0:.1f} s", flush=True)
    for v in variants.values():
        print(f"  golden {v['family']}/{v['policy']}: {v['golden_lanes']} "
              f"lanes, {v['golden_accesses']} accesses: K1 "
              f"{v['golden_ms']:.3f} ms, plain {v['golden_plain_ms']:.1f} ms",
              flush=True)

    # ---- phase 4: K2 against its plain version ----------------------------
    rng = np.random.default_rng(0)
    k2_err = 0.0
    k2_main = None
    for b, n, d, erased in ((4096, 30, 12, None), (2, 256, 64, (32, 64))):
        q = torch.tensor(rng.normal(size=(b, n, d)), dtype=torch.float32,
                         device="cuda")
        v = torch.tensor(rng.normal(size=(b, n, d)), dtype=torch.float32,
                         device="cuda")
        keep = torch.tensor(rng.random((b, n)) > 0.3, dtype=torch.float32,
                            device="cuda")
        if erased is not None:
            keep[:, erased[0]:erased[1]] = 0.0     # one fully erased tile
        err = float((hlsh_attention(q, q, v, keep)
                     - hlsh_attention_plain(q, q, v, keep)).abs().max())
        check(err <= K2_ATOL, f"K2 ({b},{n},{d}): max error {err}")
        k2_err = max(k2_err, err)
        if k2_main is None:
            k2_main = (q, v, keep)
    print(f"phase 4: K2 matched its plain version, max error {k2_err:.3g} "
          f"(limit {K2_ATOL})", flush=True)

    # ---- phase 5: the main path -----------------------------------------
    for bench in BENCHES:
        conv = delta_convergence(cluster_trace(traces[bench], "sm"))
        print(f"  {bench}: delta convergence {conv:.3f} -> "
              f"{'bypass' if conv >= 0.7 else 'hlsh'}", flush=True)
    grid = sweep.expand_grid(BENCHES, ["none", "tree", "learned"],
                             scales=[1.0], windows=[0.6],
                             device_fracs=list(FRACS),
                             service_steps=paper_tables.SERVICE_STEPS)
    k1.reset_counts()
    hlsh_attention.launches = 0
    t0 = time.perf_counter()
    rows = sweep.run_sweep(grid, device="cuda")
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = {"lane_replay": lane_replay.launches,
                "hlsh_attention": hlsh_attention.launches}
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
    learned_reqs = []
    legacy_tree = {}
    for cell, r in zip(grid, rows):
        if cell.prefetcher == "none":
            continue
        trace, config, pf, _ = sweep.prepare_cell(cell, device="cuda")
        want = UVMSimulator(config).run(trace, pf)
        same_row(r, want, f"main path {cell.bench}/{cell.prefetcher}/"
                 f"{cell.device_frac}")
        if cell.prefetcher == "learned":
            learned_reqs.append(ReplayRequest(trace, pf, config))
        elif cell.device_frac is None:
            legacy_tree[cell.bench] = want
    print(f"phase 5: {len(learned_reqs)} learned and {2 * len(legacy_tree)} "
          "tree rows equal the legacy engine on the same inputs", flush=True)

    # ---- phase 6: the paper's Table 10 and Table 11 -----------------------
    k1.reset_counts()
    t0 = time.perf_counter()
    t10, t11 = paper_tables.run(BENCHES, device="cuda")
    tables_s = time.perf_counter() - t0
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
    k1.reset_counts()
    t0 = time.perf_counter()
    mrows = sweep.run_sweep(matrix, device="cuda")
    torch.cuda.synchronize()
    matrix_s = time.perf_counter() - t0
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
    n_checked = 0
    for cell, r, req in zip(matrix, mrows, mreqs):
        if cell.bench != MATRIX_CHECK_BENCH:
            continue
        same_row(r, UVMSimulator(req.config).run(req.trace, req.prefetcher),
                 f"oversub-full {cell.bench}/{cell.prefetcher}/"
                 f"{cell.eviction}/{cell.device_frac}")
        n_checked += 1
    print(f"phase 7: the {n_checked} {MATRIX_CHECK_BENCH} rows equal the "
          f"legacy engine", flush=True)

    # ---- phase 8: kernel times ------------------------------------------
    # K1 per family x policy on the largest batch of the matrix
    for key, v in variants.items():
        cand = [b for b in mbatches if kind_of(mreqs[b[0]]) == key]
        big = max(cand, key=lambda b: sum(len(mreqs[i].trace) for i in b))
        batch = backend.pack_batch([mreqs[i] for i in big])
        args_ = batch.kernel_args("cuda")
        v.update(matrix_launches=matrix_by.get(key, 0),
                 matrix_lanes=len(big),
                 matrix_accesses=int(batch.iparams[:, 0].sum()),
                 ms=cuda_ms(lambda: lane_replay(**args_), reps=2),
                 bound_ms=k1_bound_ms(batch))
        print(f"phase 8 {card}: K1 {key[0]}/{key[1]} {v['ms']:.2f} ms per "
              f"launch on the matrix's largest batch ({len(big)} lanes, "
              f"{v['matrix_accesses']} accesses; bound {v['bound_ms']:.5f} "
              f"ms); golden batch {v['golden_ms']:.3f} ms, plain "
              f"{v['golden_plain_ms']:.1f} ms", flush=True)
    # K1 on the main path's learned batch against its plain version
    k1_batch = backend.pack_batch(
        [learned_reqs[i] for i in backend.pack_lanes(learned_reqs)[0]])
    err, _, plain_s = k1_vs_plain(k1_batch)
    check(err == 0.0, f"K1 vs plain on the main-path batch: max diff {err}")
    k1_err = max(k1_err, err)
    k1_args = k1_batch.kernel_args("cuda")
    k1_ms = cuda_ms(lambda: lane_replay(**k1_args), reps=3)
    k1_bound = k1_bound_ms(k1_batch)
    n_acc = int(k1_batch.iparams[:, 0].sum())
    # K1 on the tables' tree batch (11 scale-1.0 lanes, no evictions)
    # against its plain version: the tree family at a driven path's shapes
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
    variants[("tree", "lru")].update(
        tables_lanes=len(tidx),
        tables_accesses=int(t_batch.iparams[:, 0].sum()),
        tables_ms=cuda_ms(lambda: lane_replay(**t_args), reps=3),
        tables_plain_ms=t_plain_s * 1e3, tables_bound_ms=k1_bound_ms(t_batch),
        tables_max_abs_err=err)
    tv = variants[("tree", "lru")]
    print(f"phase 8 {card}: K1 tree/lru {tv['tables_ms']:.3f} ms per launch "
          f"on the tables' tree batch ({len(tidx)} lanes, "
          f"{tv['tables_accesses']} accesses), equal to its plain version "
          f"({tv['tables_plain_ms']:.1f} ms on the host)", flush=True)
    # K2 at the predictor's shape; the yardstick is one
    # scaled_dot_product_attention call on pre-masked q/k (the port never
    # calls it)
    q, v, keep = k2_main
    b, n, d = q.shape
    k2_ms = cuda_ms(lambda: hlsh_attention(q, q, v, keep), reps=50)
    k2_plain_ms = cuda_ms(lambda: hlsh_attention_plain(q, q, v, keep),
                          reps=50)
    qm = (q * keep[..., None]).contiguous()
    k2_lib_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qm, qm, v), reps=50)
    tile = 32
    n_tiles = math.ceil(n / tile)
    kept_tiles = sum(int((keep[:, t * tile:(t + 1) * tile] > 0).any(1).sum())
                     for t in range(n_tiles))
    k2_flops = 4 * n * min(tile, n) * d * kept_tiles
    k2_bytes = 4 * b * n * d * 4 + b * n * 4
    k2_bound_bytes = k2_bytes / HBM_BYTES_S * 1e3
    k2_bound_ops = k2_flops / F32_FLOPS * 1e3
    paths = {"main": launches["lane_replay"], "tables": tables_launches,
             "oversub-full": matrix_launches}
    kernels = [
        {"name": "lane_replay", "route": "cuda", "source": K1_SOURCE,
         "replaces": K1_REPLACES, "launches": sum(paths.values()),
         "launches_by_path": paths,
         "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": plain_s * 1e3,
         "bound_ms": k1_bound, "bound_by": "bytes", "library_ms": None,
         "variants": [dict(v, bound_by="bytes", library_ms=None)
                      for v in variants.values()]},
        {"name": "hlsh_attention", "route": "cuda", "source": K2_SOURCE,
         "replaces": K2_REPLACES, "launches": launches["hlsh_attention"],
         "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain_ms,
         "bound_ms": max(k2_bound_bytes, k2_bound_ops),
         "bound_by": "bytes" if k2_bound_bytes >= k2_bound_ops
         else "operations", "library_ms": k2_lib_ms},
    ]
    print(f"phase 8 {card}: K1 {k1_ms:.3f} ms per launch on the main path's "
          f"learned batch ({len(k1_batch.pages)} lanes padded, {n_acc} "
          f"accesses; plain version {plain_s * 1e3:.1f} ms on the host); K2 "
          f"{k2_ms:.4f} ms at ({b},{n},{d}) (plain {k2_plain_ms:.4f} ms, "
          f"scaled_dot_product_attention {k2_lib_ms:.4f} ms); whole run "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump({"device": kind, "nvidia_smi": smi, "rows": rows,
                       "table10": t10, "table11": t11,
                       "oversub_full": mrows, "kernels": kernels,
                       "main_path_s": main_s, "tables_s": tables_s,
                       "oversub_full_s": matrix_s}, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
