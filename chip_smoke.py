#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` and drives the
learned-prefetch sweep on the card:

1. the device, its power limit, and the kernel build;
2. K1 (multi-lane replay) on lane batches of none/block/learned cells at
   full benchmark scale, against the legacy engine on every lane and
   against K1's plain version on whole batches;
3. K2 (HLSH attention) against its plain version at the predictor's shape
   and at a shape with a fully erased key tile;
4. the main path: the sweep over the 11 paper benchmarks x {none, learned}
   x {all memory, half the working set}, predictors trained and served on
   the card, every row replayed by K1; the launch counters show both
   kernels ran, and each learned row equals the legacy engine replaying the
   same predictions;
5. kernel times from CUDA events beside the plain versions and a PyTorch
   yardstick, then the ``kernels`` line and the result line.

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
STEPS = 150
#: perfect distance-32 predictions: the stand-in model of the golden cells
LEARNED_DISTANCE = 32
K1_SOURCE = "src/repro_torch/csrc/lane_replay.cu"
K2_SOURCE = "src/repro_torch/csrc/hlsh_attention.cu"
K1_REPLACES = "src/repro/uvm/backends/pallas_backend.py:197"
K2_REPLACES = "src/repro/kernels/hlsh_attention.py:34"
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


def perfect_preds(pages, distance: int = LEARNED_DISTANCE):
    import numpy as np
    pages = np.asarray(pages, dtype=np.int64)
    preds = np.full(len(pages), -1, dtype=np.int64)
    if len(pages) > distance:
        preds[:-distance] = pages[distance:]
    return preds


def same_stats(got, want, what: str) -> None:
    for f in INT_FIELDS:
        check(getattr(got, f) == getattr(want, f),
              f"{what}: {f} {getattr(got, f)} != {getattr(want, f)}")
    for f in ("cycles", "pcie_bytes"):
        g, w = getattr(got, f), getattr(want, f)
        check(abs(g - w) <= 1e-6 * abs(w),
              f"{what}: {f} {g!r} != {w!r} beyond 1e-6 relative")


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


def k1_inputs(backend, requests, device):
    import torch
    pages, preds, fparams, iparams, span, buf_len = backend.pack_batch(
        requests)
    dev = torch.device(device)
    return (torch.as_tensor(pages, device=dev),
            None if preds is None else torch.as_tensor(preds, device=dev),
            torch.as_tensor(fparams, device=dev),
            torch.as_tensor(iparams, device=dev), span, buf_len)


def k1_vs_plain(backend, requests):
    """K1 and its plain version on one lane batch: (max abs difference of
    the stats, plain seconds)."""
    import torch
    from repro_torch.kernels.lane_replay import lane_replay, lane_replay_plain
    pages, preds, fparams, iparams, span, buf_len = k1_inputs(
        backend, requests, "cuda")
    got = lane_replay(pages, preds, fparams, iparams, span, buf_len).cpu()
    t0 = time.perf_counter()
    want = lane_replay_plain(pages.cpu(), None if preds is None
                             else preds.cpu(), fparams.cpu(), iparams.cpu(),
                             span)
    plain_s = time.perf_counter() - t0
    return float((got - want).abs().max()), plain_s


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
    from repro_torch.kernels.hlsh_attention import (hlsh_attention,
                                                    hlsh_attention_plain)
    from repro_torch.kernels.lane_replay import lane_replay
    from repro_torch.uvm import sweep
    from repro_torch.uvm.config import UVMConfig
    from repro_torch.uvm.prefetchers import (BlockPrefetcher,
                                             LearnedPrefetcher, NoPrefetcher)
    from repro_torch.uvm.replay_core import ReplayRequest, get_backend
    from repro_torch.uvm.simulator import UVMSimulator

    # float32 products in full precision (TF32 off), stated and set
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

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

    # ---- phase 2: K1 against the legacy engine and its plain version ------
    t0 = time.perf_counter()
    traces = {b: sweep.load_trace(b, 1.0, 0, 0.6) for b in BENCHES}
    makers = {
        "none": lambda tr, cfg: NoPrefetcher(),
        "block": lambda tr, cfg: BlockPrefetcher(),
        "learned": lambda tr, cfg: LearnedPrefetcher(
            perfect_preds(tr.pages), extra_latency_cycles=cfg.cycles_per_us),
    }
    cells = []
    for bench, tr in traces.items():
        for frac in FRACS:
            cap = None if frac is None else int(tr.working_set_pages * frac)
            cfg = UVMConfig(device_pages=cap)
            for name, make in makers.items():
                cells.append((bench, frac, name, tr, cfg, make))
    requests = [ReplayRequest(tr, make(tr, cfg), cfg)
                for _, _, _, tr, cfg, make in cells]
    stats = backend.replay(requests)
    torch.cuda.synchronize()
    for (bench, frac, name, tr, cfg, make), st in zip(cells, stats):
        check(st.backend == "cuda", f"{bench}/{name}: backend {st.backend}")
        same_stats(st, UVMSimulator(cfg).run(tr, make(tr, cfg)),
                   f"K1 vs legacy {bench}/{name}/frac={frac}")
    k1_err = 0.0
    for name in ("block", "learned"):
        batch = [ReplayRequest(tr, make(tr, cfg), cfg)
                 for bench, _, n, tr, cfg, make in cells
                 if bench == "2DCONV" and n == name]
        err, _ = k1_vs_plain(backend, batch)
        check(err == 0.0, f"K1 vs plain on 2DCONV/{name}: max diff {err}")
        k1_err = max(k1_err, err)
    print(f"phase 2: K1 matched the legacy engine on {len(cells)} lanes "
          f"({len(backend.pack_lanes(requests))} batches) and its plain "
          f"version on 2 batches, in {time.perf_counter() - t0:.1f} s",
          flush=True)

    # ---- phase 3: K2 against its plain version ----------------------------
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
    print(f"phase 3: K2 matched its plain version, max error {k2_err:.3g} "
          f"(limit {K2_ATOL})", flush=True)

    # ---- phase 4: the main path -----------------------------------------
    for bench in BENCHES:
        conv = delta_convergence(cluster_trace(traces[bench], "sm"))
        print(f"  {bench}: delta convergence {conv:.3f} -> "
              f"{'bypass' if conv >= 0.7 else 'hlsh'}", flush=True)
    grid = sweep.expand_grid(BENCHES, ["none", "learned"], scales=[1.0],
                             windows=[0.6], device_fracs=list(FRACS),
                             service_steps=STEPS)
    lane_replay.launches = 0
    hlsh_attention.launches = 0
    t0 = time.perf_counter()
    rows = sweep.run_sweep(grid, device="cuda")
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = {"lane_replay": lane_replay.launches,
                "hlsh_attention": hlsh_attention.launches}
    print(f"phase 4: main path, {len(rows)} rows in {main_s:.1f} s; "
          f"launches {launches}", flush=True)
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
    for cell, r in zip(grid, rows):
        if cell.prefetcher != "learned":
            continue
        trace, config, pf, _ = sweep.prepare_cell(cell, device="cuda")
        want = UVMSimulator(config).run(trace, pf)
        for f in INT_FIELDS + ("cycles", "pcie_bytes"):
            got = r[f]
            check(got == getattr(want, f) if f in INT_FIELDS
                  else abs(got - getattr(want, f))
                  <= 1e-6 * abs(getattr(want, f)),
                  f"main path {cell.bench}/learned/{cell.device_frac}: {f} "
                  f"{got} != legacy {getattr(want, f)}")
        learned_reqs.append(ReplayRequest(trace, pf, config))
    print(f"phase 4: {len(learned_reqs)} learned rows equal the legacy "
          "engine on the same predictions", flush=True)

    # ---- phase 5: kernel times ------------------------------------------
    # K1 on the main path's learned lane batch
    k1_batch = [learned_reqs[i] for i in backend.pack_lanes(learned_reqs)[0]]
    err, plain_s = k1_vs_plain(backend, k1_batch)
    check(err == 0.0, f"K1 vs plain on the main-path batch: max diff {err}")
    inputs = k1_inputs(backend, k1_batch, "cuda")
    k1_ms = cuda_ms(lambda: lane_replay(*inputs), reps=3)
    pages, preds = inputs[0], inputs[1]
    n_acc = int(inputs[3][:, 0].sum())
    k1_bytes = (n_acc * (4 + 4) + inputs[2].numel() * 8
                + inputs[3].numel() * 4 + pages.shape[0] * 10 * 8)
    k1_bound = k1_bytes / HBM_BYTES_S * 1e3
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
    kernels = [
        {"name": "lane_replay", "route": "cuda", "source": K1_SOURCE,
         "replaces": K1_REPLACES, "launches": launches["lane_replay"],
         "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": plain_s * 1e3,
         "bound_ms": k1_bound, "bound_by": "bytes", "library_ms": None},
        {"name": "hlsh_attention", "route": "cuda", "source": K2_SOURCE,
         "replaces": K2_REPLACES, "launches": launches["hlsh_attention"],
         "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain_ms,
         "bound_ms": max(k2_bound_bytes, k2_bound_ops),
         "bound_by": "bytes" if k2_bound_bytes >= k2_bound_ops
         else "operations", "library_ms": k2_lib_ms},
    ]
    print(f"phase 5 {card}: K1 {k1_ms:.3f} ms per launch on the main path's "
          f"learned batch ({len(k1_batch)} lanes, {n_acc} accesses; plain "
          f"version {plain_s * 1e3:.1f} ms on the host); K2 {k2_ms:.4f} ms at "
          f"({b},{n},{d}) (plain {k2_plain_ms:.4f} ms, "
          f"scaled_dot_product_attention {k2_lib_ms:.4f} ms)", flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump({"device": kind, "nvidia_smi": smi, "rows": rows,
                       "kernels": kernels, "main_path_s": main_s}, f,
                      indent=1)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
