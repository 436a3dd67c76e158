"""Run one cell of the benchmark once and print its result line.

The flow of a run: look for the card; set up the program through the
configuration's driver (build or find K1, generate the traces, warm up);
measure whole passes for ``--seconds`` (under the profiler with ``--trace
1``); read the device's peak memory; free the program; judge what the
window produced against the plain reference; check that no JAX module is
loaded; print the numbers compared on standard error and the result as the
last line of standard output.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Dict, Iterable, List, Optional, Tuple

from uvmbench import spec, tracing

#: modules the measured process must not hold (top-level names, whole)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


def forbidden_loaded(modules: Iterable[str]) -> List[str]:
    """The forbidden top-level names among ``modules`` (module names)."""
    tops = {name.split(".")[0] for name in modules}
    return sorted(tops.intersection(FORBIDDEN_MODULES))


def look_for_chip(chips: int) -> Optional[str]:
    """Why this process cannot run a cell of ``chips`` cards, or None."""
    import torch
    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is false"
    if torch.cuda.device_count() < chips:
        return (f"the cell asks for {chips} cards, "
                f"torch.cuda.device_count() is {torch.cuda.device_count()}")
    return None


def power_limit_w() -> Optional[float]:
    """The card's power limit in watts, from nvidia-smi (None if absent)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def _log(msg: str) -> None:
    print(msg, flush=True)


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device: str, t_start: float, bench: Optional[Dict] = None,
             config: Optional[Dict] = None, traffic: Optional[Dict] = None,
             workers: Optional[int] = None) -> Tuple[Dict, Dict]:
    """Run cell ``name`` once on ``device`` (no look for a card).  Returns
    the result (the keys of the result line) and the numbers compared,
    ``{name: (value, limit)}``.  ``bench``/``config``/``traffic`` stand in
    for the files (tests run small copies)."""
    bench = bench or spec.benchmark()
    cell = spec.workload(name, bench)
    config = config or spec.config(cell["config"], bench)
    traffic = traffic or spec.traffic(cell["traffic"])
    driver = spec.driver(config["driver"])
    reference = spec.reference(config["driver"])

    program = driver.Program(config, traffic, seed, device)
    _log("setup " + json.dumps(program.setup_s))

    passes: List[List[Dict]] = []
    pass_s: List[float] = []
    summary: Dict = {}

    def window() -> Tuple[float, float]:
        w0 = time.perf_counter()
        setup_s = w0 - t_start
        while True:
            p0 = time.perf_counter()
            if trace:
                with tracing.span(tracing.PASS_SPAN):
                    rows = program.run_pass()
            else:
                rows = program.run_pass()
            pass_s.append(time.perf_counter() - p0)
            passes.append(rows)
            if time.perf_counter() - w0 >= seconds:
                return setup_s, time.perf_counter() - w0

    if trace:
        with tracing.Spans(program.span_targets()), \
                tracing.profiled(device) as summary:
            with tracing.span(tracing.WINDOW_SPAN):
                setup_s, window_s = window()
    else:
        setup_s, window_s = window()

    memory_peak = 0
    kind = "cpu"
    if device == "cuda":
        import torch
        memory_peak = int(torch.cuda.max_memory_allocated())
        kind = torch.cuda.get_device_name(0)
    counters = program.counters()
    all_rows = [r for rows in passes for r in rows]
    work = driver.work(all_rows)
    for i, (rows, s) in enumerate(zip(passes, pass_s)):
        _log(f"pass {i}: {len(rows)} rows, {driver.work(rows)} "
             f"{driver.WORK_UNIT}, {s:.4f} s, " + ", ".join(
                 f"{k} {v[i]}" for k, v in counters.items()))
    checks_in_window = program.window_checks(passes)
    traces = program.traces()
    program.close()
    del program

    readings, info = reference.check(config, traffic, seed, passes, traces,
                                     workers=workers)
    _log("window " + json.dumps(checks_in_window))
    _log("reference " + json.dumps(info))
    # the window's own guarantees are counts of facts that must be equal,
    # like the reference's mismatches, and share their limit
    readings["mismatches"] += sum(checks_in_window.values())
    limits = config["limits"]
    checks = {k: (v, limits[k]) for k, v in readings.items()}
    correct = all(v <= lim for v, lim in checks.values())
    failed = info["rows_failed"] + sum(
        checks_in_window.get(k, 0)
        for k in ("rows_missing", "non_cuda_rows", "pass_row_diffs"))

    section = "per_layer" if trace else "end_to_end"
    metrics: Dict[str, Dict] = {}
    if trace:
        record = {"passes": len(passes), "rows": all_rows, "accesses": work,
                  "window_s": window_s, "counters": counters,
                  "trace": summary}
        _log("trace " + json.dumps(summary))
        for m in spec.cell_metrics(name, bench, section):
            value = spec.metric_reader(m["name"]).read(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = {**driver.end_to_end(all_rows, window_s), "setup_s": setup_s}
        for m in spec.cell_metrics(name, bench, section):
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}

    dev = {"platform": "gpu" if device == "cuda" else device, "kind": kind,
           "count": 1, "memory_peak_bytes": memory_peak}
    if device == "cuda":
        dev["power_limit_w"] = power_limit_w()
    result = {"correct": correct, "attempted": len(all_rows),
              "failed": failed, "metrics": metrics, "device": dev}
    if trace and summary:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result, checks


def parse(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="uvmbench/run.py",
        description="Run one cell of BENCHMARK.json once and print its "
                    "result as the last line of standard output.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv: Optional[List[str]], t_start: float) -> int:
    args = parse(argv)
    if not os.path.isdir(os.path.join(spec.PROGRAM_SRC, "repro_torch")):
        print(f"the program is missing: no repro_torch under "
              f"{spec.PROGRAM_SRC}", file=sys.stderr)
        return 2
    bench = spec.benchmark()
    cell = spec.workload(args.workload, bench)
    why = look_for_chip(int(cell["chips"]))
    if why is not None:
        print(f"no card for {args.workload}: {why}", file=sys.stderr)
        return 2
    result, checks = run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), device="cuda",
                              t_start=t_start, bench=bench)
    found = forbidden_loaded(list(sys.modules))
    if found:
        print(f"the measured process holds {', '.join(found)}: the port "
              "must not load JAX or the JAX package", file=sys.stderr)
        return 3
    for k, (v, lim) in checks.items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
