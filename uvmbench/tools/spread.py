"""Run one cell several times, one process after another, and report each
run's result and the spread of each metric.

    python3 uvmbench/tools/spread.py --workload paper11.oversub \\
        --seeds 11,12,13,14,15,16 --seconds 30 [--trace 1] [--out DIR]

The spread of a metric is the distance between its first and third
quartiles (``statistics.quantiles(values, n=4)``) as a share of its median.
With ``--out`` each run's standard output and error are kept there.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from typing import Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def spread(values: List[float]) -> Optional[float]:
    """Interquartile distance over the median, or None under two values."""
    if len(values) < 2:
        return None
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2 if q2 else None


def run_once(workload: str, seed: int, seconds: float, trace: int,
             out: Optional[str]) -> Dict:
    cmd = [sys.executable, os.path.join("uvmbench", "run.py"),
           "--workload", workload, "--seed", str(seed),
           "--seconds", str(seconds), "--trace", str(trace)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
    wall = time.perf_counter() - t0
    if out:
        os.makedirs(out, exist_ok=True)
        stem = os.path.join(out, f"{workload}.s{seed}.t{trace}")
        with open(stem + ".out", "w") as f:
            f.write(proc.stdout)
        with open(stem + ".err", "w") as f:
            f.write(proc.stderr)
    lines = proc.stdout.strip().splitlines()
    try:
        result = json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        result = None
    return {"seed": seed, "rc": proc.returncode, "wall_s": wall,
            "result": result, "stderr_tail": proc.stderr[-1500:]}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds, one run each")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    runs = []
    for seed in (int(s) for s in args.seeds.split(",")):
        run = run_once(args.workload, seed, args.seconds, args.trace,
                       args.out)
        res = run["result"] or {}
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "rc": run["rc"], "wall_s": run["wall_s"],
                          "correct": res.get("correct"),
                          "metrics": {k: v["value"] for k, v in
                                      res.get("metrics", {}).items()},
                          "checks": {k: v["value"] for k, v in
                                     res.get("checks", {}).items()},
                          "device": res.get("device"),
                          "breakdown": res.get("breakdown")}), flush=True)
        if run["rc"] != 0 or not res:
            print(run["stderr_tail"], flush=True)
        runs.append(res)
    names = sorted({k for r in runs for k in r.get("metrics", {})})
    summary = {}
    for k in names:
        vals = [r["metrics"][k]["value"] for r in runs
                if k in r.get("metrics", {})]
        summary[k] = {"n": len(vals), "median": statistics.median(vals),
                      "spread": spread(vals), "values": vals}
    print(json.dumps({"workload": args.workload, "summary": summary,
                      "all_correct": all(r.get("correct") for r in runs)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
