"""The control of a cell's comparison: the reference put in the program's
place, computed one precision below the configuration's (float32 clocks
for the float64 the configuration states), judged by the same comparison
on the same sample of rows.  It must come out not correct.

    python3 uvmbench/tools/control.py --workload paper11.oversub \\
        --seeds 11,12,13

It runs on the host alone, at the cell's own size, and prints each seed's
readings beside the limits and whether the comparison rejects them.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def control_readings(config: Dict, traffic: Dict, seed: int,
                     workers: Optional[int] = None,
                     clock: str = "float32") -> Dict:
    """The comparison's readings of the reference computed with ``clock``
    standing in for the program's rows (one pass)."""
    from uvmbench import spec
    ref = spec.reference(config["driver"])
    cells = ref.grid(config, traffic, seed)
    sample = ref.draw_sample(cells, 1, seed, int(traffic["check_per_group"]))
    wanted = sorted({i for _, i in sample})
    tasks = [("row", i, (cells[i], config["uvm"], clock)) for i in wanted]
    workers = ref.default_workers() if workers is None else workers
    got = {k: v for _, k, v in ref.run_tasks(tasks, workers)}
    rows = [got.get(i) for i in range(len(cells))]
    traces = {b: ref.trace_facts(b, float(config["scale"]),
                                 int(config["trace_seed"]), config["window"])
              for b in dict.fromkeys(c["bench"] for c in cells)}
    readings, info = ref.check(config, traffic, seed, [rows], traces,
                               workers=workers)
    return {"readings": readings, "info": info}


def main(argv: Optional[List[str]] = None) -> int:
    sys.path[:0] = [ROOT]
    from uvmbench import spec
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--clock", default="float32")
    args = ap.parse_args(argv)
    bench = spec.benchmark()
    cell = spec.workload(args.workload, bench)
    config = spec.config(cell["config"], bench)
    traffic = spec.traffic(cell["traffic"])
    limits = config["limits"]
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = control_readings(config, traffic, seed, clock=args.clock)
        rejected = [k for k, v in out["readings"].items() if v > limits[k]]
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "clock": args.clock, **out,
                          "limits": {k: limits[k] for k in out["readings"]},
                          "rejected_by": rejected,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
