"""Generate the dry-run / roofline / perf tables from the recorded dry-run
and hillclimb JSON records (``launch.dryrun``, ``launch.hillclimb``).

Counterpart of the reference's ``repro.launch.report``: the same tables from
the same record keys.  The port's records carry its own accounting (fake
DTensor steps, H100 constants; ``launch.roofline``), so the tables are
roofline estimates of the port on H100s, not measurements.

    PYTHONPATH=src python -m repro_torch.launch.report > experiments/report.md
"""
from __future__ import annotations

import glob
import json
import os
from typing import Dict, List

SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def _load(dirpath: str) -> List[Dict]:
    out = []
    for path in sorted(glob.glob(os.path.join(dirpath, "*", "*.json"))):
        with open(path) as f:
            out.append(json.load(f))
    return out


def _ms(x) -> str:
    return f"{x*1e3:.2f}"


def dryrun_table(recs: List[Dict]) -> str:
    lines = ["| arch | shape | status | peak GB/chip | compile s | "
             "collectives (AG/AR/RS/A2A/CP) |",
             "|---|---|---|---|---|---|"]
    key = lambda r: (r["arch"], SHAPE_ORDER.index(r["shape"])
                     if r["shape"] in SHAPE_ORDER else 9)
    for r in sorted(recs, key=key):
        if r["status"] != "ok":
            reason = r.get("reason", r.get("error", ""))[:60]
            lines.append(f"| {r['arch']} | {r['shape']} | {r['status']}: "
                         f"{reason} | | | |")
            continue
        mem = r.get("memory", {})
        peak = mem.get("peak_bytes") or mem.get("temp_bytes") or 0
        cc = (r.get("roofline", {}).get("coll_counts") or {})
        counts = "/".join(str(cc.get(k, 0)) for k in
                          ("all-gather", "all-reduce", "reduce-scatter",
                           "all-to-all", "collective-permute"))
        lines.append(
            f"| {r['arch']} | {r['shape']} | ok | "
            f"{(peak or 0)/1e9:.2f} | {r.get('compile_s', 0):.0f} | "
            f"{counts} |")
    return "\n".join(lines)


def roofline_table(recs: List[Dict]) -> str:
    lines = ["| arch | shape | compute ms | memory ms | collective ms | "
             "bottleneck | MODEL_FLOPS/HLO | note |",
             "|---|---|---|---|---|---|---|---|"]
    key = lambda r: (r["arch"], SHAPE_ORDER.index(r["shape"])
                     if r["shape"] in SHAPE_ORDER else 9)
    for r in sorted(recs, key=key):
        if r["status"] != "ok":
            lines.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                         f"{r['status']} | — | {r.get('reason','')[:48]} |")
            continue
        roof = r["roofline"]
        ratio = r.get("useful_flops_ratio")
        note = _move_note(roof["bottleneck"], r)
        lines.append(
            f"| {r['arch']} | {r['shape']} | {_ms(roof['compute_s'])} | "
            f"{_ms(roof['memory_s'])} | {_ms(roof['collective_s'])} | "
            f"{roof['bottleneck']} | "
            f"{ratio:.3f} | {note} |" if ratio is not None else
            f"| {r['arch']} | {r['shape']} | {_ms(roof['compute_s'])} | "
            f"{_ms(roof['memory_s'])} | {_ms(roof['collective_s'])} | "
            f"{roof['bottleneck']} | — | {note} |")
    return "\n".join(lines)


def _move_note(bottleneck: str, r: Dict) -> str:
    shape = r["shape"]
    if bottleneck == "compute":
        if "moe" in r["arch"]:
            return "cut capacity factor / drop remat recompute"
        return "drop remat recompute; bf16 accumulations"
    if bottleneck == "memory":
        if shape.startswith("prefill") or shape == "train_4k":
            return "fuse attention (flash kernel) to kill S^2 logit traffic"
        return "bf16 logits; shrink cache reads via windowing"
    return "de-FSDP hot weights / overlap collectives with compute"


def perf_table(perf_dir: str) -> str:
    lines = ["| cell | variant | hypothesis | compute ms | memory ms | "
             "collective ms | bottleneck | verdict |",
             "|---|---|---|---|---|---|---|---|"]
    by_cell: Dict[str, List[Dict]] = {}
    for path in sorted(glob.glob(os.path.join(perf_dir, "*.json"))):
        cell, variant = os.path.basename(path)[:-5].split(".", 1)
        with open(path) as f:
            r = json.load(f)
        r["_cell"], r["_variant"] = cell, variant
        by_cell.setdefault(cell, []).append(r)
    for cell, rs in by_cell.items():
        base = next((r for r in rs if r["_variant"] == "baseline"), None)
        bdom = (base or {}).get("roofline", {})
        for r in rs:
            if r.get("status") != "ok":
                lines.append(f"| {cell} | {r['_variant']} | "
                             f"{r.get('hypothesis','')[:60]} | — | — | — | "
                             f"failed | {r.get('error','')[:40]} |")
                continue
            roof = r["roofline"]
            verdict = ""
            if base and r is not base and bdom:
                deltas = {}
                for term in ("compute", "memory", "collective"):
                    before = bdom[f"{term}_s"]
                    after = roof[f"{term}_s"]
                    deltas[term] = ((before - after) / before * 100
                                    if before else 0.0)
                dom = bdom["bottleneck"]
                best = max(deltas, key=deltas.get)
                ok = deltas[dom] > 2 or deltas[best] > 10
                verdict = (f"{'confirmed' if ok else 'refuted'} "
                           f"({dom} {deltas[dom]:+.1f}%"
                           + (f"; {best} {deltas[best]:+.1f}%"
                              if best != dom else "") + ")")
            lines.append(
                f"| {cell} | {r['_variant']} | "
                f"{r.get('hypothesis', '')[:60]} | "
                f"{_ms(roof['compute_s'])} | {_ms(roof['memory_s'])} | "
                f"{_ms(roof['collective_s'])} | {roof['bottleneck']} | "
                f"{verdict} |")
    return "\n".join(lines)


def main(argv=None) -> None:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", default="experiments",
                    help="the directory holding dryrun/ and perf/")
    base = ap.parse_args(argv).base
    print("# Generated dry-run / roofline / perf report\n")
    for mesh in ("single_pod_16x16", "multi_pod_2x16x16"):
        d = os.path.join(base, "dryrun", mesh)
        if not os.path.isdir(d):
            continue
        recs = _load(d)
        print(f"\n## Dry-run — {mesh} ({len(recs)} cells)\n")
        print(dryrun_table(recs))
        if mesh == "single_pod_16x16":
            print(f"\n## Roofline — {mesh}\n")
            print(roofline_table(recs))
    perf = os.path.join(base, "perf")
    if os.path.isdir(perf):
        print("\n## Perf iterations\n")
        print(perf_table(perf))


if __name__ == "__main__":
    main()
