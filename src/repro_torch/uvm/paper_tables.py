"""The paper's Table 10 (page hit rate) and Table 11 (Unity) on the port.

Counterparts of the reference's ``benchmarks/table10_hitrate.py`` and
``benchmarks/table11_unity.py``: the UVMSmart ``tree`` baseline (U) against
the learned prefetcher (R) on the 11 paper benchmarks, at the paper's
evaluation grid point (scale 1.0, seed 0, the leading 0.6 of the trace,
1 us per prediction, unlimited device memory, lru eviction, 150 training
steps).  :func:`run` sweeps the 22 cells once through
:func:`repro_torch.uvm.sweep.run_sweep`, so every row is replayed by K1,
and formats both tables from the same rows.

    from repro_torch.uvm import paper_tables
    table10, table11 = paper_tables.run(device="cuda")
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.uvm.scenarios import PAPER_BENCHMARKS
from repro_torch.uvm.sweep import SweepCell, run_sweep

EVAL_WINDOW = 0.6
SERVICE_STEPS = 150


def eval_cell(bench: str, prefetcher: str) -> SweepCell:
    """The sweep-grid point of the paper's evaluation setup."""
    return SweepCell(bench=bench, prefetcher=prefetcher, window=EVAL_WINDOW,
                     engine="vectorized", service_steps=SERVICE_STEPS)


def run(benches: Sequence[str] = PAPER_BENCHMARKS, *,
        device: str = "cuda") -> Tuple[List[Dict], List[Dict]]:
    """Sweep tree and learned on ``benches`` once; returns the rows of
    Table 10 and of Table 11."""
    rows = run_sweep([eval_cell(b, pf) for b in benches
                      for pf in ("tree", "learned")], device=device)
    return table10_rows(rows), table11_rows(rows)


def _by_cell(rows: Sequence[Dict]) -> Tuple[List[str], Dict]:
    benches = list(dict.fromkeys(r["bench"] for r in rows))
    return benches, {(r["bench"], r["prefetcher"]): r for r in rows}


def table10_rows(rows: Sequence[Dict]) -> List[Dict]:
    """Table 10 from the tree and learned sweep rows: page hit rate,
    UVMSmart (``hit_U``) vs ours (``hit_R``), one row per benchmark."""
    benches, by = _by_cell(rows)
    return [{"bench": b, "hit_U": by[(b, "tree")]["hit_rate"],
             "hit_R": by[(b, "learned")]["hit_rate"],
             "simulated_inst": int(by[(b, "tree")]["n_instructions"])}
            for b in benches]


def table11_rows(rows: Sequence[Dict]) -> List[Dict]:
    """Table 11 from the tree and learned sweep rows: accuracy, coverage,
    hit rate and Unity = cbrt(accuracy x coverage x hit rate) per benchmark
    for U (tree) then R (learned), the mean of each, and the ideal row."""
    benches, by = _by_cell(rows)
    out = []
    for pf, tag in (("tree", "U"), ("learned", "R")):
        for b in benches:
            r = by[(b, pf)]
            out.append({"bench": b, "prefetcher": tag, "acc": r["accuracy"],
                        "cov": r["coverage"], "hit": r["hit_rate"],
                        "unity": r["unity"]})
    for tag in ("U", "R"):
        mine = [r for r in out if r["prefetcher"] == tag]
        out.append({"bench": "MEAN", "prefetcher": tag,
                    **{f: float(np.mean([r[f] for r in mine]))
                       for f in ("acc", "cov", "hit", "unity")}})
    out.append({"bench": "Ideal", "prefetcher": "-", "acc": 1.0, "cov": 1.0,
                "hit": 1.0, "unity": 1.0})
    return out
