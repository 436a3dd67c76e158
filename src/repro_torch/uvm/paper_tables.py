"""The paper's Table 10 (page hit rate), Table 11 (Unity) and Fig 10
(IPC against the prediction overhead) on the port.

Counterparts of the reference's ``benchmarks/table10_hitrate.py`` and
``benchmarks/table11_unity.py``: the UVMSmart ``tree`` baseline (U) against
the learned prefetcher (R) on the 11 paper benchmarks, at the paper's
evaluation grid point (scale 1.0, seed 0, the leading 0.6 of the trace,
1 us per prediction, unlimited device memory, lru eviction, 150 training
steps).  :func:`run` sweeps the 22 cells once through
:func:`repro_torch.uvm.sweep.run_sweep`, so every row is replayed by K1,
and formats both tables from the same rows.  :func:`fig10` (the
counterpart of ``benchmarks/fig10_latency.py``) sweeps tree and learned at
1, 2, 5 and 10 us per prediction: every latency replays the same
predictions, so a sweep that already trained the benches' predictors at this
grid point (the same process's prediction cache) trains nothing more.

    from repro_torch.uvm import paper_tables
    table10, table11 = paper_tables.run(device="cuda")
    fig10 = paper_tables.fig10(device="cuda")
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.uvm.scenarios import PAPER_BENCHMARKS
from repro_torch.uvm.sweep import SweepCell, run_sweep

EVAL_WINDOW = 0.6
SERVICE_STEPS = 150
#: microseconds per prediction of Fig 10
LATENCIES = (1.0, 2.0, 5.0, 10.0)


def eval_cell(bench: str, prefetcher: str,
              prediction_us: float = 1.0) -> SweepCell:
    """The sweep-grid point of the paper's evaluation setup."""
    return SweepCell(bench=bench, prefetcher=prefetcher, window=EVAL_WINDOW,
                     prediction_us=prediction_us, engine="vectorized",
                     service_steps=SERVICE_STEPS)


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


def fig10_cells(benches: Sequence[str] = PAPER_BENCHMARKS) -> List[SweepCell]:
    """Fig 10's grid, in the reference's order: tree on every bench, then
    learned at each latency on every bench."""
    return ([eval_cell(b, "tree") for b in benches]
            + [eval_cell(b, "learned", us) for us in LATENCIES
               for b in benches])


def geomean(xs: Sequence[float]) -> float:
    xs = np.asarray(xs, dtype=np.float64)
    return float(np.exp(np.mean(np.log(np.maximum(xs, 1e-12)))))


def fig10_rows(rows: Sequence[Dict]) -> List[Dict]:
    """Fig 10 from the sweep rows of :func:`fig10_cells`: ``ipc_normalized``
    = IPC(learned at the latency) / IPC(tree) per bench and latency, then
    the geometric mean over the benches at each latency (``GEOMEAN``)."""
    benches = list(dict.fromkeys(r["bench"] for r in rows))
    by = {(r["bench"], r["prefetcher"], r["prediction_us"]): r for r in rows}
    out = []
    means = {}
    for us in LATENCIES:
        gains = []
        for b in benches:
            gain = by[(b, "learned", us)]["ipc"] / by[(b, "tree", 1.0)]["ipc"]
            gains.append(gain)
            out.append({"bench": b, "latency_us": us,
                        "ipc_normalized": gain})
        means[us] = geomean(gains)
    for us, g in means.items():
        out.append({"bench": "GEOMEAN", "latency_us": us,
                    "ipc_normalized": g})
    return out


def fig10(benches: Sequence[str] = PAPER_BENCHMARKS, *,
          device: str = "cuda") -> List[Dict]:
    """Fig 10: IPC sensitivity to the prediction overhead, normalised to the
    UVMSmart (tree) runtime, on ``benches``."""
    return fig10_rows(run_sweep(fig10_cells(benches), device=device))
