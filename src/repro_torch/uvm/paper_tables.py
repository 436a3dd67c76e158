"""The paper's Table 10 (page hit rate), Table 11 (Unity), Fig 10 (IPC
against the prediction overhead), Figs 11-12 (PCIe interconnect usage) and
the §7.4 headline on the port.

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
:func:`fig12_rows` (``benchmarks/fig12_pcie.py``'s Fig 12) and
:func:`headline` (``benchmarks/perf_ipc.py``) are computed from the same 22
rows as the tables, so they replay nothing more; :func:`fig11_timeline`
replays BICG's tree and learned cells once more with their per-transfer
timelines (K1 records none, so they run on the NumPy engine) and bins them
into PCIe GB/s.

    from repro_torch.uvm import paper_tables
    rows = paper_tables.sweep_rows(device="cuda")
    table10, table11 = paper_tables.table10_rows(rows), \
        paper_tables.table11_rows(rows)
    fig12, (ipc, summary) = paper_tables.fig12_rows(rows), \
        paper_tables.headline(rows)
    fig10 = paper_tables.fig10(device="cuda")
    fig11 = paper_tables.fig11_timeline(device="cuda")
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.uvm.metrics import geomean, pcie_gbs_timeline
from repro_torch.uvm.scenarios import PAPER_BENCHMARKS
from repro_torch.uvm.sweep import SweepCell, run_sweep, simulate_cell

EVAL_WINDOW = 0.6
SERVICE_STEPS = 150
#: microseconds per prediction of Fig 10
LATENCIES = (1.0, 2.0, 5.0, 10.0)
#: Fig 11: the bench, the core clock of the GB/s timeline and the points of
#: each series its CSV keeps (``benchmarks/fig12_pcie.py``)
FIG11_BENCH = "BICG"
CORE_MHZ = 1481.0
FIG11_POINTS = 2000


def eval_cell(bench: str, prefetcher: str,
              prediction_us: float = 1.0) -> SweepCell:
    """The sweep-grid point of the paper's evaluation setup."""
    return SweepCell(bench=bench, prefetcher=prefetcher, window=EVAL_WINDOW,
                     prediction_us=prediction_us, engine="vectorized",
                     service_steps=SERVICE_STEPS)


def sweep_rows(benches: Sequence[str] = PAPER_BENCHMARKS, *,
               device: str = "cuda") -> List[Dict]:
    """The sweep rows of tree and learned on ``benches`` at the paper's
    evaluation point: what Tables 10-11, Fig 12 and the headline read."""
    return run_sweep([eval_cell(b, pf) for b in benches
                      for pf in ("tree", "learned")], device=device)


def run(benches: Sequence[str] = PAPER_BENCHMARKS, *,
        device: str = "cuda") -> Tuple[List[Dict], List[Dict]]:
    """Sweep tree and learned on ``benches`` once; returns the rows of
    Table 10 and of Table 11."""
    rows = sweep_rows(benches, device=device)
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


def fig12_rows(rows: Sequence[Dict]) -> List[Dict]:
    """Fig 12 from the tree and learned sweep rows: PCIe traffic in MB of
    UVMSmart (``pcie_U_mb``) and ours (``pcie_R_mb``) per bench, their
    ratio (``normalized``), and the geometric mean of the ratios
    (``GEOMEAN``)."""
    benches, by = _by_cell(rows)
    out, ratios = [], []
    for b in benches:
        tree, ours = by[(b, "tree")], by[(b, "learned")]
        ratio = ours["pcie_bytes"] / max(tree["pcie_bytes"], 1)
        ratios.append(ratio)
        out.append({"bench": b, "pcie_U_mb": tree["pcie_bytes"] / 1e6,
                    "pcie_R_mb": ours["pcie_bytes"] / 1e6,
                    "normalized": ratio})
    out.append({"bench": "GEOMEAN", "pcie_U_mb": float("nan"),
                "pcie_R_mb": float("nan"), "normalized": geomean(ratios)})
    return out


def headline(rows: Sequence[Dict]) -> Tuple[List[Dict], Dict[str, float]]:
    """The §7.4 headline from the tree and learned sweep rows: IPC of
    UVMSmart and ours and their ratio (``ipc_gain``) per bench with its
    geometric mean, and the summary (``ipc_gain_geomean``, the mean hit
    rates ``hit_U_mean``/``hit_R_mean``, ``traffic_ratio_geomean``)."""
    benches, by = _by_cell(rows)
    out = []
    gains, hits_u, hits_r, traffic = [], [], [], []
    for b in benches:
        tree, ours = by[(b, "tree")], by[(b, "learned")]
        g = ours["ipc"] / tree["ipc"]
        gains.append(g)
        hits_u.append(tree["hit_rate"])
        hits_r.append(ours["hit_rate"])
        traffic.append(ours["pcie_bytes"] / max(tree["pcie_bytes"], 1))
        out.append({"bench": b, "ipc_U": tree["ipc"], "ipc_R": ours["ipc"],
                    "ipc_gain": g})
    out.append({"bench": "GEOMEAN", "ipc_U": float("nan"),
                "ipc_R": float("nan"), "ipc_gain": geomean(gains)})
    summary = {
        "ipc_gain_geomean": geomean(gains),
        "hit_U_mean": sum(hits_u) / len(hits_u),
        "hit_R_mean": sum(hits_r) / len(hits_r),
        "traffic_ratio_geomean": geomean(traffic),
    }
    return out, summary


def fig11_timeline(bench: str = FIG11_BENCH, *, device: str = "cuda",
                   service_steps: int = SERVICE_STEPS
                   ) -> Dict[str, Tuple[Dict, np.ndarray]]:
    """Fig 11: PCIe GB/s over time of ``bench`` under UVMSmart (tree) and
    ours (learned), at the paper's evaluation point.  Returns, per
    prefetcher, its row (with the per-transfer ``timeline``) and the
    (window centre cycle, GB/s) series."""
    out = {}
    for pf in ("tree", "learned"):
        cell = dataclasses.replace(eval_cell(bench, pf),
                                   service_steps=service_steps)
        row = simulate_cell(cell, device=device, record_timeline=True)
        out[pf] = (row, pcie_gbs_timeline(np.asarray(row["timeline"]),
                                          core_mhz=CORE_MHZ))
    return out


def fig11_csv(series: Dict[str, Tuple[Dict, np.ndarray]]) -> str:
    """Fig 11's CSV sidecar (``benchmarks/fig12_pcie.py``'s format): the
    first :data:`FIG11_POINTS` points of each series."""
    lines = ["prefetcher,cycle,gbs"]
    for pf, (_, gbs) in series.items():
        for cyc, rate in gbs[:FIG11_POINTS]:
            lines.append(f"{pf},{cyc:.0f},{rate:.3f}")
    return "\n".join(lines)
