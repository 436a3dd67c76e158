"""The paper's interconnect results on the port, on the CPU at the paper's
evaluation point for two benchmarks (with 20 training steps instead of 150):
Fig 12's rows and the §7.4 headline are what the reference's
``benchmarks/fig12_pcie.run`` and ``benchmarks/perf_ipc.run`` make of the
port's sweep rows, and Fig 11's BICG series is the reference's
``pcie_gbs_timeline`` of a timeline equal to the legacy engine's, replayed
on the NumPy engine."""
import dataclasses
import math

import numpy as np
import pytest

pytest.importorskip("torch")

import benchmarks.fig12_pcie as ref_fig12
import benchmarks.perf_ipc as ref_ipc
from repro.uvm.metrics import pcie_gbs_timeline as ref_gbs
from repro_torch.uvm import paper_tables, sweep
from repro_torch.uvm.simulator import UVMSimulator

BENCHES = ["BICG", "2DCONV"]
#: training steps of the learned cells here (the figures' default is the
#: paper's 150; the learned rows are checked on whatever predictions result)
STEPS = 20


def _cells():
    return [dataclasses.replace(paper_tables.eval_cell(b, pf),
                                service_steps=STEPS)
            for b in BENCHES for pf in ("tree", "learned")]


@pytest.fixture(scope="module")
def rows():
    return sweep.run_sweep(_cells(), device="cpu")


def _same(got, want):
    """Rows equal, NaN equal to NaN."""
    assert [list(r) for r in got] == [list(r) for r in want]
    for g, w in zip(got, want):
        for k, v in w.items():
            if isinstance(v, float) and math.isnan(v):
                assert math.isnan(g[k]), (w["bench"], k)
            else:
                assert g[k] == v, (w["bench"], k)


def test_fig12_rows_equal_the_reference(rows, monkeypatch):
    assert all(r["backend"] == "cuda" for r in rows)
    by = {(r["bench"], r["prefetcher"]): r for r in rows}
    monkeypatch.setattr(ref_fig12, "ALL_BENCHMARKS", BENCHES)
    monkeypatch.setattr(ref_fig12, "uvm_cell",
                        lambda bench, pf, **kw: by[(bench, pf)])
    got = paper_tables.fig12_rows(rows)
    _same(got, ref_fig12.run())
    assert [r["bench"] for r in got] == BENCHES + ["GEOMEAN"]
    assert all(r["normalized"] > 0 for r in got)


def test_headline_equals_the_reference(rows, monkeypatch):
    def ref_sweep(cells):
        assert [(c.bench, c.prefetcher) for c in cells] == [
            (r["bench"], r["prefetcher"]) for r in rows]
        return rows

    monkeypatch.setattr(ref_ipc, "ALL_BENCHMARKS", BENCHES)
    monkeypatch.setattr(ref_ipc, "uvm_sweep", ref_sweep)
    got_rows, got = paper_tables.headline(rows)
    want_rows, want = ref_ipc.run()
    _same(got_rows, want_rows)
    assert got == want
    assert set(got) == {"ipc_gain_geomean", "hit_U_mean", "hit_R_mean",
                        "traffic_ratio_geomean"}


def test_fig11_timeline_is_the_reference_series(rows):
    """BICG's tree and learned cells with their timelines: on the NumPy
    engine, counters equal to the same cells' K1 rows, timelines equal to
    the legacy engine's, and each GB/s series the reference's
    ``pcie_gbs_timeline`` of that timeline at 1481 MHz."""
    series = paper_tables.fig11_timeline(device="cpu", service_steps=STEPS)
    assert list(series) == ["tree", "learned"]
    by = {(r["bench"], r["prefetcher"]): r for r in rows}
    for pf, (row, gbs) in series.items():
        assert row["backend"] == "numpy"
        for f in ("hits", "faults", "pages_migrated", "pcie_bytes"):
            assert row[f] == by[("BICG", pf)][f], (pf, f)
        timeline = np.asarray(row["timeline"])
        cell = dataclasses.replace(paper_tables.eval_cell("BICG", pf),
                                   service_steps=STEPS)
        trace, config, prefetcher, _ = sweep.prepare_cell(cell, device="cpu")
        want = UVMSimulator(config, record_timeline=True).run(trace,
                                                              prefetcher)
        np.testing.assert_allclose(timeline, want.timeline, rtol=1e-6)
        np.testing.assert_array_equal(gbs, ref_gbs(timeline,
                                                   core_mhz=1481.0))
        assert len(gbs) > 0 and (gbs[:, 1] >= 0).all()
    csv = paper_tables.fig11_csv(series).splitlines()
    assert csv[0] == "prefetcher,cycle,gbs"
    assert len(csv) == 1 + sum(min(len(g), paper_tables.FIG11_POINTS)
                               for _, g in series.values())
    cyc, rate = series["tree"][1][0]
    assert csv[1] == f"tree,{cyc:.0f},{rate:.3f}"
