"""The paper's Table 10 and Table 11 on the port, on the CPU for one
benchmark at the paper's evaluation point (with 20 training steps instead of
150, to keep the CPU test short): the tree (UVMSmart) row equals
the reference's legacy engine on the reference's trace, the learned row
equals the legacy engine on the port's own predictions, and Table 11 adds
the means and the ideal row as the reference's table does."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.traces import GPUModel as RefGPUModel
from repro.traces import generate_benchmark as ref_generate
from repro.uvm.config import UVMConfig as RefConfig
from repro.uvm.prefetchers import TreePrefetcher as RefTree
from repro.uvm.simulator import UVMSimulator as RefSimulator
from repro_torch.uvm import paper_tables, predcache, sweep
from repro_torch.uvm.config import UVMConfig
from repro_torch.uvm.prefetchers import LearnedPrefetcher
from repro_torch.uvm.simulator import UVMSimulator

BENCH = "2DCONV"
#: training steps of the learned cells here (the tables' default is the
#: paper's 150; the learned row is checked on whatever predictions result)
STEPS = 20


@pytest.fixture(scope="module")
def tables():
    cells = [dataclasses.replace(paper_tables.eval_cell(BENCH, pf),
                                 service_steps=STEPS)
             for pf in ("tree", "learned")]
    rows = sweep.run_sweep(cells, device="cpu")
    return paper_tables.table10_rows(rows), paper_tables.table11_rows(rows)


def test_eval_cell_is_the_reference_grid_point():
    cell = paper_tables.eval_cell(BENCH, "tree")
    assert (cell.scale, cell.seed, cell.window, cell.prediction_us) == (
        1.0, 0, 0.6, 1.0)
    assert cell.device_pages is None and cell.device_frac is None
    assert cell.eviction == "lru" and cell.service_steps == 150


def test_table10_tree_row_is_the_reference_legacy_row(tables):
    (row,), _ = tables
    ref_trace, _ = RefGPUModel().run(ref_generate(BENCH)).split(0.6)
    want = RefSimulator(RefConfig()).run(ref_trace, RefTree())
    assert row["bench"] == BENCH
    assert row["hit_U"] == want.hit_rate
    assert row["simulated_inst"] == ref_trace.n_instructions


def test_table10_learned_row_equals_legacy_on_the_same_predictions(tables):
    (row,), t11 = tables
    trace = sweep.load_trace(BENCH, 1.0, 0, 0.6)
    preds = predcache.get_or_train(trace, steps=STEPS, device="cpu")
    cfg = UVMConfig()
    want = UVMSimulator(cfg).run(trace, LearnedPrefetcher(
        preds, extra_latency_cycles=cfg.cycles_per_us))
    assert row["hit_R"] == want.hit_rate
    learned = next(r for r in t11 if r["prefetcher"] == "R")
    assert (learned["acc"], learned["cov"], learned["unity"]) == (
        want.accuracy, want.coverage, want.unity)


def test_table11_layout(tables):
    _, rows = tables
    assert [(r["bench"], r["prefetcher"]) for r in rows] == [
        (BENCH, "U"), (BENCH, "R"), ("MEAN", "U"), ("MEAN", "R"),
        ("Ideal", "-")]
    for tag in ("U", "R"):
        mine = [r for r in rows if r["prefetcher"] == tag]
        assert mine[1]["unity"] == pytest.approx(np.mean(
            [r["unity"] for r in mine[:1]]))
        assert mine[0]["unity"] == pytest.approx(np.cbrt(
            mine[0]["acc"] * mine[0]["cov"] * mine[0]["hit"]))
