"""The paper's predictor evaluation on the port against the reference's
benchmark scripts: the port's ``train_cell`` builds the reference's
configuration, step count and dataset for every distinct cell the scripts
ask for on ATAX and NW (the reference's trainer replaced by a recorder, its
disk cache pointed at a temporary directory); each table runner issues the
reference script's cells in its order and gives its rows and columns, and
runs for real on one bench at a few steps; ``pretrain_corpus`` builds the
reference's corpus; Fig 10 on one bench gives the reference's rows from the
port's sweep, its learned rows equal to the legacy engine on the same
predictions."""
import dataclasses
import importlib
import math
import os
import sys
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.join(os.path.dirname(__file__), "..")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import benchmarks.common as ref_common
from repro.core import families as ref_families
from repro.core import service as ref_service
from repro.core.features import cluster_trace as ref_cluster_trace
from repro.core.vocab import DeltaVocab as RefVocab
from repro.traces import GPUModel as RefGPUModel
from repro.traces import generate_benchmark as ref_generate
from repro_torch.core import families as t_families
from repro_torch.core import predictor_tables as pt
from repro_torch.core import service as t_service
from repro_torch.core.features import cluster_trace as t_cluster_trace
from repro_torch.core.vocab import DeltaVocab as TVocab
from repro_torch.traces import GPUModel as TGPUModel
from repro_torch.traces import generate_benchmark as t_generate
from repro_torch.uvm import paper_tables, predcache, sweep
from repro_torch.uvm.simulator import UVMSimulator

#: each port table and the reference script it ports
SCRIPTS = {"table1": "table1_transformer", "table2": "table2_clustering",
           "table3": "table3_distance", "table4": "table4_fc",
           "table5": "table5_hlsh", "table8": "table8_revised",
           "fig5": "fig5_features", "fig6": "fig6_convergence",
           "fig9": "fig9_predictors"}
DATA_BENCHES = ("ATAX", "NW")
ARRAYS = ("x_train", "y_train", "x_valid", "y_valid", "x_test", "y_test")


def _fake_result(bench, kw):
    """Deterministic stand-in metrics of one cell, distinct per cell."""
    h = zlib.crc32(repr((bench, sorted(kw.items()))).encode())
    return {"bench": bench, "f1": (h % 997) / 997,
            "top1": (h % 991) / 991, "top10": (h % 983) / 983,
            "convergence": (h % 977) / 977}


def _calls(monkeypatch, module, fn, device_kw):
    """Run ``fn`` with ``module.train_cell`` replaced by a recorder: the
    (bench, kwargs) calls in order (``device`` dropped) and the rows."""
    calls = []

    def recorder(bench, **kw):
        if device_kw:
            assert kw.pop("device") == "cpu"
        calls.append((bench, kw))
        return _fake_result(bench, kw)
    monkeypatch.setattr(module, "train_cell", recorder)
    rows = fn()
    return calls, rows


def _ref_script(name):
    return importlib.import_module(f"benchmarks.{SCRIPTS[name]}")


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_tables_issue_the_reference_cells_and_rows(monkeypatch, name):
    """Every table, at the reference's full bench lists: the same cells in
    the same order, and the same rows (columns, order, values) from the
    same cell results."""
    mod = _ref_script(name)
    want_calls, want_rows = _calls(monkeypatch, mod, mod.run, False)
    got_calls, got_rows = _calls(
        monkeypatch, pt, lambda: pt.TABLES[name](device="cpu"), True)
    assert got_calls == want_calls
    assert got_rows == want_rows
    assert all(list(r) == pt.COLUMNS[name] for r in got_rows)


class _Recorded:
    """A trainer's stand-in: records (cfg, data, steps) and returns a
    result with fixed metrics."""

    def __init__(self):
        self.fits = []

    def __call__(self, cfg, data, *, steps, **kw):
        self.fits.append((cfg, data, steps, kw))
        return type("Res", (), {
            "metrics": {"f1": 0.5, "top1": 0.5, "top10": 0.5},
            "train_seconds": 0.0, "steps": steps, "params": {},
            "model": torch.nn.Linear(1, 1)})()


def _distinct_reference_cells(monkeypatch):
    """The (bench, kwargs) of every train_cell call the reference scripts
    make on ATAX and NW."""
    calls = []
    for name in sorted(SCRIPTS):
        mod = _ref_script(name)
        c, _ = _calls(monkeypatch, mod, mod.run, False)
        calls += [(b, kw) for b, kw in c if b in DATA_BENCHES]
    return calls


def test_train_cell_builds_the_reference_config_steps_and_dataset(
        monkeypatch, tmp_path):
    calls = _distinct_reference_cells(monkeypatch)
    monkeypatch.setattr(ref_common, "CACHE_DIR", str(tmp_path))
    ref_fit, port_fit = _Recorded(), _Recorded()
    monkeypatch.setattr(ref_common, "train_predictor", ref_fit)
    monkeypatch.setattr(pt, "train_predictor", port_fit)
    monkeypatch.setattr(pt, "_MEMO", {})
    for bench, kw in calls:
        want = ref_common.train_cell(bench, **kw)
        got = pt.train_cell(bench, device="cpu", **kw)
        assert got["_key"] == want["_key"]
        for f in ("convergence", "n_classes", "d_model"):
            assert got[f] == want[f], (bench, kw, f)
    # each distinct key fitted once on each side, in the same order: on
    # ATAX and NW, Table 1's 2 cells, Table 2's 4 other clusterings of NW,
    # Table 3's 2 at distance 30, Table 4's 2 shuffled Transformers and 2
    # FCs, Table 5's 2 HLSH (its full rows are Table 4's), Table 8's 2
    # revised, Fig 5's 8 single features of NW, Fig 9's 6 LSTM/CNN/MLP and 2
    # revised (its Transformer rows are Table 1's, all of Fig 6's are
    # Tables 1 and 4's)
    assert len(ref_fit.fits) == len(port_fit.fits) == pt.memo_size() == 32
    for (rc, rd, rs, rkw), (tc, td, ts, tkw) in zip(ref_fit.fits,
                                                    port_fit.fits):
        assert dataclasses.asdict(tc) == dataclasses.asdict(rc)
        assert ts == rs
        assert tkw == {"device": "cpu"} and rkw == {}
        assert (td.n_classes, list(td.features)) == (rd.n_classes,
                                                     list(rd.features))
        for a in ARRAYS:
            np.testing.assert_array_equal(getattr(td, a), getattr(rd, a),
                                          err_msg=f"{tc} {a}")


def test_pretrain_corpus_builds_the_reference_corpus(monkeypatch):
    """Two benchmarks whose SM x warp streams outlast a window and the
    distance of 30 in their leading halves (Pathfinder at scale 0.25, NW
    at 1.0), the vocab built over NW's."""
    cases = (("Pathfinder", 0.25), ("NW", 1.0))
    ref_traces = [RefGPUModel().run(ref_generate(b, scale=sc))
                  for b, sc in cases]
    t_traces = [TGPUModel().run(t_generate(b, scale=sc)) for b, sc in cases]
    ref_vocab = RefVocab.build(ref_cluster_trace(ref_traces[1], "sm_warp"),
                               distance=30)
    t_vocab = TVocab.build(t_cluster_trace(t_traces[1], "sm_warp"),
                           distance=30)
    ref_cfg = ref_families.revised_config(ref_vocab.n_classes, 0.2)
    t_cfg = t_families.revised_config(t_vocab.n_classes, 0.2)
    ref_fit, port_fit = _Recorded(), _Recorded()
    monkeypatch.setattr(ref_service, "train_predictor", ref_fit)
    monkeypatch.setattr(t_service, "train_predictor", port_fit)
    ref_service.pretrain_corpus(ref_traces, ref_cfg, ref_vocab, steps=7,
                                seed=3)
    state = t_service.pretrain_corpus(t_traces, t_cfg, t_vocab, steps=7,
                                      seed=3, device="cpu")
    (rc, rd, rs, rkw), = ref_fit.fits
    (tc, td, ts, tkw), = port_fit.fits
    assert dataclasses.asdict(tc) == dataclasses.asdict(rc)
    assert (ts, tkw) == (rs, dict(rkw, device="cpu")) == (7, {"seed": 3,
                                                              "device": "cpu"})
    assert len(rd.x_train) > 256
    for a in ARRAYS:
        np.testing.assert_array_equal(getattr(td, a), getattr(rd, a))
    assert set(state) == {"weight", "bias"}


@pytest.mark.parametrize("name", sorted(pt.TABLES))
def test_tables_run_on_one_bench(monkeypatch, name):
    """Each table for real on one bench at a few steps: the reference's
    columns, one row per cell of that bench, finite metrics in [0, 1]."""
    monkeypatch.setattr(pt, "STEPS", 2)
    monkeypatch.setattr(pt, "REVISED_STEPS", 3)
    monkeypatch.setattr(pt, "FIG5_STEPS", 2)
    rows = pt.TABLES[name](["NW"], device="cpu")
    expect = {"table1": 1, "table2": 5, "table3": 2, "table4": 2,
              "table5": 2, "table67": 1, "table8": 1, "fig5": 8, "fig6": 1,
              "fig9": 5}[name]
    assert len(rows) == expect
    for r in rows:
        assert list(r) == pt.COLUMNS[name] and r["bench"] == "NW"
        for c in pt.COLUMNS[name]:
            if c.startswith(("f1", "top1", "top10", "convergence")):
                assert 0.0 <= r[c] <= 1.0 and math.isfinite(r[c]), (c, r)
    for cell in pt.fitted_cells():
        assert cell["devices"] == ["cpu"]


FIG10_BENCH = "2DCONV"
#: training steps of the learned cells here (the figure's default is the
#: paper's 150; the learned rows are checked on whatever predictions result)
FIG10_STEPS = 20


def test_fig10_on_one_bench(monkeypatch):
    """The port's Fig 10 grid is the reference's, its rows are what the
    reference's ``fig10_latency.run`` makes of the port's sweep rows, and
    each learned row equals the legacy engine on the same predictions."""
    import benchmarks.fig10_latency as ref_fig10
    cells = [dataclasses.replace(c, service_steps=FIG10_STEPS)
             for c in paper_tables.fig10_cells([FIG10_BENCH])]
    ref_cells = [ref_common._eval_cell(FIG10_BENCH, "tree")] + [
        ref_common._eval_cell(FIG10_BENCH, "learned", prediction_us=us)
        for us in ref_fig10.LATENCIES]
    fields = ("bench", "prefetcher", "prediction_us", "window", "scale",
              "seed", "device_pages", "eviction")
    assert [tuple(getattr(c, f) for f in fields) for c in cells] == [
        tuple(getattr(c, f) for f in fields) for c in ref_cells]
    rows = sweep.run_sweep(cells, device="cpu")
    got = paper_tables.fig10_rows(rows)
    monkeypatch.setattr(ref_fig10, "ALL_BENCHMARKS", [FIG10_BENCH])
    monkeypatch.setattr(ref_fig10, "uvm_sweep", lambda _cells: rows)
    assert got == ref_fig10.run()
    assert [(r["bench"], r["latency_us"]) for r in got] == [
        (b, us) for b in (FIG10_BENCH, "GEOMEAN")
        for us in paper_tables.LATENCIES]
    trace = sweep.load_trace(FIG10_BENCH, 1.0, 0, 0.6)
    preds = predcache.get_or_train(trace, steps=FIG10_STEPS, device="cpu")
    for cell, row in zip(cells, rows):
        if cell.prefetcher != "learned":
            continue
        tr, config, pf, _ = sweep.prepare_cell(cell, device="cpu")
        np.testing.assert_array_equal(pf.predicted_pages, preds)
        assert pf.extra_latency_cycles == (cell.prediction_us
                                           * config.cycles_per_us)
        want = UVMSimulator(config).run(tr, pf)
        assert (row["hits"], row["faults"], row["ipc"]) == (
            want.hits, want.faults, want.ipc)
