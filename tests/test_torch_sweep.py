"""The port's sweep entry point and prediction cache: the cells of all five
prefetchers under the three eviction policies and the adaptive
pseudo-policy, on benchmark, serve and multi-tenant traces, expand, run,
equal the legacy engine and write rows with the reference's columns; cells
the port cannot run (yet) raise, naming why; prediction arrays are keyed
apart from the JAX package's and stored with a checksum."""
import csv
import os
import warnings

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.uvm import predcache as ref_predcache
from repro.uvm import sweep as ref_sweep
from repro_torch.core.service import PredictorService
from repro_torch.uvm import adaptive, predcache, sweep
from repro_torch.uvm.simulator import UVMSimulator


@pytest.fixture(scope="module")
def trace():
    return sweep.load_trace("ATAX", 0.25, 0, 0.6)


def test_row_schema_is_the_reference_schema():
    assert sweep.SWEEP_VERSION == ref_sweep.SWEEP_VERSION
    assert sweep.ROW_FIELDS == ref_sweep.ROW_FIELDS
    assert ([f.name for f in sweep.SweepCell.__dataclass_fields__.values()]
            == [f.name for f in ref_sweep.SweepCell.__dataclass_fields__
                .values()])


def test_expand_grid_order():
    cells = sweep.expand_grid(["ATAX", "NW"], ["none", "learned"],
                              device_fracs=[None, 0.5], service_steps=7)
    assert [(c.bench, c.prefetcher, c.device_frac) for c in cells] == [
        (b, p, f) for b in ("ATAX", "NW") for p in ("none", "learned")
        for f in (None, 0.5)]
    assert all(c.service_steps == 7 and c.backend == "cuda" for c in cells)


def test_expand_grid_is_the_reference_grid_with_families_and_splits():
    kw = dict(device_fracs=[None, 0.5], evictions=["lru", "adaptive"],
              model_families=["simplified", "transformer"],
              capacity_splits=["shared", "0.4/0.4"])
    mine = [c.to_dict() for c in sweep.expand_grid(
        ["ATAX+Pathfinder"], ["learned"], **kw)]
    ref = [c.to_dict() for c in ref_sweep.expand_grid(
        ["ATAX+Pathfinder"], ["learned"], **kw)]
    assert len(mine) == len(ref) == 16
    assert all(c.pop("backend") == "cuda" for c in mine)
    assert all(c.pop("backend") == "auto" for c in ref)
    assert mine == ref


@pytest.mark.parametrize("change,match", [
    pytest.param({"bench": "ServeDecode", "window": None}, None,
                 id="change0-serve scenarios with step clocks are a later "
                 "slice"),
    ({"prefetcher": "bogus"}, "unknown prefetcher 'bogus'"),
    ({"model_family": "bogus"}, "unknown model family 'bogus'"),
    pytest.param({"eviction": "adaptive"}, None,
                 id="change3-eviction 'adaptive'"),
    pytest.param({"bench": "ATAX+Pathfinder", "capacity_split": "0.5/0.5"},
                 None, id="change4-later slice"),
    ({"capacity_split": "0.5/0.5"}, "capacity splits"),
    pytest.param({"backend": "numpy"}, None, id="change6-backend 'numpy'"),
    ({"backend": "bogus"}, "unknown backend 'bogus'"),
    ({"engine": "bogus"}, "unknown engine 'bogus'"),
])
def test_cells_outside_the_slice_raise(change, match):
    """Cells the port refuses raise, naming why (a quota split needs a
    multi-tenant bench, an unknown engine or backend); serve, multi-tenant,
    adaptive and ``backend="numpy"`` cells run, and their rows equal the
    legacy engine and name the backend that ran them (case ids are kept
    stable across releases of the port)."""
    cell = sweep.SweepCell(**{"bench": "ATAX", "prefetcher": "none",
                              "scale": 0.1, "device_frac": 0.5,
                              "eviction": "hotcold", **change})
    if match is not None:
        with pytest.raises(ValueError, match=match):
            sweep.run_sweep([cell], device="cpu")
        return
    (row,) = sweep.run_sweep([cell], device="cpu")
    trace, config, pf, _ = sweep.prepare_cell(cell, device="cpu")
    want = UVMSimulator(config).run(trace, pf,
                                    step_bounds=sweep._step_bounds(trace))
    assert row["backend"] == ("numpy" if cell.backend == "numpy" else "cuda")
    for f in ("hits", "late", "faults", "pages_migrated", "pages_evicted"):
        assert row[f] == getattr(want, f), f
    assert row["cycles"] == pytest.approx(want.cycles, rel=1e-6)
    assert row["pages_evicted"] > 0
    if cell.eviction == "adaptive":
        # the row records the policy the probe chose, the one that replayed
        assert row["eviction"] == config.eviction == adaptive.probed(
            trace, row["device_pages"], "none")[0]
    elif cell.bench.startswith("Serve"):
        assert row["slo_source"] == "kernel"
        assert row["decode_lat_p50_us"] <= row["decode_lat_p99_us"]
    elif cell.capacity_split is not None:
        th, ta = want.tenant_hits, want.tenant_accesses
        assert (row["hit_rate_t0"], row["hit_rate_t1"]) == (
            th[0] / ta[0], th[1] / ta[1])
        assert row["interference_slowdown"] >= 1.0


def test_demand_sweep_writes_rows(tmp_path):
    cells = sweep.expand_grid(["ATAX", "2DCONV"], ["none", "block"],
                              scales=[0.25], device_fracs=[None, 0.5])
    rows = sweep.run_sweep(cells, out_dir=str(tmp_path), device="cpu")
    assert len(rows) == 8
    for cell, row in zip(cells, rows):
        assert (row["bench"], row["prefetcher"], row["device_frac"]) == (
            cell.bench, cell.prefetcher, cell.device_frac)
        assert row["backend"] == "cuda" and row["eviction"] == "lru"
        assert row["hits"] + row["late"] + row["faults"] == row["n_accesses"]
        assert (row["device_pages"] is None) == (cell.device_frac is None)
    # oversubscription evicts; a block prefetcher issues prefetches
    assert all(r["pages_evicted"] > 0 for r in rows if r["device_frac"])
    assert all(r["prefetch_issued"] > 0 for r in rows
               if r["prefetcher"] == "block")
    with open(os.path.join(tmp_path, "results.csv")) as f:
        got = list(csv.DictReader(f))
    assert list(got[0]) == sweep.ROW_FIELDS and len(got) == 8


def test_tree_and_oracle_cells_under_every_policy_equal_legacy():
    cells = sweep.expand_grid(["2DCONV"], ["tree", "oracle"], scales=[0.25],
                              device_fracs=[0.5],
                              evictions=["lru", "random", "hotcold"])
    assert [(c.prefetcher, c.eviction) for c in cells] == [
        (p, e) for p in ("tree", "oracle")
        for e in ("lru", "random", "hotcold")]
    rows = sweep.run_sweep(cells, device="cpu")
    for cell, row in zip(cells, rows):
        assert row["backend"] == "cuda" and row["eviction"] == cell.eviction
        trace, config, pf, _ = sweep.prepare_cell(cell, device="cpu")
        want = UVMSimulator(config).run(trace, pf)
        for f in ("hits", "late", "faults", "prefetch_issued",
                  "prefetch_used", "pages_migrated", "pages_evicted"):
            assert row[f] == getattr(want, f), (cell.prefetcher, f)
        assert row["cycles"] == pytest.approx(want.cycles, rel=1e-6)
        assert row["pages_evicted"] > 0 and row["prefetch_issued"] > 0


def test_prefetcher_and_policy_vocabulary_is_the_reference_one():
    assert sweep.PREFETCHERS == ref_sweep.PREFETCHERS
    assert sweep.EVICTIONS == ("lru", "random", "hotcold")
    trace = sweep.load_trace("ATAX", 0.25, 0, 0.6)
    cell = sweep.SweepCell("ATAX", "oracle", scale=0.25)
    pf = sweep.make_prefetcher(cell, trace, None)
    assert type(pf).__name__ == "OraclePrefetcher"
    # the first-touch stream of the cell's own trace
    assert np.array_equal(np.sort(pf.ft_pages), np.unique(trace.pages))
    assert pf.ft_pages[0] == trace.pages[0] and pf.lookahead == 96


def test_sweep_cli(tmp_path, capsys):
    sweep.main(["--benches", "2DCONV", "--prefetchers", "none",
                "--scales", "0.25", "--device-fracs", "0.5",
                "--device", "cpu", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert "2 cells" in out and "2DCONV,none,0.5000,lru,cuda" in out
    assert os.path.exists(os.path.join(tmp_path, "results.json"))


def test_sweep_cli_evictions(tmp_path, capsys):
    sweep.main(["--benches", "2DCONV", "--prefetchers", "tree",
                "--scales", "0.25", "--device-fracs", "0.5",
                "--evictions", "random,hotcold", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "4 cells" in out
    assert "2DCONV,tree,0.5000,random,cuda" in out
    assert "2DCONV,tree,0.5000,hotcold,cuda" in out
    with pytest.raises(SystemExit):
        sweep.main(["--evictions", "fifo", "--device", "cpu"])


def test_sweep_cli_adaptive_families_and_splits(capsys):
    """``--evictions adaptive`` resolves per cell, ``--model-families``
    crosses the learned cells with the families, ``--capacity-splits``
    gives multi-tenant cells quotas and is refused on single-tenant
    benches, as in the reference's CLI."""
    sweep.main(["--benches", "ATAX", "--prefetchers", "learned",
                "--model-families", "simplified,transformer", "--steps", "2",
                "--scales", "0.25", "--device-fracs", "0.5",
                "--evictions", "adaptive", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "4 cells" in out and ",adaptive," not in out
    sweep.main(["--benches", "ATAX+Pathfinder", "--prefetchers", "none",
                "--scales", "0.1", "--device-fracs", "0.5",
                "--capacity-splits", "shared", "--device", "cpu"])
    assert "2 cells" in capsys.readouterr().out
    for bad in (["--capacity-splits", "0.5/0.5"],
                ["--benches", "ATAX+Pathfinder", "--capacity-splits",
                 "0.7/0.7"],
                ["--model-families", "bogus"]):
        with pytest.raises(SystemExit):
            sweep.main(["--benches", "ATAX", "--device", "cpu", *bad])


def test_predictions_key_has_the_torch_tag(trace):
    svc = PredictorService(steps=5, device="cpu")
    fields = {f: getattr(svc, f) for f in predcache.SERVICE_KEY_FIELDS}
    assert predcache.SERVICE_KEY_FIELDS == ref_predcache.SERVICE_KEY_FIELDS
    key = predcache.predictions_key(trace, **fields)
    assert key != ref_predcache.predictions_key(trace, **fields)
    assert key == predcache.predictions_key(trace, **fields)
    other = dict(fields, model_family="transformer")
    assert predcache.predictions_key(trace, **other) != key


def test_store_load_roundtrip_and_quarantine(tmp_path):
    preds = np.arange(100, dtype=np.int64) - 3
    predcache.store(str(tmp_path), "k1", preds)
    got = predcache.load(str(tmp_path), "k1")
    assert np.array_equal(got, preds) and not got.flags.writeable
    assert predcache.load(str(tmp_path), "missing") is None
    path = os.path.join(tmp_path, "preds_k1.npz")
    with open(path, "r+b") as f:
        f.seek(200)
        f.write(b"\xff" * 16)
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        assert predcache.load(str(tmp_path), "k1") is None
    assert os.path.exists(path + ".corrupt") and not os.path.exists(path)


def test_get_or_train_trains_once(trace, tmp_path):
    predcache.clear_memo()
    kw = dict(steps=3, cache_dir=str(tmp_path), device="cpu")
    timings = {}
    a = predcache.get_or_train(trace, timings=timings, **kw)
    assert timings["train_s"] > 0 and timings["predict_s"] > 0
    assert a.shape == (len(trace),) and a.dtype == np.int64
    again = {}
    assert predcache.get_or_train(trace, timings=again, **kw) is a
    assert again == {}                      # served by the memo
    predcache.clear_memo()
    b = predcache.get_or_train(trace, timings=again, **kw)
    assert again == {} and np.array_equal(a, b)   # served by the disk store
