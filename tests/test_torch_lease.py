"""The port's crash-safe sweep and training lease: the checksummed cell
store, resume, retries and quarantine, the lease worker pool under worker
kills, the checksummed trace cache and its memo, and the prediction
cache's lock protocol (the reference's tests, with ``backend="numpy"`` and
``device="cpu"``); cell keys and cell files agree with the reference's, and
a K1-bound grid resumes without a replay."""
import json
import multiprocessing
import os
import time

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.uvm import faults as ref_faults
from repro.uvm import sweep as ref_sweep
from repro_torch.core.service import PredictorService
from repro_torch.distributed import fault_tolerance as ft
from repro_torch.traces.trace import Trace, make_records
from repro_torch.uvm import faults, predcache, sweep
from repro_torch.uvm.backends import cuda_backend
from repro_torch.uvm.sweep import (SweepCell, expand_grid, load_cell_row,
                                   load_trace, read_results,
                                   read_results_csv, run_sweep,
                                   write_cell_row, write_results)

BENCHES = ["ATAX", "Pathfinder"]
PREFETCHERS = ["none", "tree"]
LEARNED_STEPS = 20


def _small_cells(**kw):
    kw.setdefault("backend", "numpy")
    return expand_grid(BENCHES, PREFETCHERS, scales=[0.25], **kw)


def _strip_volatile(rows):
    return [{k: v for k, v in r.items()
             if k not in faults.VOLATILE_ROW_FIELDS} for r in rows]


@pytest.fixture
def plan_env(monkeypatch):
    def _set(plan):
        monkeypatch.setenv(faults.FAULT_PLAN_ENV, plan.to_json())
        faults.reset()
    yield _set
    monkeypatch.delenv(faults.FAULT_PLAN_ENV, raising=False)
    faults.reset()


# ---------------------------------------------------------------------------
# the cell store and resume
# ---------------------------------------------------------------------------

def test_resume_from_partial_results(tmp_path):
    out = str(tmp_path / "out")
    cells = _small_cells()
    full = run_sweep(cells, out_dir=out, device="cpu")
    cell_dir = os.path.join(out, "cells")
    kept = 0
    for i, cell in enumerate(cells):
        path = os.path.join(cell_dir, f"{cell.key()}.json")
        if i % 2 == 0:
            os.remove(path)
        else:
            row, reason = load_cell_row(path)
            assert reason == "ok"
            row["seconds"] = 12345.0
            write_cell_row(path, row)     # checksum must cover the poke
            kept += 1
    assert kept > 0
    resumed = run_sweep(cells, out_dir=out, device="cpu")
    assert _strip_volatile(resumed) == _strip_volatile(full)
    assert len([r for r in resumed if r["seconds"] == 12345.0]) == kept
    fresh = run_sweep(cells, out_dir=out, device="cpu", resume=False)
    assert not any(r["seconds"] == 12345.0 for r in fresh)


def test_results_json_csv_roundtrip(tmp_path):
    out = str(tmp_path / "out")
    cells = _small_cells(device_fracs=[None, 0.75])
    rows = run_sweep(cells, out_dir=out, device="cpu")
    back = read_results(out)
    assert _strip_volatile(back) == _strip_volatile(rows)
    csv_rows = read_results_csv(os.path.join(out, "results.csv"))
    assert len(csv_rows) == len(rows)
    for got, want in zip(csv_rows, rows):
        for k in ("bench", "prefetcher", "n_accesses", "faults",
                  "device_frac", "backend", "quarantined"):
            assert got[k] == want[k], k
        assert got["hit_rate"] == pytest.approx(want["hit_rate"], rel=1e-9)
        assert got["cycles"] == pytest.approx(want["cycles"], rel=1e-9)
    write_results(back, out)
    assert _strip_volatile(read_results(out)) == _strip_volatile(rows)


def test_learned_resume_needs_no_training(tmp_path, monkeypatch):
    """Resuming a finished learned grid reads its cell files: no cell is
    simulated again, so nothing trains."""
    predcache.clear_memo()
    out = str(tmp_path / "out")
    cells = expand_grid(["ATAX"], ["learned"], scales=[0.25],
                        prediction_us=[1.0, 2.0], backend="numpy",
                        service_steps=LEARNED_STEPS)
    first = run_sweep(cells, out_dir=out, device="cpu")
    assert sum("fit_top1" in r for r in first) == 1    # one fit, one trace

    def _boom(*a, **k):
        raise AssertionError("resume must not re-simulate any cell")

    monkeypatch.setattr(sweep, "simulate_cell", _boom)
    monkeypatch.setattr(sweep, "_run_cells", _boom)
    predcache.clear_memo()
    resumed = run_sweep(cells, out_dir=out, device="cpu")
    assert resumed == first
    predcache.clear_memo()


def test_cell_row_envelope_rejects_corruption_and_versions(tmp_path):
    path = str(tmp_path / "cell.json")
    row = {"bench": "ATAX", "hit_rate": 0.5}
    write_cell_row(path, row)
    assert load_cell_row(path) == (row, "ok")
    with open(path) as f:
        text = f.read()
    with open(path, "w") as f:
        f.write(text.replace("0.5", "0.9"))
    assert load_cell_row(path) == (None, "corrupt")
    write_cell_row(path, row)
    with open(path, "r+") as f:
        f.truncate(os.path.getsize(path) // 2)
    assert load_cell_row(path) == (None, "corrupt")
    write_cell_row(path, row)
    with open(path) as f:
        doc = json.load(f)
    doc["_v"] = 99
    with open(path, "w") as f:
        json.dump(doc, f)
    assert load_cell_row(path) == (None, "version")
    with open(path, "w") as f:
        json.dump(row, f)                  # a flat row, no envelope
    assert load_cell_row(path) == (None, "version")
    assert load_cell_row(str(tmp_path / "nope.json")) == (None, "missing")


def test_resume_requeues_invalid_cell_files(tmp_path):
    out = str(tmp_path / "out")
    cells = _small_cells()
    full = run_sweep(cells, out_dir=out, device="cpu")
    paths = [os.path.join(out, "cells", f"{c.key()}.json") for c in cells]
    with open(paths[0], "r+") as f:        # torn write
        f.truncate(os.path.getsize(paths[0]) // 2)
    with open(paths[1], "w") as f:         # garbage bytes
        f.write("not json{{{")
    with open(paths[2], "w") as f:         # a flat row, no envelope
        json.dump(full[2], f)
    with pytest.warns(RuntimeWarning, match="quarantining"):
        resumed = run_sweep(cells, out_dir=out, device="cpu")
    assert _strip_volatile(resumed) == _strip_volatile(full)
    for p in paths[:3]:
        assert os.path.exists(p + ".corrupt")
        assert load_cell_row(p)[1] == "ok"


def test_worker_sigkill_mid_cell_and_mid_write_converges(tmp_path,
                                                         plan_env):
    """One spawned lease worker is SIGKILLed mid-cell and another mid
    cell-file write: the pool restarts them, reclaims the dead pids'
    leases, and the grid equals a fault-free run."""
    cells = _small_cells()
    base = run_sweep(cells, out_dir=str(tmp_path / "base"), device="cpu")
    plan_env(faults.FaultPlan(
        seed=3, ledger_dir=str(tmp_path / "ledger"), specs=(
            faults.FaultSpec("cell.start", "kill", prob=1.0, max_count=1,
                             match=cells[1].key()),
            faults.FaultSpec("cell.result.write", "kill", prob=1.0,
                             max_count=1, match=cells[2].key()),
        )))
    assert sweep._mp_context().get_start_method() == "spawn"
    rows = run_sweep(cells, out_dir=str(tmp_path / "chaos"), device="cpu",
                     workers=2)
    assert _strip_volatile(rows) == _strip_volatile(base)
    assert all(r["quarantined"] is False for r in rows)
    assert all(isinstance(r["retries"], int) for r in rows)
    assert rows[1]["retries"] >= 1
    assert rows[2]["retries"] >= 1
    assert len(os.listdir(str(tmp_path / "ledger"))) == 2
    assert faults.rows_digest(rows) == faults.rows_digest(base)


def test_unrecoverable_cell_quarantines_instead_of_aborting(tmp_path,
                                                            plan_env,
                                                            monkeypatch):
    cells = _small_cells()
    victim = cells[0].key()
    plan_env(faults.FaultPlan(seed=0, specs=(
        faults.FaultSpec("cell.start", "raise", prob=1.0, max_count=None,
                         match=victim),)))
    out = str(tmp_path / "out")
    with pytest.warns(RuntimeWarning, match="quarantined"):
        rows = run_sweep(cells, out_dir=out, device="cpu", max_attempts=2)
    assert rows[0]["quarantined"] is True
    assert rows[0]["hit_rate"] is None and rows[0]["ipc"] is None
    assert rows[0]["retries"] == 1            # 2 attempts = 1 retry
    assert rows[0]["bench"] == cells[0].bench
    assert all(r["quarantined"] is False for r in rows[1:])
    assert all(r["hit_rate"] is not None for r in rows[1:])
    with open(os.path.join(out, "quarantine.json")) as f:
        manifest = json.load(f)
    assert len(manifest["cells"]) == 1
    assert manifest["cells"][0]["key"] == victim
    assert manifest["cells"][0]["errors"]
    resumed = run_sweep(cells, out_dir=out, device="cpu", max_attempts=2)
    assert _strip_volatile(resumed) == _strip_volatile(rows)
    csv_rows = read_results_csv(os.path.join(out, "results.csv"))
    assert csv_rows[0]["quarantined"] is True
    assert csv_rows[1]["quarantined"] is False
    assert csv_rows[0]["hit_rate"] is None
    monkeypatch.delenv(faults.FAULT_PLAN_ENV)
    faults.reset()
    fresh = run_sweep(cells, out_dir=out, device="cpu", resume=False)
    assert all(r["quarantined"] is False for r in fresh)
    assert fresh[0]["hit_rate"] is not None


def test_aggregate_results_rebuild_from_cell_store(tmp_path):
    out = str(tmp_path / "out")
    cells = _small_cells()
    rows = run_sweep(cells, out_dir=out, device="cpu")
    agg = os.path.join(out, "results.json")
    with open(agg, "r+") as f:
        f.truncate(os.path.getsize(agg) // 3)
    with pytest.warns(RuntimeWarning, match="rebuilding"):
        back = read_results(out)

    def key(r):
        return r["bench"], r["prefetcher"], str(r["device_frac"])

    assert sorted(map(key, back)) == sorted(map(key, rows))
    assert {json.dumps(r, sort_keys=True) for r in back} \
        == {json.dumps(r, sort_keys=True) for r in rows}


# ---------------------------------------------------------------------------
# the trace cache: checksum once per process, cold reads quarantine
# ---------------------------------------------------------------------------

def _trace_cache_file(cache):
    names = [f for f in os.listdir(cache)
             if f.startswith("trace_") and not f.endswith(".corrupt")]
    assert len(names) == 1, names
    return os.path.join(cache, names[0])


def _clobber_middle(path):
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        f.write(b"\xde\xad\xbe\xef" * 16)


def test_trace_memo_checksums_once_per_path(tmp_path):
    cache = str(tmp_path / "cache")
    t1 = load_trace("ATAX", 0.25, 0, 0.6, cache_dir=cache)
    path = _trace_cache_file(cache)
    sweep._trace_memo.clear()
    t2 = load_trace("ATAX", 0.25, 0, 0.6, cache_dir=cache)  # disk, verified
    np.testing.assert_array_equal(t1.accesses, t2.accesses)
    assert t2.array_pages == t1.array_pages
    _clobber_middle(path)
    t3 = load_trace("ATAX", 0.25, 0, 0.6, cache_dir=cache)
    assert t3 is t2                      # memo hit: no re-read, no re-hash
    assert not os.path.exists(path + ".corrupt")
    sweep._trace_memo.clear()            # as in a fresh process
    with pytest.warns(RuntimeWarning, match="quarantining"):
        t4 = load_trace("ATAX", 0.25, 0, 0.6, cache_dir=cache)
    assert os.path.exists(path + ".corrupt")
    np.testing.assert_array_equal(t4.accesses, t1.accesses)


def test_trace_memo_disabled_rereads_disk(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TRACE_MEMO", "0")
    sweep._trace_memo.clear()
    cache = str(tmp_path / "cache")
    t1 = load_trace("ATAX", 0.25, 0, 0.6, cache_dir=cache)
    path = _trace_cache_file(cache)
    _clobber_middle(path)
    with pytest.warns(RuntimeWarning, match="quarantining"):
        t2 = load_trace("ATAX", 0.25, 0, 0.6, cache_dir=cache)
    np.testing.assert_array_equal(t2.accesses, t1.accesses)


# ---------------------------------------------------------------------------
# the prediction cache's lock protocol
# ---------------------------------------------------------------------------

def _mk_trace(pages):
    pages = np.asarray(pages, dtype=np.int64)
    recs = make_records(len(pages))
    recs["page"] = pages
    recs["sm"] = np.arange(len(pages)) % 4
    return Trace("synth", recs, {}, {}, len(pages) * 100)


def _key(trace, steps=5):
    svc = PredictorService(steps=steps, device="cpu")
    return predcache.predictions_key(
        trace, **{f: getattr(svc, f) for f in predcache.SERVICE_KEY_FIELDS})


def _fake_training(monkeypatch, trace, fill):
    monkeypatch.setattr(PredictorService, "fit", lambda self, *a, **k: None)
    monkeypatch.setattr(PredictorService, "predict_trace",
                        lambda self: np.full(len(trace), fill,
                                             dtype=np.int64))


def _writer(cache_dir, key, fill, n_writes):
    arr = np.full(4096, fill, dtype=np.int64)
    for _ in range(n_writes):
        predcache.store(cache_dir, key, arr)


def test_concurrent_writers_never_corrupt(tmp_path):
    cache = str(tmp_path)
    key = "c0ffee" * 4
    ctx = multiprocessing.get_context("spawn")
    fills = [1, 2, 3, 4]
    procs = [ctx.Process(target=_writer, args=(cache, key, f, 40))
             for f in fills]
    for p in procs:
        p.start()
    seen = 0
    try:
        while any(p.is_alive() for p in procs):
            arr = predcache.load(cache, key)
            if arr is not None:
                assert arr.shape == (4096,)
                uniq = np.unique(arr)
                assert uniq.size == 1 and int(uniq[0]) in fills
                seen += 1
    finally:
        for p in procs:
            p.join(timeout=60)
    assert all(p.exitcode == 0 for p in procs)
    arr = predcache.load(cache, key)
    assert arr is not None and np.unique(arr).size == 1
    assert seen > 0
    assert not [f for f in os.listdir(cache) if f.endswith(".tmp.npz")]


def test_get_or_train_respects_disable_env(tmp_path, monkeypatch):
    predcache.clear_memo()
    cache = str(tmp_path)
    tr = _mk_trace(np.arange(200) % 31)
    predcache.store(cache, _key(tr), np.zeros(len(tr), dtype=np.int64))
    monkeypatch.setenv("REPRO_PREDCACHE", "0")
    calls = []
    _fake_training(monkeypatch, tr, 1)
    monkeypatch.setattr(PredictorService, "fit",
                        lambda self, *a, **k: calls.append(1))
    got = predcache.get_or_train(tr, steps=5, cache_dir=cache, device="cpu")
    assert calls == [1]
    assert int(got[0]) == 1              # trained, not the cached zeros
    assert not predcache.enabled()


def test_stale_lock_does_not_deadlock(tmp_path, monkeypatch):
    predcache.clear_memo()
    cache = str(tmp_path)
    tr = _mk_trace(np.arange(150) % 17)
    with open(os.path.join(cache, f"preds_{_key(tr)}.npz.lock"), "w") as f:
        f.write("99999")                 # a bare-pid lock, no result
    _fake_training(monkeypatch, tr, 7)
    got = predcache.get_or_train(tr, steps=5, cache_dir=cache, device="cpu",
                                 lock_poll_s=0.01, lock_patience_s=0.05)
    assert int(got[0]) == 7
    predcache.clear_memo()


def test_dead_pid_lock_reclaimed_before_patience(tmp_path, monkeypatch):
    predcache.clear_memo()
    cache = str(tmp_path)
    tr = _mk_trace(np.arange(150) % 19)
    doc = ft.lease_doc()
    doc["pid"] = 2 ** 22 + 11            # beyond any default pid_max
    assert not ft.pid_alive(doc["pid"])
    with open(os.path.join(cache, f"preds_{_key(tr)}.npz.lock"), "w") as f:
        json.dump(doc, f)                # fresh ts: TTL alone won't expire
    _fake_training(monkeypatch, tr, 9)
    t0 = time.monotonic()
    got = predcache.get_or_train(tr, steps=5, cache_dir=cache, device="cpu",
                                 lock_poll_s=0.25, lock_patience_s=120.0)
    assert int(got[0]) == 9
    assert time.monotonic() - t0 < 30.0
    predcache.clear_memo()


def test_corrupt_entry_quarantined_and_retrained(tmp_path):
    cache = str(tmp_path)
    preds = np.arange(5000, dtype=np.int64)
    key_t = "feed" * 6
    path_t = predcache._path(cache, key_t)
    predcache.store(cache, key_t, preds)
    with open(path_t, "r+b") as f:
        f.truncate(os.path.getsize(path_t) // 2)
    with pytest.warns(RuntimeWarning, match="quarantining"):
        assert predcache.load_checked(cache, key_t) == (None, True)
    assert os.path.exists(path_t + ".corrupt")
    assert not os.path.exists(path_t)
    key_b = "beef" * 6
    path_b = predcache._path(cache, key_b)
    predcache.store(cache, key_b, preds)
    size = os.path.getsize(path_b)
    with open(path_b, "r+b") as f:
        f.seek(size // 2)
        b = f.read(1)
        f.seek(size // 2)
        f.write(bytes([b[0] ^ 0x10]))
    with pytest.warns(RuntimeWarning, match="quarantining"):
        assert predcache.load(cache, key_b) is None
    assert os.path.exists(path_b + ".corrupt")
    predcache.store(cache, key_t, preds)
    np.testing.assert_array_equal(predcache.load(cache, key_t), preds)
    assert predcache.load_checked(cache, "0" * 24) == (None, False)


def test_corrupt_holder_stolen_without_burning_patience(tmp_path,
                                                        monkeypatch):
    """A lock holder that stored a corrupt entry (the ``pred.artifact``
    site) under a live-looking foreign lease: the waiter quarantines the
    entry, steals the lease and retrains at once."""
    predcache.clear_memo()
    cache = str(tmp_path / "cache")
    ledger = str(tmp_path / "ledger")
    tr = _mk_trace(np.arange(150) % 13)
    key = _key(tr)
    path = predcache._path(cache, key)
    plan = {"seed": 0, "ledger_dir": ledger, "specs": [
        {"site": "pred.artifact", "kind": "truncate", "prob": 1.0,
         "max_count": 1}]}
    monkeypatch.setenv(faults.FAULT_PLAN_ENV, json.dumps(plan))
    faults.reset()
    try:
        predcache.store(cache, key, np.zeros(len(tr), dtype=np.int64))
    finally:
        monkeypatch.delenv(faults.FAULT_PLAN_ENV)
        faults.reset()
    assert os.listdir(ledger)            # the corruption really fired
    with open(path + ".lock", "w") as f:
        json.dump({"pid": 1, "host": "definitely-not-this-host",
                   "ts": time.time(), "role": "predcache-train"}, f)
    _fake_training(monkeypatch, tr, 5)
    t0 = time.monotonic()
    with pytest.warns(RuntimeWarning, match="quarantining"):
        got = predcache.get_or_train(tr, steps=5, cache_dir=cache,
                                     device="cpu", lock_poll_s=0.25,
                                     lock_patience_s=60.0)
    assert int(got[0]) == 5
    assert time.monotonic() - t0 < 15.0
    assert os.path.exists(path + ".corrupt")
    np.testing.assert_array_equal(predcache.load(cache, key), got)
    predcache.clear_memo()


# ---------------------------------------------------------------------------
# parity with the reference, and resume on K1
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fields", [
    dict(bench="ATAX", prefetcher="none"),
    dict(bench="Pathfinder", prefetcher="tree", scale=0.25, device_frac=0.5,
         eviction="hotcold", scenario="chaos-smoke"),
    dict(bench="ATAX+Pathfinder", prefetcher="learned", device_frac=0.75,
         capacity_split="0.4/0.4", model_family="transformer",
         prediction_us=2.0, service_steps=40, window=None),
], ids=["defaults", "scenario", "mt-learned"])
@pytest.mark.parametrize("backend", ["numpy", "auto"])
def test_cell_key_equals_the_reference(fields, backend):
    cell = SweepCell(**fields, backend=backend)
    assert cell.key() == ref_sweep.SweepCell(**fields,
                                             backend=backend).key()
    assert sweep._cell_path("o", cell) == ref_sweep._cell_path(
        "o", ref_sweep.SweepCell(**fields, backend=backend))


def test_cell_files_load_across_packages(tmp_path):
    cell = _small_cells()[3]
    row = sweep.simulate_cell(cell, device="cpu")
    mine, theirs = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    write_cell_row(mine, row)
    ref_sweep.write_cell_row(theirs, row)
    with open(mine) as f, open(theirs) as g:
        assert f.read() == g.read()
    assert ref_sweep.load_cell_row(mine) == (row, "ok")
    assert load_cell_row(theirs) == (row, "ok")
    assert faults.rows_digest([row]) == faults.rows_digest(
        [load_cell_row(theirs)[0]])


def test_k1_grid_resumes_without_a_replay(tmp_path, monkeypatch):
    """A K1-bound grid (demand, learned and multi-tenant lanes, an adaptive
    cell): the first run replays every row as K1 lanes (the plain version
    on the CPU) and persists them; the resumed run loads every row, equal
    under the digest, with no call of K1's wrapper and no fit."""
    calls = []
    wrapped = cuda_backend.lane_replay

    def counting(*a, **k):
        calls.append(1)
        return wrapped(*a, **k)

    monkeypatch.setattr(cuda_backend, "lane_replay", counting)
    cells = expand_grid(["ATAX"], ["none", "learned"], scales=[0.25],
                        device_fracs=[0.5], service_steps=LEARNED_STEPS)
    cells += expand_grid(["ATAX+Pathfinder"], ["block"], scales=[0.25],
                         device_fracs=[0.5], capacity_splits=["0.5/0.5"])
    cells += [SweepCell("Pathfinder", "none", scale=0.25, device_frac=0.5,
                        eviction="adaptive")]
    predcache.clear_memo()
    out = str(tmp_path / "out")
    first = run_sweep(cells, out_dir=out, device="cpu")
    assert calls and all(r["backend"] == "cuda" for r in first)
    assert len(os.listdir(os.path.join(out, "cells"))) == len(cells)
    calls.clear()
    fits = []
    monkeypatch.setattr(PredictorService, "fit",
                        lambda self, *a, **k: fits.append(1))
    predcache.clear_memo()
    resumed = run_sweep(cells, out_dir=out, device="cpu")
    assert calls == [] and fits == []
    assert faults.rows_digest(resumed) == faults.rows_digest(first)
    assert faults.rows_digest(resumed) == ref_faults.rows_digest(
        _strip_volatile(first))
    predcache.clear_memo()


def test_declined_cells_run_leased_with_their_timelines(tmp_path):
    """Cells whose chain starts at K1 but which K1 declines (here: they
    record per-transfer timelines) leave the lane stage for the leased
    path and replay on the NumPy engine; their timelines survive the cell
    store's JSON round trip, and the rows equal a run without ``out_dir``."""
    cells = expand_grid(["ATAX"], ["none", "tree"], scales=[0.25],
                        device_fracs=[0.5])
    out = str(tmp_path / "out")
    rows = run_sweep(cells, out_dir=out, device="cpu", record_timeline=True)
    assert [r["backend"] for r in rows] == ["numpy", "numpy"]
    assert all(r["timeline"] and isinstance(r["timeline"][0], list)
               for r in rows)
    for cell in cells:
        assert os.path.exists(sweep._cell_path(out, cell) + ".attempts")
    assert run_sweep(cells, out_dir=out, device="cpu",
                     record_timeline=True) == rows
    plain = run_sweep(cells, device="cpu", record_timeline=True)
    assert faults.rows_digest(plain) == faults.rows_digest(rows)


def test_launch_log_sums_every_process_of_a_leased_pool(tmp_path,
                                                        monkeypatch):
    """With ``REPRO_LAUNCH_LOG`` set, the sweep driver and each spawned lease
    worker keep their launch counts in ``<dir>/<pid>.json``, and
    ``read_launch_log`` sums them: here the driver's counts as set below,
    plus the workers', which are 0 (CPU tensors launch nothing)."""
    from repro_torch import kernels
    from repro_torch.kernels.hlsh_attention import hlsh_attention
    from repro_torch.kernels.lane_replay import lane_replay
    log_dir = str(tmp_path / "launches")
    monkeypatch.setenv(kernels.LAUNCH_LOG_ENV, log_dir)
    monkeypatch.setattr(lane_replay, "launches", 3)
    monkeypatch.setattr(hlsh_attention, "launches", 2)
    cells = expand_grid(BENCHES, ["none"], scales=[0.25], backend="numpy")
    rows = run_sweep(cells, out_dir=str(tmp_path / "out"), device="cpu",
                     workers=2)
    assert [r["backend"] for r in rows] == ["numpy", "numpy"]
    logged = sorted(int(f[:-len(".json")]) for f in os.listdir(log_dir))
    assert os.getpid() in logged and len(logged) >= 2
    assert kernels.read_launch_log(log_dir) == {
        "lane_replay": 3, "hlsh_attention": 2, "int4_matmul": 0,
        "flash_attention": 0}
    monkeypatch.delenv(kernels.LAUNCH_LOG_ENV)
    kernels.log_launches()                       # unset: writes nothing
    assert len(os.listdir(log_dir)) == len(logged)
