"""The port's fault-injection plane (``repro_torch.uvm.faults``): the
reference's plane tests on the port's module, parity with the reference
(draws, plan JSON, digests, the default plan and its attempt budget), an
injected ``backend.replay`` raise on K1 (its plain version here), and the
chaos convergence harness end to end through the port's CLI, held against
the reference's rows."""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.uvm import faults as ref_faults
from repro.uvm import sweep as ref_sweep
from repro_torch.uvm import faults, sweep
from repro_torch.uvm.backends import cuda_backend
from repro_torch.uvm.faults import (FaultPlan, FaultSpec, InjectedFault,
                                    attempt_budget, rows_digest)
from repro_torch.uvm.replay_core import TransientBackendFault

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")

#: the port's columns the convergence digest leaves aside
PORT_ONLY = ("train_seconds", "predict_seconds", "fit_top1", "fit_f1",
             "fit_coverage")


def _plan(tmp_path, *specs, seed=0):
    return FaultPlan(seed=seed, ledger_dir=str(tmp_path / "ledger"),
                     specs=tuple(specs)).validate()


@pytest.fixture
def plan_env(monkeypatch):
    """Set ``REPRO_FAULT_PLAN`` for one test and drop it after."""
    def _set(plan):
        monkeypatch.setenv(faults.FAULT_PLAN_ENV, plan.to_json())
        faults.reset()
    yield _set
    monkeypatch.delenv(faults.FAULT_PLAN_ENV, raising=False)
    faults.reset()


# ---------------------------------------------------------------------------
# the reference's plane tests, on the port's module
# ---------------------------------------------------------------------------

def test_spec_and_plan_validation(tmp_path):
    with pytest.raises(ValueError, match="unknown fault site"):
        FaultSpec("nope.site", "kill").validate()
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultSpec("cell.start", "explode").validate()
    with pytest.raises(ValueError, match="prob"):
        FaultSpec("cell.start", "kill", prob=1.5).validate()
    with pytest.raises(ValueError, match="max_count"):
        FaultSpec("cell.start", "kill", max_count=0).validate()
    with pytest.raises(ValueError, match="fraction"):
        FaultSpec("cell.result.artifact", "truncate",
                  fraction=1.0).validate()
    with pytest.raises(ValueError, match="ledger_dir"):
        FaultPlan(seed=0, specs=(
            FaultSpec("cell.start", "kill", max_count=1),)).validate()
    plan = _plan(tmp_path, FaultSpec("cell.start", "raise", prob=0.5))
    assert faults.plan_from_dict(json.loads(plan.to_json())) == plan


def test_active_injector_follows_env(tmp_path, monkeypatch):
    faults.reset()
    monkeypatch.delenv(faults.FAULT_PLAN_ENV, raising=False)
    assert faults.active() is None
    plan = _plan(tmp_path, FaultSpec("cell.start", "delay", delay_s=0.0))
    monkeypatch.setenv(faults.FAULT_PLAN_ENV, plan.to_json())
    inj = faults.active()
    assert inj is not None and inj.plan == plan
    assert faults.active() is inj        # cached while the env is stable
    monkeypatch.delenv(faults.FAULT_PLAN_ENV)
    assert faults.active() is None
    faults.reset()


def _fired(inj, keys):
    hits = set()
    for key in keys:
        try:
            inj.fire("cell.start", key)
        except InjectedFault:
            hits.add(key)
    return hits


def test_draws_are_deterministic_and_seed_sensitive():
    spec = FaultSpec("cell.start", "raise", prob=0.5, max_count=None)
    keys = [f"cell{i}" for i in range(64)]
    fired = {}
    for seed in (0, 1):
        fired[seed] = _fired(
            faults.FaultInjector(FaultPlan(seed=seed, specs=(spec,))), keys)
        assert _fired(faults.FaultInjector(
            FaultPlan(seed=seed, specs=(spec,))), keys) == fired[seed]
    assert 8 < len(fired[0]) < 56
    assert fired[0] != fired[1]


def test_ledger_bounds_firing_across_injectors(tmp_path):
    plan = _plan(tmp_path,
                 FaultSpec("cell.start", "raise", prob=1.0, max_count=2))
    n = 0
    for _ in range(5):
        try:
            faults.FaultInjector(plan).fire("cell.start", "victim")
        except InjectedFault:
            n += 1
    assert n == 2                        # the on-disk ledger is shared
    with pytest.raises(InjectedFault):
        faults.FaultInjector(plan).fire("cell.start", "other")


def test_match_narrows_and_delay_sleeps(tmp_path):
    plan = _plan(tmp_path,
                 FaultSpec("cell.start", "raise", prob=1.0, max_count=None,
                           match="abc"),
                 FaultSpec("worker.loop", "delay", prob=1.0,
                           max_count=None, delay_s=0.05))
    inj = faults.FaultInjector(plan)
    inj.fire("cell.start", "zzz")
    with pytest.raises(InjectedFault):
        inj.fire("cell.start", "xxabcxx")
    t0 = time.monotonic()
    inj.fire("worker.loop", "w0")
    assert time.monotonic() - t0 >= 0.05


def test_corrupt_truncates_and_flips_bits(tmp_path):
    data = bytes(range(256)) * 8
    plan = _plan(tmp_path,
                 FaultSpec("cell.result.artifact", "truncate", prob=1.0,
                           max_count=1, fraction=0.25),
                 FaultSpec("trace.artifact", "bitflip", prob=1.0,
                           max_count=1))
    inj = faults.FaultInjector(plan)
    p1 = str(tmp_path / "a.bin")
    with open(p1, "wb") as f:
        f.write(data)
    inj.corrupt("cell.result.artifact", p1, "k1")
    assert os.path.getsize(p1) == len(data) // 4
    inj.corrupt("cell.result.artifact", p1, "k1")   # budget spent
    assert os.path.getsize(p1) == len(data) // 4
    p2 = str(tmp_path / "b.bin")
    with open(p2, "wb") as f:
        f.write(data)
    inj.corrupt("trace.artifact", p2, "k2")
    with open(p2, "rb") as f:
        got = f.read()
    assert len(got) == len(data)
    diff = [i for i in range(len(data)) if got[i] != data[i]]
    assert len(diff) == 1
    assert bin(got[diff[0]] ^ data[diff[0]]).count("1") == 1


def test_injected_backend_fault_is_transient(tmp_path, plan_env):
    plan_env(_plan(tmp_path, FaultSpec("backend.replay", "raise", prob=1.0,
                                       max_count=1)))
    with pytest.raises(TransientBackendFault) as exc:
        faults.fire("backend.replay", "8:ATAX")
    assert isinstance(exc.value, InjectedFault)
    faults.fire("backend.replay", "8:ATAX")          # ledger spent: clean


def test_dispatch_reraises_k1_faults_instead_of_degrading(monkeypatch):
    """Neither a transient nor any other K1 failure is served by the NumPy
    engine (that would change the row's backend column); a NumPy engine
    failure reaches the caller too."""
    from repro_torch.uvm.backends.numpy_backend import NumpyReplayBackend
    from repro_torch.uvm.replay_core import ReplayRequest, dispatch

    trace, config, pf, _ = sweep.prepare_cell(
        sweep.SweepCell("ATAX", "none", scale=0.25), device="cpu")
    req = ReplayRequest(trace, pf, config)

    def _transient(self, requests):
        raise TransientBackendFault("device preempted")

    def _hard(self, requests):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(cuda_backend.CudaReplayBackend, "replay", _transient)
    with pytest.raises(TransientBackendFault):
        dispatch(req, "cuda", device="cpu")
    monkeypatch.setattr(cuda_backend.CudaReplayBackend, "replay", _hard)
    with pytest.raises(RuntimeError, match="launch failed"):
        dispatch(req, "cuda", device="cpu")
    monkeypatch.setattr(NumpyReplayBackend, "replay", _hard)
    with pytest.raises(RuntimeError, match="launch failed"):
        dispatch(req, "numpy", device="cpu")


def test_rows_digest_ignores_only_volatile_columns():
    base = [{"bench": "ATAX", "hit_rate": 0.5, "seconds": 1.0,
             "retries": 0, "backend": "cuda", "quarantined": False,
             "train_seconds": 1.5, "predict_seconds": 0.1,
             "fit_top1": 0.4, "fit_f1": 0.3, "fit_coverage": 0.9}]
    same = [dict(base[0], seconds=9.0, retries=3, train_seconds=0.0,
                 predict_seconds=0.0)]
    for col in ("fit_top1", "fit_f1", "fit_coverage"):
        del same[0][col]
    assert rows_digest(base) == rows_digest(same)
    for col, val in (("hit_rate", 0.6), ("backend", "numpy"),
                     ("quarantined", True)):
        assert rows_digest([dict(base[0], **{col: val})]) \
            != rows_digest(base)


def test_attempt_budget_covers_worst_case_sabotage(tmp_path):
    plan = _plan(tmp_path,
                 FaultSpec("cell.start", "kill", max_count=2),
                 FaultSpec("cell.result.write", "kill", max_count=1),
                 FaultSpec("cell.result.artifact", "bitflip", max_count=3),
                 FaultSpec("backend.replay", "raise", max_count=1),
                 FaultSpec("worker.loop", "kill", max_count=5),
                 FaultSpec("cell.start", "delay", max_count=7))
    assert attempt_budget(plan, margin=2) == 9


# ---------------------------------------------------------------------------
# parity with the reference
# ---------------------------------------------------------------------------

def test_draws_equal_the_reference():
    rng = np.random.default_rng(0)
    for _ in range(200):
        seed, index = int(rng.integers(0, 1000)), int(rng.integers(0, 12))
        site = faults.SITES[int(rng.integers(0, len(faults.SITES)))]
        key = f"{int(rng.integers(0, 1 << 40)):x}"
        assert faults._draw(seed, index, site, key) \
            == ref_faults._draw(seed, index, site, key)
    assert faults.SITES == ref_faults.SITES
    assert faults.KINDS == ref_faults.KINDS
    assert faults.FAULT_PLAN_ENV == ref_faults.FAULT_PLAN_ENV


def test_plan_json_round_trips_between_packages(tmp_path):
    plan = faults.default_chaos_plan(str(tmp_path / "ledger"), seed=7)
    ref = ref_faults.load_plan(plan.to_json())
    assert ref.to_dict() == plan.to_dict()
    assert faults.load_plan(ref.to_json()) == plan
    path = tmp_path / "plan.json"
    path.write_text(ref.to_json())
    assert faults.load_plan(str(path)) == plan


def test_rows_digest_equals_the_reference():
    rows = [{"bench": "ATAX", "prefetcher": "tree", "hit_rate": 0.25,
             "cycles": 123456.5, "backend": "numpy", "quarantined": False,
             "seconds": 0.5, "retries": 1, "timeline": [[1, 2], [3, 4]]},
            {"bench": "BICG", "prefetcher": "none", "hit_rate": None,
             "backend": "cuda", "quarantined": True, "seconds": None,
             "retries": 3}]
    assert rows_digest(rows) == ref_faults.rows_digest(rows)
    assert set(ref_faults.VOLATILE_ROW_FIELDS) \
        <= set(faults.VOLATILE_ROW_FIELDS)
    assert set(faults.VOLATILE_ROW_FIELDS) \
        - set(ref_faults.VOLATILE_ROW_FIELDS) == set(PORT_ONLY)
    with_fit = [dict(rows[0], train_seconds=2.0, fit_top1=0.5), rows[1]]
    assert rows_digest(with_fit) == ref_faults.rows_digest(rows)


def test_default_plan_and_attempt_budget_equal_the_reference(tmp_path):
    ledger = str(tmp_path / "ledger")
    for seed in (0, 3):
        plan = faults.default_chaos_plan(ledger, seed=seed)
        ref = ref_faults.default_chaos_plan(ledger, seed=seed)
        assert plan.to_dict() == ref.to_dict()
        assert attempt_budget(plan) == ref_faults.attempt_budget(ref)


# ---------------------------------------------------------------------------
# an injected raise inside K1's backend
# ---------------------------------------------------------------------------

def test_backend_replay_raise_propagates_from_k1(tmp_path, plan_env):
    """``backend.replay`` fires inside ``CudaReplayBackend.replay`` (K1's
    plain version on CPU tensors): the raise is a TransientBackendFault,
    it leaves ``run_sweep`` with no row persisted, and the rerun records
    every row on ``cuda``, never on another backend."""
    cells = sweep.expand_grid(["ATAX"], ["none", "block"], scales=[0.25],
                              device_fracs=[0.5])
    plan_env(_plan(tmp_path, FaultSpec("backend.replay", "raise", prob=1.0,
                                       max_count=1)))
    out = str(tmp_path / "out")
    with pytest.raises(TransientBackendFault):
        sweep.run_sweep(cells, out_dir=out, device="cpu")
    assert not os.path.isdir(os.path.join(out, "cells"))
    rows = sweep.run_sweep(cells, out_dir=out, device="cpu")
    assert [r["backend"] for r in rows] == ["cuda", "cuda"]
    assert len(os.listdir(str(tmp_path / "ledger"))) == 1


# ---------------------------------------------------------------------------
# the chaos harness through the port's CLI
# ---------------------------------------------------------------------------

def _chaos_cli(out, *args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop(faults.FAULT_PLAN_ENV, None)
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.uvm.faults", "--out", out,
         "--device", "cpu", "--benches", "ATAX,Pathfinder", "--scale",
         "0.25", *args], env=env, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_chaos_cli_converges_to_the_reference_rows(tmp_path):
    """The reference test's plan (driver kills mid-cell and mid write, a
    corrupted cell file, a truncated cached trace) on the NumPy engine:
    the chaotic grid equals its fault-free baseline, and both equal the
    reference's ``run_sweep(backend="numpy")`` rows on every reference
    column but ``seconds``/``retries``."""
    out = str(tmp_path / "chaos")
    plan = FaultPlan(seed=1, ledger_dir=os.path.join(out, "ledger"), specs=(
        FaultSpec("cell.start", "kill", prob=0.6, max_count=1),
        FaultSpec("cell.result.write", "kill", prob=0.6, max_count=1),
        FaultSpec("cell.result.artifact", "bitflip", prob=0.6,
                  max_count=1),
        FaultSpec("trace.artifact", "truncate", prob=1.0, max_count=1),
    ))
    report = _chaos_cli(out, "--prefetchers", "none,tree", "--backend",
                        "numpy", "--plan", plan.to_json())
    assert report["cells"] == 4
    assert report["faults_fired"] >= 3
    assert report["restarts"] >= 1
    with open(os.path.join(out, "chaos", "quarantine.json")) as f:
        assert json.load(f)["cells"] == []
    rows = sweep.read_results(os.path.join(out, "chaos"))
    ref = ref_sweep.run_sweep(ref_sweep.expand_grid(
        ["ATAX", "Pathfinder"], ["none", "tree"], scales=[0.25],
        backend="numpy"))
    assert len(rows) == len(ref) == 4
    for got, want in zip(rows, ref):
        for k, v in want.items():
            if k not in ref_faults.VOLATILE_ROW_FIELDS:
                assert got[k] == v, (got["bench"], got["prefetcher"], k)


def test_chaos_cli_on_k1_lanes(tmp_path):
    """``--backend cuda``: the demand cells replay as K1 lanes in the
    driver (the plain version here); a driver killed before a lane batch
    and injected transient K1 raises restart the driver, and the grid
    converges with every row on ``cuda``."""
    out = str(tmp_path / "chaos")
    plan = FaultPlan(seed=0, ledger_dir=os.path.join(out, "ledger"), specs=(
        FaultSpec("lane.flush", "kill", prob=1.0, max_count=1),
        FaultSpec("backend.replay", "raise", prob=1.0, max_count=1),
    ))
    report = _chaos_cli(out, "--prefetchers", "none,block", "--backend",
                        "cuda", "--plan", plan.to_json())
    assert report["cells"] == 4
    assert report["faults_fired"] >= 2
    assert report["restarts"] >= 2
    rows = sweep.read_results(os.path.join(out, "chaos"))
    assert all(r["backend"] == "cuda" and r["quarantined"] is False
               for r in rows)
    assert rows_digest(rows) == rows_digest(
        sweep.read_results(os.path.join(out, "baseline")))
