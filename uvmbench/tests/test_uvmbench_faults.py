"""A run drives the rest of the harness (the look for a card skipped, K1's
plain version on the CPU) and judges what the timed path produced: a sound
run comes out correct, and each fault the cells can have, planted where K1
produces its answers, comes out not correct.  (A one-card cell has no
exchange between cards to leave out.)"""
import time

import pytest
import torch

from uvmbench import harness

from .conftest import small_cell, with_cell


def _run(bench, name, benches, **kw):
    config, traffic = small_cell(bench, name, benches, **kw)
    result, checks = harness.run_cell(
        name, 2 ** 31 + 3, 0.01, False, device="cpu",
        t_start=time.perf_counter(), bench=with_cell(bench, name),
        config=config, traffic=traffic, workers=0)
    return result, checks


def _state_unchanged(raw):
    """K1 returns the counters it started from: nothing replayed."""
    return torch.zeros_like(raw)


def _half_left_out(raw):
    """The second half of the lanes left out, the mean of the first half
    in their place."""
    half = max(1, raw.shape[0] // 2)
    out = raw.clone()
    out[half:] = raw[:half].mean(dim=0)
    return out


def _answer_altered(raw):
    """One answer altered where it is produced: lane 0's hit count."""
    out = raw.clone()
    out[0, 1] += 1
    return out


@pytest.fixture
def plant(monkeypatch):
    from repro_torch.uvm.backends import cuda_backend
    original = cuda_backend.lane_replay

    def install(fault):
        def broken(**kw):
            out = original(**kw)
            if isinstance(out, tuple):
                return (fault(out[0]),) + tuple(out[1:])
            return fault(out)
        monkeypatch.setattr(cuda_backend, "lane_replay", broken)
    return install


def test_sound_run_is_correct(bench):
    result, checks = _run(bench, "paper11.oversub", ["ATAX", "Pathfinder"])
    assert result["correct"], checks
    assert result["attempted"] == 12 and result["failed"] == 0
    assert set(result["metrics"]) == {"sim_accesses_per_s", "setup_s"}
    assert list(result)[-1] == "checks"


def test_sound_pair_run_is_correct(bench):
    result, checks = _run(bench, "paper-pairs.quota", ["MVT+StreamTriad"],
                          prefetchers=("none",))
    assert result["correct"], checks
    assert result["attempted"] == 6


@pytest.mark.parametrize("fault", [_state_unchanged, _half_left_out,
                                   _answer_altered])
def test_fault_is_not_correct(bench, plant, fault):
    plant(fault)
    result, checks = _run(bench, "paper11.oversub", ["ATAX", "Pathfinder"])
    assert not result["correct"]
    assert checks["mismatches"][0] > 0 or checks["float_rel_gap"][0] > 1e-6
    assert result["failed"] > 0


def test_fault_in_a_step_clock_lane_is_not_correct(bench, plant):
    plant(_answer_altered)
    result, _ = _run(bench, "paper-pairs.shared", ["MVT+StreamTriad"],
                     prefetchers=("none",))
    assert not result["correct"]


def test_traced_run_on_the_cpu_reads_only_counters(bench):
    config, traffic = small_cell(bench, "paper11.oversub", ["ATAX"])
    result, _ = harness.run_cell(
        "paper11.oversub", 1, 0.01, True, device="cpu",
        t_start=time.perf_counter(), bench=bench, config=config,
        traffic=traffic, workers=0)
    assert result["correct"]
    # the plain version launches nothing and the CPU has no device timeline
    assert result["metrics"] == {}
    assert result["device"]["busy_s"] == 0.0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
