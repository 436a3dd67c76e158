"""The serving scenarios on the port, on the CPU: the port's serve traces are
the reference's, K1's step clocks (its plain version) equal the reference's
legacy and NumPy engines bit for bit, empty and leading-empty windows
included, and the ``serve-smoke`` rows equal the reference sweep's
``backend="numpy"`` rows.  Mirrors ``tests/test_serve.py``."""
import dataclasses
import os

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.offload import serve_trace as ref_st
from repro.uvm import UVMConfig as RefConfig
from repro.uvm import sweep as ref_sweep
from repro.uvm.golden import make_prefetcher as ref_make_prefetcher
from repro.uvm.replay_core import ReplayRequest as RefRequest
from repro.uvm.replay_core import get_backend as ref_backend
from repro.uvm.simulator import UVMSimulator as RefSimulator
from repro_torch.kernels.lane_replay import MAX_LANE_STEPS
from repro_torch.offload import serve_trace as st
from repro_torch.uvm import golden as G
from repro_torch.uvm import sweep
from repro_torch.uvm.backends.cuda_backend import (CudaReplayBackend,
                                                   decline_reason)
from repro_torch.uvm.config import UVMConfig
from repro_torch.uvm.replay_core import ReplayRequest, get_backend
from repro_torch.uvm.scenarios import expand_scenario

LAT_FIELDS = sweep.SERVE_LATENCY_FIELDS
ALL_BENCHES = tuple(st.SERVE_WORKLOADS) + ("ServeBursty@r128",)
COUNTERS = ("hits", "late", "faults", "prefetch_issued", "prefetch_used",
            "pages_migrated", "pages_evicted")


def _lane(trace, pf_name="none", frac=None, eviction="lru", bounds=None):
    """The port's K1 (its plain version here) and the reference's legacy
    and NumPy engines on one serve cell; returns (port, legacy, numpy)."""
    cap = None if frac is None else int(trace.working_set_pages * frac)
    cfg = UVMConfig(device_pages=cap, eviction=eviction)
    ref_cfg = RefConfig(device_pages=cap, eviction=eviction)
    bounds = st.trace_step_bounds(trace) if bounds is None else bounds
    port = get_backend("cuda", device="cpu").replay([ReplayRequest(
        trace, G.make_prefetcher(pf_name, trace, cfg), cfg,
        step_bounds=bounds)])[0]
    ref_trace = _ref_trace(trace)
    legacy = RefSimulator(ref_cfg).run(
        ref_trace, ref_make_prefetcher(pf_name, ref_trace, ref_cfg),
        step_bounds=bounds)
    numpy = ref_backend("numpy").replay([RefRequest(
        ref_trace, ref_make_prefetcher(pf_name, ref_trace, ref_cfg),
        ref_cfg, step_bounds=bounds)])[0]
    return port, legacy, numpy


def _ref_trace(trace):
    from repro.traces.trace import Trace as RefTrace
    return RefTrace(trace.name, trace.accesses, trace.array_bases,
                    trace.array_pages, trace.n_instructions, meta=trace.meta)


def _assert_same(port, *refs):
    assert port.backend == "cuda"
    for ref in refs:
        assert np.array_equal(port.step_clocks, ref.step_clocks)
        for f in COUNTERS:
            assert getattr(port, f) == getattr(ref, f), f
        assert port.cycles == ref.cycles
        assert port.pcie_bytes == ref.pcie_bytes


@pytest.mark.parametrize("bench", ALL_BENCHES)
def test_serve_trace_is_the_reference_trace(bench):
    """The same accesses, sidecar, step bounds and latency columns."""
    mine = st.build_serve_trace(bench, scale=0.25, seed=1)
    ref = ref_st.build_serve_trace(bench, scale=0.25, seed=1)
    assert mine.name == ref.name
    assert np.array_equal(mine.accesses, ref.accesses)
    assert mine.meta == ref.meta
    assert (mine.array_bases, mine.array_pages, mine.n_instructions) == (
        ref.array_bases, ref.array_pages, ref.n_instructions)
    assert np.array_equal(st.trace_step_bounds(mine),
                          ref_st.trace_step_bounds(ref))
    assert st.is_serve_bench(bench) and ref_st.is_serve_bench(bench)
    clocks = np.cumsum(np.random.default_rng(0).uniform(
        1e4, 1e6, mine.meta["serve"]["n_steps"]))
    assert (st.serve_latency_columns(mine, clocks, UVMConfig())
            == ref_st.serve_latency_columns(ref, clocks, RefConfig()))


def test_workloads_and_npz_round_trip(tmp_path):
    assert ({n: dataclasses.asdict(w) for n, w in st.SERVE_WORKLOADS.items()}
            == {n: dataclasses.asdict(w)
                for n, w in ref_st.SERVE_WORKLOADS.items()})
    trace = st.build_serve_trace("ServeDecode", scale=0.1)
    path = str(tmp_path / "serve.npz")
    st.save_trace_npz(trace, path)
    back = ref_st.load_trace_npz(path)
    assert np.array_equal(back.accesses, trace.accesses)
    assert back.meta == trace.meta
    ref_st.save_trace_npz(back, path)
    again = st.load_trace_npz(path)
    assert np.array_equal(again.accesses, trace.accesses)
    assert again.meta == trace.meta and again.name == trace.name


#: the reference's serve golden cells (tests/test_serve.py): every serve
#: workload x eviction policy x demand-family prefetcher at half the
#: working set
SERVE_GOLDEN_CELLS = [(bench, pol, pf)
                      for bench in ("ServeDecode", "ServeBursty")
                      for pol in ("lru", "random", "hotcold")
                      for pf in ("none", "block")]


@pytest.mark.parametrize("bench,policy,pf", SERVE_GOLDEN_CELLS,
                         ids=[f"{b}-{pol}-{pf}"
                              for b, pol, pf in SERVE_GOLDEN_CELLS])
def test_step_clocks_equal_legacy_and_numpy(bench, policy, pf):
    trace = st.build_serve_trace(bench, scale=0.25, seed=0)
    _assert_same(*_lane(trace, pf, 0.5, policy))


@pytest.mark.parametrize("pf", ["tree", "learned", "oracle"])
def test_step_clocks_with_empty_windows(pf):
    """ServeBursty@r8 at scale 0.25: 622 of its 762 windows are empty."""
    trace = st.build_serve_trace("ServeBursty@r8", scale=0.25, seed=0)
    sizes = np.diff(np.concatenate([[0], st.trace_step_bounds(trace)]))
    assert sizes.size == 762 and int((sizes == 0).sum()) == 622
    _assert_same(*_lane(trace, pf, 0.5, "hotcold"))


def test_duplicate_and_leading_empty_bounds():
    """Hand-made bounds: leading, duplicate and trailing windows, and a
    last bound before the end of the trace (the rest go to the trash
    window)."""
    trace = st.build_serve_trace("ServeDecode", scale=0.1, seed=0)
    n = len(trace)
    bounds = np.array([0, 0, 5, 5, 5, 40, n // 2, n // 2, n - 3],
                      dtype=np.int64)
    port, legacy, numpy = _lane(trace, "block", 0.5, "lru", bounds=bounds)
    _assert_same(port, legacy, numpy)
    assert port.step_clocks[0] == port.step_clocks[1] == 0.0
    assert port.step_clocks[3] == port.step_clocks[2] > 0.0


def test_mixed_batch_and_bad_bounds():
    """One launch mixes lanes with and without bounds; malformed or
    oversized bounds are refused with a reason, never degraded."""
    trace = st.build_serve_trace("ServeDecode", scale=0.1, seed=0)
    cfg = UVMConfig(device_pages=int(trace.working_set_pages * 0.5))
    bounds = st.trace_step_bounds(trace)
    with_b = ReplayRequest(trace, G.make_prefetcher("none", trace, cfg), cfg,
                           step_bounds=bounds)
    without = ReplayRequest(trace, G.make_prefetcher("none", trace, cfg),
                            cfg)
    backend = CudaReplayBackend(device="cpu")
    batch = backend.pack_batch([with_b, without])
    assert batch.steps_len >= bounds.size
    assert batch.sids.shape == batch.pages.shape
    got = backend._replay_batch([with_b, without])
    assert got[1].step_clocks is None
    assert got[0].cycles == got[1].cycles
    assert got[0].step_clocks[-1] <= got[0].cycles
    for bad, why in ((np.array([5, 3]), "non-decreasing"),
                     (np.array([len(trace) + 1]), "non-decreasing"),
                     (np.array([], dtype=np.int64), "non-empty"),
                     (np.zeros((2, 2), dtype=np.int64), "non-empty"),
                     (np.ones(MAX_LANE_STEPS + 1, dtype=np.int64),
                      f"{MAX_LANE_STEPS + 1} step windows")):
        req = dataclasses.replace(with_b, step_bounds=bad)
        assert why in decline_reason(req)
        with pytest.raises(ValueError, match="cannot replay"):
            backend.replay([req])


def test_serve_smoke_equals_the_reference_numpy_rows():
    """24 rows: ServeDecode and ServeBursty at scale 0.25 x ratios 0.75
    and 0.5 x three policies x none and block."""
    ref = ref_sweep.run_sweep(expand_scenario("serve-smoke",
                                              backend="numpy"))
    got = sweep.run_sweep(expand_scenario("serve-smoke"), device="cpu")
    assert len(got) == len(ref) == 24
    for r, g in zip(ref, got):
        assert g["backend"] == "cuda" and r["backend"] == "numpy"
        assert g["slo_source"] == r["slo_source"] == "kernel"
        for f in ("bench", "prefetcher", "device_frac", "eviction",
                  "device_pages", "n_accesses", *COUNTERS):
            assert g[f] == r[f], (r["bench"], f)
        for f in ("cycles", "pcie_bytes", *LAT_FIELDS):
            assert g[f] == pytest.approx(r[f], rel=1e-6), (r["bench"], f)
        for m in ("decode_lat", "ttft"):
            assert (g[f"{m}_p50_us"] <= g[f"{m}_p95_us"]
                    <= g[f"{m}_p99_us"])
        for f in sweep.MT_FIELDS:
            assert g[f] is None


def test_serve_row_without_clocks_raises(monkeypatch):
    """A row whose replay brought no step clocks raises: nothing
    re-replays it quietly.  REPRO_SERVE_CHECK=1 re-replays a row on the
    port's legacy engine and requires its counters and clocks."""
    cell = sweep.SweepCell("ServeDecode", "block", scale=0.1, window=None,
                           device_frac=0.5, eviction="random")
    trace, config, pf, _ = sweep.prepare_cell(cell, device="cpu")
    req = ReplayRequest(trace, pf, config,
                        step_bounds=sweep._step_bounds(trace))
    stats = get_backend("cuda", device="cpu").replay([req])[0]
    monkeypatch.setenv("REPRO_SERVE_CHECK", "1")
    row = sweep._serve_latency_row(cell, trace, config, stats, None, "cpu")
    assert row["slo_source"] == "kernel"
    stats.step_clocks = stats.step_clocks + 1.0
    with pytest.raises(AssertionError, match="step clocks diverge"):
        sweep._serve_latency_row(cell, trace, config, stats, None, "cpu")
    stats.step_clocks = None
    with pytest.raises(ValueError, match="without its"):
        sweep._serve_latency_row(cell, trace, config, stats, None, "cpu")


def test_sweep_cli_runs_serve_benches(tmp_path, capsys):
    sweep.main(["--benches", "ServeBursty@r128", "--prefetchers", "block",
                "--scales", "0.1", "--windows", "full", "--device-fracs",
                "0.5", "--evictions", "hotcold", "--device", "cpu",
                "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert "2 cells" in out
    assert "ServeBursty@r128,block,0.5000,hotcold,cuda" in out
    with open(os.path.join(tmp_path, "results.csv")) as f:
        assert "kernel" in f.read()
