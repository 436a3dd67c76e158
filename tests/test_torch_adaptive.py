"""The port's adaptive eviction against the reference's ``repro.uvm.
adaptive``: the probe resolves to the same policy with the same cycles per
policy (the reference replays its probes on its NumPy engine, the port as
K1 lanes, here through K1's plain version), the selector table and
``selector_from_rows`` give the reference's answers, the memo spares
repeated probes, and a grid's probes pack into one lane batch per (proxy
family, policy)."""
import json
import os

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.uvm import adaptive as ref_adaptive
from repro.uvm import sweep as ref_sweep
from repro.uvm.config import UVMConfig as RefConfig
from repro.uvm.eviction import EVICTION_POLICIES
from repro.uvm.replay_core import ReplayRequest as RefRequest
from repro.uvm.replay_core import dispatch
from repro_torch.uvm import adaptive, sweep
from repro_torch.uvm.backends.cuda_backend import CudaReplayBackend

SELECTOR = os.path.join(os.path.dirname(__file__), "..",
                        "ADAPTIVE_selector.json")


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    monkeypatch.delenv("REPRO_ADAPTIVE_TABLE", raising=False)
    adaptive.clear_memo()
    ref_adaptive.clear_memo()
    yield
    adaptive.clear_memo()
    ref_adaptive.clear_memo()


def _ref_probe_cycles(trace, device_pages, proxy, probe_accesses):
    """The reference's probe, replay by replay, on its NumPy engine."""
    n = len(trace.accesses)
    prefix = trace
    if n > probe_accesses:
        prefix = trace.split(probe_accesses / n)[0]
    pages = max(1, int(prefix.working_set_pages * device_pages
                       / trace.working_set_pages))
    return tuple(float(dispatch(RefRequest(
        prefix, ref_adaptive._probe_prefetcher(proxy, prefix),
        RefConfig(device_pages=pages, eviction=p)), backend="numpy").cycles)
        for p in EVICTION_POLICIES)


@pytest.mark.parametrize("bench", ["ATAX", "Pathfinder"])
@pytest.mark.parametrize("ratio", [0.75, 0.5])
@pytest.mark.parametrize("prefetcher", ["none", "block", "tree", "oracle"])
def test_probe_equals_the_reference(bench, ratio, prefetcher):
    trace = sweep.load_trace(bench, 0.25, 0, 0.6)
    ref_trace = ref_sweep.load_trace(bench, 0.25, 0, 0.6)
    assert np.array_equal(trace.accesses, ref_trace.accesses)
    pages = int(trace.working_set_pages * ratio)
    got = adaptive.resolve_eviction("adaptive", bench, trace, pages,
                                    prefetcher=prefetcher, device="cpu")
    want = ref_adaptive.resolve_eviction("adaptive", bench, ref_trace, pages,
                                         prefetcher=prefetcher)
    assert got == want
    cycles = _ref_probe_cycles(ref_trace, pages,
                               ref_adaptive.probe_proxy(prefetcher),
                               ref_adaptive.PROBE_ACCESSES)
    assert adaptive.probed(trace, pages, prefetcher) == (got, cycles)


def test_probe_of_a_prefix_equals_the_reference():
    """A probe shorter than the trace replays its prefix at the cell's
    ratio."""
    trace = sweep.load_trace("Pathfinder", 0.25, 0, 0.6)
    ref_trace = ref_sweep.load_trace("Pathfinder", 0.25, 0, 0.6)
    pages = int(trace.working_set_pages * 0.5)
    assert len(trace) > 1500
    got = adaptive.resolve_eviction("adaptive", "Pathfinder", trace, pages,
                                    probe_accesses=1500, prefetcher="tree",
                                    device="cpu")
    assert got == ref_adaptive.resolve_eviction(
        "adaptive", "Pathfinder", ref_trace, pages, probe_accesses=1500,
        prefetcher="tree")
    reqs = adaptive.probe_requests(trace, pages, 1500, "tree")
    prefix = ref_trace.split(1500 / len(ref_trace.accesses))[0]
    assert [len(r.trace) for r in reqs] == [len(prefix)] * 3
    assert np.array_equal(reqs[0].trace.accesses, prefix.accesses)
    assert adaptive.probed(trace, pages, "tree", 1500)[1] == (
        _ref_probe_cycles(ref_trace, pages, "tree", 1500))


def test_table_and_pass_through_resolve_as_the_reference(monkeypatch,
                                                         tmp_path):
    trace = sweep.load_trace("ATAX", 0.25, 0, 0.6)
    pages = int(trace.working_set_pages * 0.5)
    monkeypatch.setenv("REPRO_ADAPTIVE_TABLE", SELECTOR)
    with open(SELECTOR) as f:
        selector = json.load(f)["selector"]
    for bench, policy in selector.items():
        for fn in (adaptive.resolve_eviction, ref_adaptive.resolve_eviction):
            assert fn("adaptive", bench, trace, pages) == policy
    # a bare {bench: policy} table; a bench outside it probes
    bare = tmp_path / "bare.json"
    bare.write_text(json.dumps({"ATAX": "hotcold"}))
    monkeypatch.setenv("REPRO_ADAPTIVE_TABLE", str(bare))
    assert adaptive.resolve_eviction("adaptive", "ATAX", trace,
                                     pages) == "hotcold"
    assert adaptive.resolve_eviction(
        "adaptive", "NW", trace, pages, device="cpu") == (
        ref_adaptive.resolve_eviction("adaptive", "NW", trace, pages))
    bare.write_text(json.dumps({"ATAX": "fifo"}))
    os.utime(bare, ns=(1, 1))
    with pytest.raises(ValueError):
        adaptive.resolve_eviction("adaptive", "ATAX", trace, pages)
    monkeypatch.setenv("REPRO_ADAPTIVE_TABLE", str(tmp_path / "none.json"))
    with pytest.raises(FileNotFoundError, match="REPRO_ADAPTIVE_TABLE"):
        adaptive.resolve_eviction("adaptive", "ATAX", trace, pages)
    # concrete policies pass through (the table is never read); no
    # pressure resolves to lru
    assert adaptive.resolve_eviction("hotcold", "ATAX") == "hotcold"
    monkeypatch.delenv("REPRO_ADAPTIVE_TABLE")
    with pytest.raises(ValueError):
        adaptive.resolve_eviction("fifo", "ATAX")
    for args in ((None, None), (trace, None),
                 (trace, trace.working_set_pages)):
        assert adaptive.resolve_eviction("adaptive", "ATAX", *args) == (
            ref_adaptive.resolve_eviction("adaptive", "ATAX", *args)) == "lru"


def test_selector_from_rows_and_cli_equal_the_reference(tmp_path):
    rng = np.random.default_rng(3)
    rows = [{"bench": b, "eviction": p, "cycles": int(c)}
            for b in ("ATAX", "NW", "MVT")
            for p in EVICTION_POLICIES + ("adaptive",)
            for c in rng.integers(100, 104, 3)]
    rows += [{"bench": "MVT", "eviction": "lru", "cycles": None},
             {"bench": "Tie", "eviction": "random", "cycles": 7},
             {"bench": "Tie", "eviction": "hotcold", "cycles": 7}]
    want = ref_adaptive.selector_from_rows(rows)
    assert adaptive.selector_from_rows(rows) == want
    assert want["Tie"] == "random"                  # ties in policy order
    results = tmp_path / "results.json"
    results.write_text(json.dumps({"rows": rows}))
    ref_adaptive.main([str(results), "--out", str(tmp_path / "ref.json")])
    adaptive.main([str(results), "--out", str(tmp_path / "port.json")])
    assert (json.loads((tmp_path / "port.json").read_text())["selector"]
            == json.loads((tmp_path / "ref.json").read_text())["selector"])


def test_memo_and_one_lane_batch_per_proxy_and_policy(monkeypatch):
    """A grid's probes run in one backend call, one lane batch per (proxy
    family, policy); learned and oracle cells share a probe; a resolved
    probe never replays again."""
    batches = []
    replay_batch = CudaReplayBackend._replay_batch

    def counting(self, requests):
        batches.append((type(requests[0].prefetcher).__name__,
                        requests[0].config.eviction, len(requests)))
        return replay_batch(self, requests)

    monkeypatch.setattr(CudaReplayBackend, "_replay_batch", counting)
    jobs = []
    for bench in ("ATAX", "Pathfinder"):
        trace = sweep.load_trace(bench, 0.25, 0, 0.6)
        for ratio in (0.75, 0.5):
            pages = int(trace.working_set_pages * ratio)
            for pf in ("learned", "oracle", "none"):
                jobs.append(("adaptive", bench, trace, pages, pf))
    got = adaptive.resolve_all(jobs, device="cpu")
    assert sorted(batches) == sorted(
        (pf, p, 4) for pf in ("NoPrefetcher", "OraclePrefetcher")
        for p in EVICTION_POLICIES)
    assert got == [ref_adaptive.resolve_eviction(
        pol, bench, trace, pages, prefetcher=pf)
        for pol, bench, trace, pages, pf in jobs]
    batches.clear()
    assert adaptive.resolve_all(jobs, device="cpu") == got
    assert batches == []


def test_sweep_rows_record_the_probed_policy():
    cells = sweep.expand_grid(["ATAX", "Pathfinder"], ["none", "tree"],
                              scales=[0.25], device_fracs=[None, 0.5],
                              evictions=["adaptive"])
    rows = sweep.run_sweep(cells, device="cpu")
    ref = ref_sweep.run_sweep(ref_sweep.expand_grid(
        ["ATAX", "Pathfinder"], ["none", "tree"], scales=[0.25],
        device_fracs=[None, 0.5], evictions=["adaptive"], backend="numpy"))
    for r, g in zip(ref, rows):
        assert g["eviction"] == r["eviction"] != "adaptive"
        for f in ("hits", "faults", "pages_evicted", "device_pages"):
            assert g[f] == r[f], f
        assert g["cycles"] == pytest.approx(r["cycles"], rel=1e-6)
