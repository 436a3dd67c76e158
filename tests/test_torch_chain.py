"""The port's backend chain on the CPU: ``backend_chain`` for each name;
every decline route of K1 (``cuda_backend.decline_reason``) lands on the
NumPy engine through ``dispatch`` and equals the reference's
``dispatch(..., backend="numpy")``; a K1 runtime failure propagates out of
``dispatch`` and ``run_sweep`` instead of falling back; an adaptive probe K1
declines picks the reference's policy; and the sweep honours
``SweepCell.engine`` and ``backend``: rows record the backend that ran them,
equal the reference's ``simulate_cell`` rows, and come back in the order of
the cells."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.traces.trace import Trace as RefTrace
from repro.uvm import adaptive as ref_adaptive
from repro.uvm import prefetchers as RP
from repro.uvm import sweep as ref_sweep
from repro.uvm.config import UVMConfig as RefConfig
from repro.uvm.replay_core import ReplayRequest as RefRequest
from repro.uvm.replay_core import dispatch as ref_dispatch
from repro_torch.traces.trace import Trace, make_records
from repro_torch.uvm import adaptive, sweep
from repro_torch.uvm import golden as G
from repro_torch.uvm import prefetchers as P
from repro_torch.uvm.backends import cuda_backend
from repro_torch.uvm.config import UVMConfig
from repro_torch.uvm.eviction import EVICTION_POLICIES
from repro_torch.uvm.replay_core import (ReplayRequest, available_backends,
                                         backend_chain, dispatch, get_backend)
from repro_torch.uvm.simulator import UVMSimulator


@pytest.mark.parametrize("name,chain", [
    ("auto", ["cuda", "numpy", "legacy"]),
    ("cuda", ["cuda", "numpy", "legacy"]),
    ("numpy", ["numpy", "legacy"]),
    ("legacy", ["legacy"]),
    ("bogus", None),
])
def test_backend_chain(name, chain):
    assert available_backends() == ["cuda", "legacy", "numpy"]
    if chain is None:
        with pytest.raises(ValueError, match="unknown replay backend"):
            backend_chain(name)
        return
    assert backend_chain(name) == chain
    assert [get_backend(b, "cpu").name for b in chain] == chain


def _pair(pages, make_pf, make_ref_pf, **cfg):
    """The same cell as a port request and a reference request."""
    pages = np.asarray(pages, dtype=np.int64)
    recs = make_records(len(pages))
    recs["page"] = pages
    trace = Trace("synth", recs, {}, {}, 100 * len(pages))
    ref_trace = RefTrace("synth", recs.copy(), {}, {}, 100 * len(pages))
    return (ReplayRequest(trace, make_pf(pages), UVMConfig(**cfg)),
            RefRequest(ref_trace, make_ref_pf(pages), RefConfig(**cfg)))


def _cyclic(n, width, base=0):
    return base + (np.arange(n, dtype=np.int64) * 7) % width


#: one request per decline route: (pages, port and reference prefetcher
#: factories, config, request fields, what decline_reason names)
ROUTES = {
    "oracle_lookahead": (
        _cyclic(1500, 300), lambda p: P.OraclePrefetcher(p, lookahead=1024),
        lambda p: RP.OraclePrefetcher(p, lookahead=1024),
        dict(device_pages=200), {},
        "oracle lookahead 1024 outside 1..512"),
    "step_windows": (
        _cyclic(70_000, 3000), lambda p: P.NoPrefetcher(),
        lambda p: RP.NoPrefetcher(), dict(device_pages=1000,
                                          eviction="random"),
        {"step_bounds": np.arange(1, 70_001, dtype=np.int64)},
        "70000 step windows outside 1..65536"),
    "span": (
        np.stack([_cyclic(800, 400), _cyclic(800, 400, 1 << 20)],
                 axis=1).ravel(), lambda p: P.TreePrefetcher(),
        lambda p: RP.TreePrefetcher(), dict(device_pages=500,
                                            eviction="hotcold"), {},
        "page span [0, 1049088) outside the lane ceiling"),
    "tree_length": (
        _cyclic(1500, 600), lambda p: P.TreePrefetcher(),
        lambda p: RP.TreePrefetcher(), dict(device_pages=400), {},
        "trace length 1500 outside 1..1000"),
    "timeline": (
        _cyclic(1500, 600), lambda p: P.BlockPrefetcher(),
        lambda p: RP.BlockPrefetcher(), dict(device_pages=400),
        {"record_timeline": True}, "K1 records no per-transfer timeline"),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_declined_request_replays_on_numpy(route, monkeypatch):
    """K1 declines the request, naming why; ``dispatch`` on the ``cuda``
    chain replays it on the NumPy engine, equal to the reference's NumPy
    engine (counters exact, floats within 1e-6, step clocks and the
    timeline too) and to the port's legacy engine.  The long-trace route
    lowers K1's tree ceiling to 1,000 accesses."""
    pages, make_pf, make_ref_pf, cfg, fields, why = ROUTES[route]
    if route == "tree_length":
        monkeypatch.setattr(cuda_backend, "_FAMILY_MAX_ACCESSES", dict(
            cuda_backend._FAMILY_MAX_ACCESSES, tree=1000))
    req, ref_req = _pair(pages, make_pf, make_ref_pf, **cfg)
    req = dataclasses.replace(req, **fields)
    ref_req = dataclasses.replace(ref_req, **fields)
    assert why in cuda_backend.decline_reason(req)
    got = dispatch(req, "cuda", device="cpu")
    assert got.backend == "numpy"
    want = ref_dispatch(ref_req, backend="numpy")
    legacy = UVMSimulator(req.config, req.record_timeline).run(
        req.trace, make_pf(pages), step_bounds=req.step_bounds)
    for other in (want, legacy):
        for f in G.INT_FIELDS:
            assert getattr(got, f) == getattr(other, f), f
        for f in G.FLOAT_FIELDS:
            assert getattr(got, f) == pytest.approx(getattr(other, f),
                                                    rel=1e-6, abs=1e-9), f
        assert (got.step_clocks is None) == (other.step_clocks is None)
        if got.step_clocks is not None:
            np.testing.assert_array_equal(got.step_clocks, other.step_clocks)
        assert (got.timeline is None) == (other.timeline is None)
        if got.timeline is not None:
            np.testing.assert_allclose(got.timeline, other.timeline,
                                       rtol=1e-6)
    assert got.pages_evicted > 0


def test_k1_runtime_failure_propagates(monkeypatch):
    """A K1 failure is never served by the NumPy engine: ``dispatch`` and
    ``run_sweep`` raise, and no row comes back.  Declined requests never
    reach K1, so they still replay."""
    def broken(**kwargs):
        raise RuntimeError("K1 launch failed")

    monkeypatch.setattr(cuda_backend, "lane_replay", broken)
    req, _ = _pair(_cyclic(500, 100), lambda p: P.NoPrefetcher(),
                   lambda p: RP.NoPrefetcher(), device_pages=50)
    assert cuda_backend.decline_reason(req) is None
    with pytest.raises(RuntimeError, match="K1 launch failed"):
        dispatch(req, "cuda", device="cpu")
    with pytest.raises(RuntimeError, match="K1 launch failed"):
        sweep.run_sweep([sweep.SweepCell("ATAX", "none", scale=0.1,
                                         device_frac=0.5)], device="cpu")
    declined = dataclasses.replace(req, record_timeline=True)
    assert dispatch(declined, "cuda", device="cpu").backend == "numpy"


def test_declined_probe_picks_the_reference_policy():
    """An adaptive cell whose trace spans two regions 2^20 pages apart: K1
    declines each probe, the probes replay on the NumPy engine through
    ``dispatch``, and the choice and the cycles per policy equal the
    reference's probe on its NumPy engine."""
    adaptive.clear_memo()
    ref_adaptive.clear_memo()
    pages = np.stack([_cyclic(3000, 300), _cyclic(3000, 300, 1 << 20)],
                     axis=1).ravel()
    req, ref_req = _pair(pages, lambda p: P.NoPrefetcher(),
                         lambda p: RP.NoPrefetcher())
    cap = req.trace.working_set_pages // 2
    probes = adaptive.probe_requests(req.trace, cap, adaptive.PROBE_ACCESSES,
                                     "tree")
    k1 = get_backend("cuda", "cpu")
    assert not any(k1.can_replay(r) for r in probes)
    got = adaptive.resolve_all([("adaptive", "synth", req.trace, cap,
                                 "tree")], device="cpu")
    want = ref_adaptive.resolve_eviction("adaptive", "synth", ref_req.trace,
                                         cap, prefetcher="tree")
    ref_prefix = ref_req.trace
    ref_cycles = tuple(float(ref_dispatch(RefRequest(
        ref_prefix, RP.TreePrefetcher(),
        RefConfig(device_pages=r.config.device_pages, eviction=p)),
        backend="numpy").cycles) for r, p in zip(probes, EVICTION_POLICIES))
    assert got == [want]
    assert adaptive.probed(req.trace, cap, "tree") == (want, ref_cycles)
    adaptive.clear_memo()
    ref_adaptive.clear_memo()


#: the cells of the engine/backend repair: ATAX and BICG at scale 0.25
REPAIR_CELLS = [dict(bench=b, prefetcher=pf, scale=0.25, device_frac=frac)
                for b in ("ATAX", "BICG")
                for pf in ("none", "block", "tree", "oracle")
                for frac in (None, 0.5)]
_NOT_COMPARED = {"seconds", "backend", "engine"}


@pytest.mark.parametrize("field,value,backend", [
    ("engine", "legacy", "legacy"), ("backend", "numpy", "numpy")])
def test_engine_and_backend_fields_route_the_replay(field, value, backend):
    """``SweepCell(engine="legacy")`` rows come from the legacy loop and
    ``backend="numpy"`` rows from the NumPy engine, never from K1, and say
    so in their ``backend`` column; both equal the reference's
    ``simulate_cell`` rows of the same cells."""
    cells = [sweep.SweepCell(**kw, **{field: value}) for kw in REPAIR_CELLS]
    rows = sweep.run_sweep(cells, device="cpu")
    assert [r["backend"] for r in rows] == [backend] * len(cells)
    for kw, row in zip(REPAIR_CELLS, rows):
        want = ref_sweep.simulate_cell(ref_sweep.SweepCell(
            **kw, **{field: value}))
        assert want["backend"] == backend
        assert row[field] == want[field] == value
        for f in sweep.ROW_FIELDS:
            if f in _NOT_COMPARED:
                continue
            if isinstance(want[f], float):
                assert row[f] == pytest.approx(want[f], rel=1e-6), (kw, f)
            else:
                assert row[f] == want[f], (kw, f)


@pytest.mark.parametrize("change,match", [
    ({"engine": "vectorised"}, "unknown engine 'vectorised'"),
    ({"backend": "pallas"}, "unknown backend 'pallas'"),
])
def test_unknown_engine_or_backend_raises(change, match):
    cell = sweep.SweepCell("ATAX", "none", scale=0.1, **change)
    with pytest.raises(ValueError, match=match):
        sweep.check_cell(cell)
    with pytest.raises(ValueError, match=match):
        sweep.run_sweep([cell], device="cpu")


def test_mixed_grid_rows_keep_the_order_of_the_cells():
    """Lane rows and dispatched rows merge back by index; a dispatched
    row's seconds are its own replay time."""
    kw = dict(scale=0.1, device_frac=0.5)
    cells = [sweep.SweepCell("ATAX", "none", **kw),
             sweep.SweepCell("ATAX", "none", backend="numpy", **kw),
             sweep.SweepCell("BICG", "tree", **kw),
             sweep.SweepCell("BICG", "tree", engine="legacy", **kw),
             sweep.SweepCell("ATAX", "tree", backend="auto", **kw)]
    rows = sweep.run_sweep(cells, device="cpu")
    assert [(r["bench"], r["prefetcher"], r["backend"]) for r in rows] == [
        ("ATAX", "none", "cuda"), ("ATAX", "none", "numpy"),
        ("BICG", "tree", "cuda"), ("BICG", "tree", "legacy"),
        ("ATAX", "tree", "cuda")]
    for a, b in ((0, 1), (2, 3)):
        for f in ("hits", "faults", "pages_evicted", "pcie_bytes"):
            assert rows[a][f] == rows[b][f], f
    assert all(r["seconds"] > 0 for r in rows)


@pytest.mark.parametrize("bench,extra", [
    ("ServeDecode", dict(window=None, prefetcher="block")),
    ("ATAX+Pathfinder", dict(prefetcher="tree", capacity_split="0.4/0.4")),
])
def test_declined_serve_and_mt_rows_carry_their_step_clocks(bench, extra):
    """A serve or multi-tenant cell on the NumPy engine (its solo replays
    too) carries the step clocks behind its latency or slowdown columns,
    equal to the same cell's row on K1."""
    kw = dict(bench=bench, scale=0.1, device_frac=0.5, eviction="hotcold",
              **extra)
    on_k1, on_numpy = sweep.run_sweep(
        [sweep.SweepCell(**kw), sweep.SweepCell(**kw, backend="numpy")],
        device="cpu")
    assert (on_k1["backend"], on_numpy["backend"]) == ("cuda", "numpy")
    cols = (sweep.SERVE_LATENCY_FIELDS if bench.startswith("Serve")
            else sweep.MT_FIELDS[2:])
    for f in ("hits", "faults", "pages_evicted", "cycles", *cols):
        assert on_numpy[f] is not None, f
        assert on_numpy[f] == pytest.approx(on_k1[f], rel=1e-6), f


def test_simulate_cell_records_the_timeline():
    """``simulate_cell(record_timeline=True)`` replays on the NumPy engine
    (K1 records no timeline) and puts the legacy engine's timeline into the
    row; without it the same cell runs on K1."""
    cell = sweep.SweepCell("BICG", "tree", scale=0.25, device_frac=0.5)
    row = sweep.simulate_cell(cell, device="cpu", record_timeline=True)
    assert row["backend"] == "numpy"
    trace, config, pf, _ = sweep.prepare_cell(cell, device="cpu")
    want = UVMSimulator(config, record_timeline=True).run(trace, pf)
    np.testing.assert_allclose(np.asarray(row["timeline"]), want.timeline,
                               rtol=1e-6)
    plain = sweep.simulate_cell(cell, device="cpu")
    assert plain["backend"] == "cuda" and "timeline" not in plain
    assert plain["pcie_bytes"] == row["pcie_bytes"]
