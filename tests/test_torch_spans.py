"""The port's tracing module (``repro_torch.spans``) and its gate: off
without a profiler (no pass record, no ``record_function``), on under one
(a pass record of every span and counter, spans in the profiler's
timeline that ``uvmbench``'s reduction reads), and the rows alike either
way.  K1's ``lane_info`` counters are the card's (``tests/
test_torch_cuda.py``)."""
import collections
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch import spans
from repro_torch.uvm import sweep
from repro_torch.uvm.backends import cuda_backend

#: every span a pass of :func:`_cells` opens on the CPU
SPANS = ("sweep.resolve_evictions", "sweep.prepare_cell",
         "sweep.prepare_cell.working_set", "sweep.prepare_cell.eviction",
         "sweep.prepare_cell.prefetcher", "sweep._solo_requests",
         "sweep._solo_requests.component", "sweep.finish_rows",
         "cuda_backend.pack_lanes", "cuda_backend.pack_batch",
         "cuda_backend.to_device", "cuda_backend.readback",
         "cuda_backend.unpack")
K1_COUNTERS = ("k1.lane_accesses", "k1.lane_scans", "k1.lane_ns_sum",
               "k1.lane_ns_longest_x_lanes", "k1.lane_rounds",
               "k1.lane_round_evictions", "k1.lane_evictions")


def _cells():
    """A small grid that reaches every span: a two-tenant pair (solo
    replays) and a single trace, oracle cells among them, on K1's lanes."""
    kw = dict(scales=[0.1], device_fracs=[0.5], evictions=["lru"])
    return (sweep.expand_grid(["ATAX+Pathfinder"], ["none", "oracle"], **kw)
            + sweep.expand_grid(["ATAX"], ["block", "oracle"], **kw))


def _stable(rows):
    return [{k: v for k, v in r.items() if k != "seconds"} for r in rows]


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """Two passes under the profiler, inside a window span as the
    benchmark's traced run opens it: (rows, the two pass records, the
    chrome trace's events)."""
    from uvmbench import tracing
    cells = _cells()
    sweep.run_sweep(cells, device="cpu")            # traces into the memo
    before = len(spans.passes())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(tracing.WINDOW_SPAN):
            rows = [sweep.run_sweep(cells, device="cpu") for _ in range(2)]
    records = spans.passes()[before:]
    path = tmp_path_factory.mktemp("trace") / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return rows, records, events


def test_off_without_a_profiler(monkeypatch):
    def entered(name):
        raise AssertionError(f"record_function({name!r}) entered while off")
    monkeypatch.setattr(spans, "record_function", entered)
    seen = []
    original = cuda_backend.lane_replay

    def spy(**kw):
        seen.append("lane_info" in kw)
        return original(**kw)
    monkeypatch.setattr(cuda_backend, "lane_replay", spy)
    assert not spans.on()
    assert spans.span("sweep.prepare_cell") is spans.OFF
    assert spans.span("cuda_backend.readback") is spans.OFF
    with spans.span("x"):
        spans.count("sweep.trace_scans")
    before = len(spans.passes())
    rows = sweep.run_sweep(_cells(), device="cpu")
    assert len(rows) == 4
    assert len(spans.passes()) == before
    assert seen and not any(seen)


def test_two_traced_passes_leave_two_records(traced):
    _, records, _ = traced
    assert len(records) == 2
    for rec in records:
        assert set(rec) == {"spans", "counters"}
        assert set(rec["spans"]) == set(SPANS)
        assert all(s > 0.0 for s in rec["spans"].values())
        # K1's lane counters come from the kernel alone, on the card
        assert set(rec["counters"]) == {"sweep.trace_scans"}
        assert not set(rec["counters"]) & set(K1_COUNTERS)
        # a sub-span lies inside its parent
        assert (rec["spans"]["sweep.prepare_cell.prefetcher"]
                < rec["spans"]["sweep.prepare_cell"])
    assert (records[0]["counters"]["sweep.trace_scans"]
            == records[1]["counters"]["sweep.trace_scans"] > 0)


def test_k1_lane_info_has_a_column_a_field():
    """K1's ``lane_info`` is (L, 4): chunk scans, nanoseconds, rounds and
    round evictions, a row a lane, zeroed before the launch."""
    from repro_torch.kernels.lane_replay import LANE_INFO_FIELDS
    assert LANE_INFO_FIELDS == ("scans", "ns", "rounds", "round_evictions")
    info = cuda_backend.lane_info_buffer(5, "cpu")
    assert tuple(info.shape) == (5, 4) and info.dtype == torch.int64
    assert not info.any()


def test_k1_lane_info_counts_into_the_pass_record():
    """One batch's ``lane_info`` and stats (real lanes only) add to the
    pass's K1 counters: sums of each column, the longest lane's time by
    the lanes, and the stats' evictions."""
    import numpy as np
    from repro_torch.kernels.lane_replay import N_STATS, STAT_FIELDS

    class Req:
        def __init__(self, n):
            self.trace = type("T", (), {"pages": np.zeros(n)})()
    info = np.array([[10, 300, 2, 700], [0, 500, 0, 0], [4, 100, 1, 90]])
    raw = np.zeros((3, N_STATS))
    raw[:, STAT_FIELDS.index("pages_evicted")] = [720, 3, 95]
    with profile(activities=[ProfilerActivity.CPU]):
        spans.records_pass(cuda_backend.count_lane_info)(
            [Req(100), Req(50), Req(7)], info, raw)
    assert spans.passes()[-1]["counters"] == {
        "k1.lane_accesses": 157, "k1.lane_scans": 14, "k1.lane_ns_sum": 900,
        "k1.lane_ns_longest_x_lanes": 1500, "k1.lane_rounds": 3,
        "k1.lane_round_evictions": 790, "k1.lane_evictions": 818}
    assert set(spans.passes()[-1]["counters"]) == set(K1_COUNTERS)


def test_trace_scans_count_each_whole_trace_pass(monkeypatch):
    """One count a working-set read, oracle build, tenant last-index,
    component extraction and lane page bound: the sweep's, exactly."""
    from repro_torch.traces import interleave, trace
    from repro_torch.uvm import prefetchers, replay_core
    calls = collections.Counter()

    def counted(owner, attr, what, scans=lambda *args: True):
        original = getattr(owner, attr)

        def wrapped(*args, **kwargs):
            calls[what] += bool(scans(*args))
            return original(*args, **kwargs)
        monkeypatch.setattr(owner, attr, wrapped)

    prop = trace.Trace.working_set_pages

    def working_set(self):
        calls["working_set"] += 1
        return prop.fget(self)
    monkeypatch.setattr(trace.Trace, "working_set_pages",
                        property(working_set))
    counted(prefetchers.OraclePrefetcher, "__init__", "oracle")
    # a single-tenant trace has no tenants to scan for
    counted(interleave, "tenant_last_index", "last",
            lambda tr: interleave.mt_meta(tr) is not None)
    counted(interleave, "mt_component_trace", "component")
    for owner in (replay_core, cuda_backend):
        counted(owner, "dense_bounds", "bounds", lambda tr, pf: len(tr.pages))
    cells = _cells()
    with profile(activities=[ProfilerActivity.CPU]):
        sweep.run_sweep(cells, device="cpu")
    got = spans.passes()[-1]["counters"]["sweep.trace_scans"]
    assert calls["working_set"] == 2 * len(cells)
    assert calls["oracle"] >= 2 and calls["component"] == 2
    assert calls["last"] > 0 and calls["bounds"] > 0
    assert got == sum(calls.values())


def test_exported_trace_holds_the_program_spans(traced, monkeypatch):
    from uvmbench import tracing
    _, _, events = traced
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert set(SPANS) <= names
    monkeypatch.setattr(tracing, "TOP_N", 100)
    idle = dict(tracing.reduce_trace(events)["idle_gaps"])
    assert idle["sweep.prepare_cell.working_set"] > 0.0
    assert idle["cuda_backend.pack_batch"] > 0.0


def test_rows_alike_with_tracing_on_and_off(traced):
    rows, _, _ = traced
    off = sweep.run_sweep(_cells(), device="cpu")
    assert _stable(rows[0]) == _stable(off)
    assert _stable(rows[1]) == _stable(off)


def test_a_pass_inside_a_traced_pass_joins_it():
    cells = _cells()[-2:]
    before = len(spans.passes())

    def outer():
        spans.count("outer")
        return sweep.run_sweep(cells, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        spans.records_pass(outer)()
    records = spans.passes()[before:]
    assert len(records) == 1
    assert records[0]["counters"]["outer"] == 1
    assert records[0]["counters"]["sweep.trace_scans"] > 0


def test_pass_records_are_bounded(monkeypatch):
    monkeypatch.setattr(spans, "_passes", collections.deque(maxlen=2))
    step = spans.records_pass(lambda i: spans.count("i", i))
    with profile(activities=[ProfilerActivity.CPU]):
        for i in (1, 2, 3):
            step(i)
    assert [r["counters"]["i"] for r in spans.passes()] == [2, 3]


def test_a_failed_pass_leaves_no_record():
    def fails():
        with spans.span("x"):
            raise RuntimeError("boom")
    before = len(spans.passes())
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(RuntimeError):
            spans.records_pass(fails)()
        assert not spans.on()
    assert len(spans.passes()) == before
