"""The readers of the program's own spans and counters
(``repro_torch.spans``) on hand-made pass records: the right values, and
None where the window's passes left fewer records, a record lacks what a
reader reads, or the window launched no K1."""
import collections

import pytest

from uvmbench import spec

spans = pytest.importorskip("repro_torch.spans")

NAMES = ("sweep_prep_ms_per_pass", "sweep_trace_scans_per_pass",
         "k1_pack_ms_per_pass", "k1_wait_ms_per_pass",
         "k1_lane_balance_pct", "k1_scans_per_access")


def _pass(scale):
    return {"spans": {"sweep.resolve_evictions": 0.4 * scale,
                      "sweep.prepare_cell": 0.5 * scale,
                      "sweep.prepare_cell.working_set": 0.3 * scale,
                      "sweep._solo_requests": 0.1 * scale,
                      "cuda_backend.pack_lanes": 0.05 * scale,
                      "cuda_backend.pack_batch": 0.1 * scale,
                      "cuda_backend.to_device": 0.05 * scale,
                      "cuda_backend.readback": 2.0 * scale,
                      "cuda_backend.unpack": 0.01 * scale},
            "counters": {"sweep.trace_scans": 600,
                         "k1.lane_accesses": 1000, "k1.lane_scans": 250,
                         "k1.lane_ns_sum": int(300 * scale),
                         "k1.lane_ns_longest_x_lanes": int(400 * scale)}}


#: an older record first: the readers take the window's last two
RECORDS = [_pass(9.0), _pass(1.0), _pass(3.0)]
RECORD = {"passes": 2, "counters": {"k1_launches": [12, 12]}}


@pytest.fixture
def kept(monkeypatch):
    def keep(records):
        monkeypatch.setattr(spans, "_passes", collections.deque(records))
    return keep


def read(name, record=RECORD):
    return spec.metric_reader(name).read(record)


def test_readers_on_pass_records(kept):
    kept(RECORDS)
    assert read("sweep_prep_ms_per_pass") == pytest.approx(2000.0)
    assert read("sweep_trace_scans_per_pass") == 600.0
    assert read("k1_pack_ms_per_pass") == pytest.approx(400.0)
    assert read("k1_wait_ms_per_pass") == pytest.approx(4000.0)
    assert read("k1_lane_balance_pct") == pytest.approx(75.0)
    assert read("k1_scans_per_access") == 0.25


def test_balance_weighs_each_batch_by_its_time(kept):
    fast, slow = _pass(1.0), _pass(1.0)
    fast["counters"].update({"k1.lane_ns_sum": 100,
                             "k1.lane_ns_longest_x_lanes": 100})
    slow["counters"].update({"k1.lane_ns_sum": 100,
                             "k1.lane_ns_longest_x_lanes": 900})
    kept([fast, slow])
    assert read("k1_lane_balance_pct") == pytest.approx(20.0)


@pytest.mark.parametrize("name", NAMES)
def test_fewer_records_than_passes(kept, name):
    kept(RECORDS[:1])
    assert read(name) is None
    kept([])
    assert read(name) is None


@pytest.mark.parametrize("name", NAMES)
def test_a_window_without_k1_reads_nothing(kept, name):
    kept(RECORDS)
    assert read(name) is not None
    assert read(name, dict(RECORD, counters={"k1_launches": [0, 0]})) is None
    assert read(name, {}) is None


@pytest.mark.parametrize("name", ["k1_lane_balance_pct",
                                  "k1_scans_per_access"])
def test_lane_readers_need_k1_lane_counters(kept, name):
    cpu = [_pass(1.0), _pass(1.0)]
    for rec in cpu:
        rec["counters"] = {"sweep.trace_scans": 600}
    kept(cpu)
    assert read(name) is None
    assert read("sweep_trace_scans_per_pass") == 600.0
    # one pass of the window without them is enough to read nothing
    kept([_pass(1.0), cpu[0]])
    assert read(name) is None


def test_a_program_without_spans_reads_nothing(monkeypatch):
    import builtins
    real = builtins.__import__

    def no_spans(name, globals=None, locals=None, fromlist=(), level=0):
        if name == "repro_torch" and fromlist and "spans" in fromlist:
            raise ImportError("no repro_torch.spans")
        return real(name, globals, locals, fromlist, level)
    monkeypatch.setattr(builtins, "__import__", no_spans)
    for name in NAMES:
        assert read(name) is None
