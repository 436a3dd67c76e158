"""The reader of ``k1_round_evictions_pct`` (the share of K1's evictions
that its selection rounds made, from the program's counters) on hand-made
pass records: the right value, and None without the counters, without
evictions, with fewer records than passes, or without K1 launches."""
import collections

import pytest

from uvmbench import spec

spans = pytest.importorskip("repro_torch.spans")

NAME = "k1_round_evictions_pct"
RECORD = {"passes": 2, "counters": {"k1_launches": [12, 12]}}


def _pass(round_evictions, evictions):
    return {"spans": {},
            "counters": {"k1.lane_round_evictions": round_evictions,
                         "k1.lane_evictions": evictions}}


@pytest.fixture
def kept(monkeypatch):
    def keep(records):
        monkeypatch.setattr(spans, "_passes", collections.deque(records))
    return keep


def read(record=RECORD):
    return spec.metric_reader(NAME).read(record)


def test_in_the_benchmark_beside_the_kernels_other_counters():
    bench = spec.benchmark()
    entry = next(m for m in bench["per_layer"] if m["name"] == NAME)
    assert entry == {"name": NAME, "unit": "%", "better": "higher",
                     "source": "program_counter",
                     "layer": "K1 lane replay kernel",
                     "moves": "sim_accesses_per_s"}


def test_the_window_passes_summed(kept):
    # an older record first: the reader takes the window's last two
    kept([_pass(0, 10), _pass(300, 400), _pass(600, 800)])
    assert read() == pytest.approx(75.0)
    kept([_pass(0, 50), _pass(0, 50)])
    assert read() == 0.0


def test_none_without_evictions(kept):
    kept([_pass(0, 0), _pass(0, 0)])
    assert read() is None


def test_none_without_the_counters(kept):
    plain = [{"spans": {}, "counters": {"k1.lane_scans": 5}}] * 2
    kept(plain)
    assert read() is None
    # one pass of the window without them is enough to read nothing
    kept([_pass(3, 4), plain[0]])
    assert read() is None


def test_none_with_fewer_records_than_passes(kept):
    kept([_pass(3, 4)])
    assert read() is None


def test_none_without_k1_launches(kept):
    kept([_pass(3, 4), _pass(3, 4)])
    assert read() is not None
    assert read(dict(RECORD, counters={"k1_launches": [0, 0]})) is None
    assert read({}) is None
