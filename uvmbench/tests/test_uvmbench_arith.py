"""The yardstick's arithmetic on hand-made records: the roofline's bytes,
the metric readers, the reduction of a profiler timeline, the spread."""
import pytest

from uvmbench import roofline, spec, tracing
from uvmbench.peaks import PEAKS
from uvmbench.tools.spread import spread


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


#: a 100 us window: two passes of 50 us; the device works 10-30 and 60-70
#: (a copy overlapping a kernel at 25-30), the host prepares at 30-50
EVENTS = [
    _x(tracing.WINDOW_SPAN, "user_annotation", 0.0, 100.0),
    _x(tracing.PASS_SPAN, "user_annotation", 0.0, 50.0),
    _x(tracing.PASS_SPAN, "user_annotation", 50.0, 50.0),
    _x("sweep.prepare_cell", "user_annotation", 30.0, 20.0),
    _x("K1", "kernel", 10.0, 20.0),
    _x("Memcpy HtoD", "gpu_memcpy", 25.0, 5.0),
    _x("K1", "kernel", 60.0, 10.0),
    _x("aten::copy_", "cpu_op", 0.0, 100.0),
]


def test_reduce_trace():
    s = tracing.reduce_trace(EVENTS)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx(30e-6)
    assert s["kernel_s"] == pytest.approx(30e-6)
    assert s["device_ops"] == [["K1", pytest.approx(30e-6)],
                               ["Memcpy HtoD", pytest.approx(5e-6)]]
    idle = dict(s["idle_gaps"])
    assert idle["sweep.prepare_cell"] == pytest.approx(20e-6)
    assert idle[tracing.PASS_SPAN] == pytest.approx(50e-6)
    assert s["pass_s"] == [pytest.approx(50e-6)] * 2
    assert s["pass_busy_s"] == [pytest.approx(20e-6), pytest.approx(10e-6)]


def test_reduce_trace_without_a_window_or_device():
    assert tracing.reduce_trace(EVENTS[1:]) == {}
    cpu_only = [e for e in EVENTS if e["cat"] not in tracing.DEVICE_CATS]
    assert tracing.reduce_trace(cpu_only)["busy_s"] == 0.0


ROWS = [{"n_accesses": 1000, "tenants": None},
        {"n_accesses": 3000, "tenants": 2}]


def test_roofline_bytes_and_time():
    want = 4 * 4000 + 8 * (9 + 9 + 3)
    assert roofline.replay_bytes(ROWS) == want
    assert roofline.replay_least_seconds(ROWS) == pytest.approx(
        want / 3.35e12)
    assert PEAKS["hbm_bytes_per_s"] == 3.35e12


def test_readers_on_a_record():
    trace = {"window_s": 10.0, "busy_s": 6.0, "kernel_s": 5.0}
    rec = {"passes": 2, "rows": ROWS, "accesses": 4000, "window_s": 10.0,
           "counters": {"k1_launches": [12, 12]}, "trace": trace}

    def read(name):
        return spec.metric_reader(name).read(rec)
    assert read("sweep_host_ms_per_pass") == pytest.approx(2000.0)
    assert read("k1_launches_per_pass") == 12.0
    assert read("k1_ns_per_access") == pytest.approx(5.0 / 4000 * 1e9)
    assert read("k1_roofline") == pytest.approx(
        100 * roofline.replay_least_seconds(ROWS) / 5.0)
    assert read("device_idle_pct") == pytest.approx(40.0)


def test_readers_find_nothing_without_a_device():
    rec = {"passes": 2, "rows": ROWS, "accesses": 4000, "window_s": 10.0,
           "counters": {"k1_launches": [0, 0]},
           "trace": {"window_s": 10.0, "busy_s": 0.0, "kernel_s": 0.0}}
    for name in ("sweep_host_ms_per_pass", "k1_launches_per_pass",
                 "k1_ns_per_access", "k1_roofline", "device_idle_pct"):
        assert spec.metric_reader(name).read(rec) is None
        assert spec.metric_reader(name).read({}) is None


def test_rate_is_all_work_over_all_time():
    from uvmbench.drivers.sweep_pass import end_to_end, work
    rows = ROWS * 3
    assert work(rows) == 12000
    assert end_to_end(rows, 4.0) == {"sim_accesses_per_s": 3000.0}


def test_spread_is_the_quartile_distance_over_the_median():
    assert spread([1.0]) is None
    values = [100.0, 101.0, 102.0, 103.0, 104.0, 105.0]
    q1, q3 = 100.75, 104.25
    assert spread(values) == pytest.approx((q3 - q1) / 102.5)
