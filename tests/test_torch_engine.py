"""The port's NumPy chunked engine (``repro_torch.uvm.replay_core.
replay_chunked``, the ``numpy`` backend) against the live reference on the
CPU: on every other golden cell (the rest are in
``test_torch_engine_golden.py``) it equals the reference's
``repro.uvm.replay_core.replay_chunked`` and the port's legacy engine,
integer counters exact and cycles/pcie_bytes within 1e-6 relative; and the
NumPy-engine tests of ``tests/test_uvm_golden.py``, ported: the transfer
timeline, the legacy fallbacks of an unknown prefetcher and a huge span, the
empty trace, and the two property tests (derandomized, so the suite's count
is steady)."""
import numpy as np
import pytest

pytest.importorskip("torch")
from hypothesis import given, settings, strategies as st_

from repro.traces.trace import Trace as RefTrace
from repro.uvm import golden as R
from repro.uvm.config import UVMConfig as RefConfig
from repro.uvm.replay_core import ReplayRequest as RefRequest
from repro.uvm.replay_core import replay_chunked as ref_replay_chunked
from repro.uvm.simulator import UVMSimulator as RefSimulator
from repro_torch.traces.trace import ROOT_PAGES, Trace, make_records
from repro_torch.uvm import UVMConfig, UVMSimulator, VectorizedUVMSimulator
from repro_torch.uvm import golden as G
from repro_torch.uvm.prefetchers import Prefetcher, TreePrefetcher
from repro_torch.uvm.replay_core import (MAX_SPAN_PAGES, ReplayRequest,
                                         _TreeAdapter, replay_chunked)

CELLS = G.golden_cell_ids()


def assert_match(got, want, *, context, rel=1e-6):
    """Integer counters and the per-tenant accounting exact, the float
    accumulators within ``rel``."""
    got, want = G.stats_to_dict(got), G.stats_to_dict(want)
    for f in G.INT_FIELDS:
        assert got[f] == want[f], f"{context}: {f} {got[f]} != {want[f]}"
    for f in G.FLOAT_FIELDS:
        assert got[f] == pytest.approx(want[f], rel=rel, abs=1e-9), (
            f"{context}: {f} {got[f]} != {want[f]}")
    for f in ("tenant_hits", "tenant_accesses"):
        assert list(got.get(f) or []) == list(want.get(f) or []), (
            f"{context}: {f} {got.get(f)} != {want.get(f)}")


def check_golden_cell(cell_id):
    """One golden cell: the port's NumPy engine (strict checks on) against
    the reference's NumPy engine on the reference's cell and against the
    port's legacy engine."""
    trace, config, factory = G.golden_cell(cell_id)
    ref_trace, ref_config, ref_factory = R.golden_cell(cell_id)
    np.testing.assert_array_equal(trace.pages, ref_trace.pages)
    got = replay_chunked(ReplayRequest(trace, factory(), config,
                                       strict_checks=True))
    assert_match(got, ref_replay_chunked(RefRequest(
        ref_trace, ref_factory(), ref_config)),
        context=f"numpy vs the reference's numpy [{cell_id}]")
    assert_match(got, UVMSimulator(config).run(trace, factory()),
                 context=f"numpy vs legacy [{cell_id}]")
    assert VectorizedUVMSimulator(config).run(
        trace, factory()).backend == "numpy"


@pytest.mark.parametrize("cell_id", CELLS[0::2])
def test_numpy_engine_equals_the_reference_and_legacy(cell_id):
    check_golden_cell(cell_id)


def test_timeline_equivalence():
    """The (cycle, bytes) transfer timeline matches event for event, the
    legacy engine's and the reference's."""
    cell_id = "bicg-cluster/tree"
    trace, config, factory = G.golden_cell(cell_id)
    ref_trace, ref_config, ref_factory = R.golden_cell(cell_id)
    t_legacy = UVMSimulator(config, record_timeline=True).run(
        trace, factory()).timeline
    t_vec = VectorizedUVMSimulator(config, record_timeline=True).run(
        trace, factory()).timeline
    t_ref = ref_replay_chunked(RefRequest(ref_trace, ref_factory(),
                                          ref_config,
                                          record_timeline=True)).timeline
    assert t_vec.shape == t_legacy.shape == t_ref.shape
    assert len(t_vec) > 0
    np.testing.assert_allclose(t_vec, t_legacy, rtol=1e-9)
    np.testing.assert_allclose(t_vec, t_ref, rtol=1e-9)


def _mk_trace(pages, name="synth"):
    pages = np.asarray(pages, dtype=np.int64)
    recs = make_records(len(pages))
    recs["page"] = pages
    return Trace(name, recs, {}, {}, len(pages) * 100)


class _EveryOtherPrefetcher(Prefetcher):
    """Unknown subclass: must route to the legacy engine (it may emit pages
    outside the NumPy engine's dense page span)."""

    name = "every-other"

    def on_fault(self, index, page, resident):
        return [page + 1] if (page + 1) not in resident else []

    def on_access(self, index, page, resident, clock=0.0):
        q = page + 2
        if index % 2 == 0 and q not in resident:
            return [q]
        return []


def test_generic_prefetcher_fallback_is_exact():
    tr = _mk_trace(np.tile(np.arange(200), 4))
    st = VectorizedUVMSimulator(strict_checks=True).run(
        tr, _EveryOtherPrefetcher())
    assert st.backend == "legacy"
    assert_match(st, UVMSimulator().run(tr, _EveryOtherPrefetcher()),
                 rel=1e-9, context="generic fallback")


def test_huge_span_falls_back_to_legacy():
    tr = _mk_trace(np.array([0, MAX_SPAN_PAGES * 2, 0, 7], dtype=np.int64))
    st = VectorizedUVMSimulator().run(tr, TreePrefetcher())
    assert st.backend == "legacy"
    assert_match(st, UVMSimulator().run(tr, TreePrefetcher()), rel=1e-9,
                 context="span fallback")


def test_empty_trace():
    tr = _mk_trace(np.empty(0, dtype=np.int64))
    st = VectorizedUVMSimulator().run(tr, TreePrefetcher())
    assert st.backend == "numpy"
    assert st.n_accesses == 0 and st.cycles == 0.0 and st.faults == 0


@settings(max_examples=30, deadline=None, derandomize=True)
@given(st_.lists(
    st_.one_of(
        st_.tuples(st_.just("migrate"),
                   st_.lists(st_.integers(0, 2 * ROOT_PAGES - 1),
                             min_size=1, max_size=40, unique=True)),
        st_.tuples(st_.just("evict"), st_.integers(0, 2 * ROOT_PAGES - 1)),
        st_.tuples(st_.just("fault"), st_.integers(0, 2 * ROOT_PAGES - 1)),
    ), min_size=1, max_size=80))
def test_tree_adapter_matches_dict_counts(ops):
    """The dense per-level count arrays against the legacy dict on random
    migrate/evict/fault streams: node occupancy and the on_fault extras
    (pages and order) agree after every operation."""
    span = 2 * ROOT_PAGES
    arrival = np.full(span, np.inf)
    resident = set()
    legacy = TreePrefetcher()
    adapter = _TreeAdapter(TreePrefetcher(), arrival, 0)

    def _migrate(pages):
        for q in pages:
            resident.add(q)
            arrival[q] = 0.0
        legacy.on_migrate(list(pages))
        adapter.on_migrate(list(pages))

    for op in ops:
        if op[0] == "migrate":
            fresh = [q for q in op[1] if q not in resident]
            if fresh:
                _migrate(fresh)
        elif op[0] == "evict":
            q = op[1]
            if q in resident:
                resident.discard(q)
                arrival[q] = np.inf
                legacy.on_evict(q)
                adapter.on_evict(q)
        else:                            # fault, in the engine's order:
            q = op[1]                    # insert + migrate, then on_fault
            if q in resident:
                continue
            _migrate([q])
            want = legacy.on_fault(0, q, resident)
            got = adapter.on_fault(0, q, resident)
            assert [int(x) for x in got] == want
            if want:
                _migrate(want)           # the engine schedules the extras
        for lv in range(TreePrefetcher.LEVELS + 1):
            nz = {i: int(c) for i, c in enumerate(adapter.counts[lv]) if c}
            dic = {node: int(c) for (level, node), c in legacy.counts.items()
                   if level == lv and c}
            assert nz == dic, f"level {lv} counts diverged"


@settings(max_examples=25, deadline=None, derandomize=True)
@given(st_.lists(st_.integers(0, 600), min_size=20, max_size=300),
       st_.sampled_from(["none", "block", "tree", "learned",
                         "learned-cached", "learned-tf", "oracle"]),
       st_.sampled_from([None, 48, 200]))
def test_property_equivalence(pages, pf_name, cap):
    """Random traces under every golden prefetcher and three capacities:
    the port's NumPy engine equals the port's legacy engine and the
    reference's legacy engine."""
    tr = _mk_trace(pages)
    config = UVMConfig(device_pages=cap, mshr_entries=16)
    got = VectorizedUVMSimulator(config, strict_checks=True).run(
        tr, G.make_prefetcher(pf_name, tr, config))
    assert got.backend == "numpy"
    context = f"property [{pf_name} cap={cap}]"
    assert_match(got, UVMSimulator(config).run(
        tr, G.make_prefetcher(pf_name, tr, config)), rel=1e-9,
        context=context)
    ref_tr = RefTrace("synth", tr.accesses.copy(), {}, {}, tr.n_instructions)
    ref_config = RefConfig(device_pages=cap, mshr_entries=16)
    assert_match(got, RefSimulator(ref_config).run(
        ref_tr, R.make_prefetcher(pf_name, ref_tr, ref_config)), rel=1e-9,
        context=context)
