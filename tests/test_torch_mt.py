"""The multi-tenant scenarios on the port, on the CPU: the port's interleaved
traces are the reference's, K1's tenant quotas (its plain version) replay the
7 ``mt-quota`` golden cells exactly and equal the reference's legacy engine
on random two-tenant lanes, the isolation property holds, the tenants' solo
replays run as K1 lanes, and the ``mt-smoke`` rows equal the reference
sweep's ``backend="numpy"`` rows.  Mirrors ``tests/test_multitenant.py``."""
import types

import numpy as np
import pytest

pytest.importorskip("torch")

from test_torch_replay import assert_golden, replay_golden

from repro.traces import interleave as ref_il
from repro.traces.trace import Trace as RefTrace
from repro.uvm import UVMConfig as RefConfig
from repro.uvm import sweep as ref_sweep
from repro.uvm.golden import make_prefetcher as ref_make_prefetcher
from repro.uvm.simulator import UVMSimulator as RefSimulator
from repro_torch.traces import interleave as il
from repro_torch.traces.trace import ROOT_PAGES, Trace, make_records
from repro_torch.uvm import golden as G
from repro_torch.uvm import sweep
from repro_torch.uvm.backends.cuda_backend import (CudaReplayBackend,
                                                   decline_reason)
from repro_torch.uvm.config import UVMConfig
from repro_torch.uvm.prefetchers import NoPrefetcher
from repro_torch.uvm.replay_core import ReplayRequest, get_backend
from repro_torch.uvm.scenarios import MT_BENCHES, expand_scenario

COUNTERS = ("n_accesses", "hits", "late", "faults", "prefetch_issued",
            "prefetch_used", "pages_migrated", "pages_evicted")


@pytest.mark.parametrize("pair", MT_BENCHES)
def test_mt_trace_is_the_reference_trace(pair):
    """The same interleaved accesses and sidecar, the same tenants' last
    accesses (the completion clocks' bounds) and solo traces."""
    mine = il.build_mt_trace(pair, scale=0.25)
    ref = ref_il.build_mt_trace(pair, scale=0.25)
    assert np.array_equal(mine.accesses, ref.accesses)
    assert mine.meta == ref.meta and mine.name == ref.name
    assert (mine.array_bases, mine.array_pages, mine.n_instructions) == (
        ref.array_bases, ref.array_pages, ref.n_instructions)
    mine, _ = mine.split(0.6)
    ref, _ = ref.split(0.6)
    assert il.tenant_last_index(mine) == ref_il.tenant_last_index(ref)
    assert np.array_equal(sweep._mt_step_bounds(mine),
                          ref_sweep._mt_step_bounds(ref))
    for t in range(il.N_TENANTS):
        a, b = il.mt_component_trace(mine, t), ref_il.mt_component_trace(
            ref, t)
        assert np.array_equal(a.accesses, b.accesses)
        assert (a.name, a.n_instructions, a.meta) == (
            b.name, b.n_instructions, b.meta)


QUOTA_CELLS = [c for c in G.golden_cell_ids() if c.startswith("mt-quota/")]


@pytest.fixture(scope="module")
def quota_replay():
    return replay_golden(QUOTA_CELLS)


@pytest.mark.parametrize("cell_id", QUOTA_CELLS)
def test_quota_golden_cell_replays_exactly(cell_id, quota_replay):
    """Counters, cycles and the per-tenant hits of the hard-quota cells
    (40%/40% with a 20% spill pool, hotcold) as the fixture pins them."""
    assert len(QUOTA_CELLS) == 7
    assert_golden(cell_id, quota_replay[cell_id])


def _two_tenant(pages0, pages1, boundary, name="mt-synth"):
    """A two-tenant trace: tenant 1's pages rebased above ``boundary``,
    the streams merged clock-proportionally (the interleaver's key
    arithmetic)."""
    pages0 = np.asarray(pages0, dtype=np.int64)
    pages1 = np.asarray(pages1, dtype=np.int64) + boundary
    na, nb = len(pages0), len(pages1)
    keys = np.concatenate([np.arange(1, na + 1, dtype=np.int64) * nb,
                           np.arange(1, nb + 1, dtype=np.int64) * na])
    order = np.argsort(keys, kind="stable")
    recs = make_records(na + nb)
    recs["page"] = np.concatenate([pages0, pages1])[order]
    recs["sm"] = np.arange(na + nb) % 4
    return Trace(name, recs, {}, {}, (na + nb) * 100,
                 meta={"mt": {"benches": ["A", "B"], "tenants": 2,
                              "boundary": int(boundary)}})


def _as_ref(trace):
    return RefTrace(trace.name, trace.accesses, trace.array_bases,
                    trace.array_pages, trace.n_instructions, meta=trace.meta)


BOUNDARY = 2 * ROOT_PAGES
IDLE = np.arange(10, dtype=np.int64)
THRASH = np.tile(np.arange(600, dtype=np.int64), 2)


def _protected_run(co_pages, tenant_pages, eviction="lru"):
    pages0 = np.tile(np.arange(200, dtype=np.int64), 5)   # 1000 accesses
    trace = _two_tenant(pages0, co_pages, BOUNDARY)
    cfg = UVMConfig(device_pages=400, tenant_pages=tenant_pages,
                    eviction=eviction)
    return get_backend("cuda", device="cpu").replay(
        [ReplayRequest(trace, NoPrefetcher(), cfg)])[0]


@pytest.mark.parametrize("eviction", ["lru", "random", "hotcold"])
def test_quota_isolates_protected_tenant(eviction):
    """Tenant 0's 200 pages fit its 250-page quota: its hit count is the
    same whether tenant 1 idles or thrashes 600 pages through its 100-page
    quota and the 50-page spill pool."""
    idle = _protected_run(IDLE, (250, 100), eviction)
    thrash = _protected_run(THRASH, (250, 100), eviction)
    assert idle.backend == thrash.backend == "cuda"
    assert idle.tenant_accesses[0] == thrash.tenant_accesses[0] == 1000
    assert idle.tenant_hits[0] == thrash.tenant_hits[0] == 1000 - 200
    assert thrash.pages_evicted > 0


def test_shared_capacity_control_shows_interference():
    idle = _protected_run(IDLE, None)
    thrash = _protected_run(THRASH, None)
    assert idle.tenant_hits[0] == 1000 - 200
    assert thrash.tenant_hits[0] < idle.tenant_hits[0]


def _random_mt_lane(rng, pf_name, policy):
    """A random two-tenant trace (either tenant may be absent from the
    replayed slice, so the dense boundary can fall outside the lane's
    span), random quotas and a spill pool, clocked at the tenants' last
    accesses.  Tree lanes are shorter: each fault brings a 2 MB root window
    into quotas of a few hundred pages, so they evict hundreds of pages per
    access."""
    top = 150 if pf_name == "tree" else 500
    n0, n1 = (int(rng.integers(0, top)) for _ in range(2))
    n0 = n0 if n0 + n1 else 300
    boundary = int(rng.integers(2, 6)) * ROOT_PAGES
    pages0 = rng.integers(0, min(boundary, 1500), n0)
    pages1 = np.where(rng.random(n1) < 0.6, rng.integers(0, 300, n1),
                      rng.integers(0, 2500, n1))
    trace = _two_tenant(pages0, pages1, boundary, name=f"mt-{pf_name}")
    cap = int(trace.working_set_pages * rng.uniform(0.3, 0.9))
    q0 = int(cap * rng.uniform(0.1, 0.6))
    q1 = int((cap - q0) * rng.uniform(0.3, 1.0))
    cfg = dict(device_pages=cap, tenant_pages=(q0, q1), eviction=policy,
               mshr_entries=int(rng.choice([4, 16, 64])))
    return trace, cfg, sweep._mt_step_bounds(trace)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_quota_lanes_match_the_reference(seed):
    """Every prefetcher x policy on random quota lanes, with the tenants'
    completion clocks: counters, tenant hits and clocks equal the
    reference's legacy engine."""
    rng = np.random.default_rng(seed)
    lanes, reqs = [], []
    for pf in ("none", "block", "tree", "learned", "oracle"):
        for policy in ("lru", "random", "hotcold"):
            trace, kw, bounds = _random_mt_lane(rng, pf, policy)
            cfg = UVMConfig(**kw)
            lanes.append((trace, kw, bounds, pf))
            reqs.append(ReplayRequest(trace, G.make_prefetcher(pf, trace,
                                                               cfg),
                                      cfg, step_bounds=bounds))
    assert all(decline_reason(r) is None for r in reqs)
    got = get_backend("cuda", device="cpu").replay(reqs)
    for (trace, kw, bounds, pf), st in zip(lanes, got):
        ref_trace, ref_cfg = _as_ref(trace), RefConfig(**kw)
        want = RefSimulator(ref_cfg).run(
            ref_trace, ref_make_prefetcher(pf, ref_trace, ref_cfg),
            step_bounds=bounds)
        for f in COUNTERS:
            assert getattr(st, f) == getattr(want, f), (pf, f)
        assert st.cycles == want.cycles and st.pcie_bytes == want.pcie_bytes
        assert tuple(st.tenant_hits) == tuple(want.tenant_hits)
        assert tuple(st.tenant_accesses) == tuple(want.tenant_accesses)
        if bounds is not None and bounds.size:
            assert np.array_equal(st.step_clocks, want.step_clocks)


def test_solo_replays_run_as_k1_lanes(monkeypatch):
    """The slowdown columns' solo replays join the sweep's lane batches:
    one K1 lane per distinct (tenant, capacity, prefetcher, policy), shared
    by the cells that need it; a learned solo lane trains on its tenant's
    solo trace."""
    cells = [sweep.SweepCell("ATAX+Pathfinder", pf, scale=0.1,
                             device_frac=0.75, capacity_split=split,
                             eviction="random", service_steps=5)
             for pf in ("none", "learned") for split in ("shared", "0.5/0.5")]
    lanes, batches = [], []
    replay_batch = CudaReplayBackend._replay_batch

    def counted(self, requests):
        lanes.extend(requests)
        batches.append(len(requests))
        return replay_batch(self, requests)
    monkeypatch.setattr(CudaReplayBackend, "_replay_batch", counted)
    # every lane batch's replay reads the sweep's clock twice: with a clock
    # that ticks one second a read, each batch takes one second
    ticks = iter(range(10 ** 6))
    monkeypatch.setattr(sweep, "time", types.SimpleNamespace(
        perf_counter=lambda: float(next(ticks))))
    rows = sweep.run_sweep(cells + cells[:1], device="cpu")
    # per prefetcher: each tenant alone on the whole device and on half
    assert len(lanes) == len(cells) + 1 + 2 * 2 * 2
    assert sum("@t" in r.trace.name for r in lanes) == 2 * 2 * 2
    assert rows[-1] == dict(rows[0], seconds=rows[-1]["seconds"])
    # the rows' seconds, their solo replays' shares included, add up to the
    # sweep's replay time
    assert sum(r["seconds"] for r in rows) == pytest.approx(len(batches))
    for cell, row in zip(cells, rows):
        assert row["capacity_split"] == cell.capacity_split
        assert row["interference_slowdown"] == max(row["slowdown_t0"],
                                                   row["slowdown_t1"])
    assert rows[2]["train_seconds"] > 0.0     # mix and solo fits
    ref = ref_sweep.simulate_cell(ref_sweep.SweepCell(
        "ATAX+Pathfinder", "none", scale=0.1, device_frac=0.75,
        capacity_split="0.5/0.5", eviction="random", backend="numpy"))
    assert (rows[1]["tenants"], rows[1]["capacity_split"]) == (
        ref["tenants"], ref["capacity_split"])
    for f in sweep.MT_FIELDS[2:]:
        assert rows[1][f] == pytest.approx(ref[f], rel=1e-6), f


#: the mt-smoke cells held here (6 of its 36; the whole grid takes minutes
#: through the plain version): ratio 0.5, each capacity split under one
#: policy, so all three splits, all three policies and both prefetchers
MT_SMOKE_SUBSET = {("shared", "lru"), ("0.5/0.5", "random"),
                   ("0.4/0.4", "hotcold")}


def test_mt_smoke_equals_the_reference_numpy_rows():
    """ATAX+Pathfinder at scale 0.25 x ratio 0.5 x (shared, lru),
    (0.5/0.5, random), (0.4/0.4, hotcold) x none and tree."""
    def subset(cells):
        return [c for c in cells if c.device_frac == 0.5
                and (c.capacity_split, c.eviction) in MT_SMOKE_SUBSET]
    ref = ref_sweep.run_sweep(subset(expand_scenario("mt-smoke",
                                                     backend="numpy")))
    got = sweep.run_sweep(subset(expand_scenario("mt-smoke")), device="cpu")
    assert len(got) == len(ref) == 6
    assert {(r["capacity_split"], r["eviction"], r["prefetcher"])
            for r in got} == {(s, e, p) for s, e in MT_SMOKE_SUBSET
                              for p in ("none", "tree")}
    for r, g in zip(ref, got):
        assert g["backend"] == "cuda" and r["backend"] == "numpy"
        for f in ("bench", "prefetcher", "device_frac", "eviction",
                  "capacity_split", "tenants", "device_pages", *COUNTERS):
            assert g[f] == r[f], (r["prefetcher"], f)
        for f in ("cycles", "pcie_bytes", "hit_rate", "hit_rate_t0",
                  "hit_rate_t1", "slowdown_t0", "slowdown_t1",
                  "interference_slowdown"):
            assert g[f] == pytest.approx(r[f], rel=1e-6), (r["prefetcher"],
                                                           f)
        assert g["slo_source"] is None
