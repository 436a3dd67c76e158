"""K1's host side and plain version against the reference's pins: the lru
golden cells of the demand and learned families (the mt-shared cells with
their per-tenant hits) replay through the port's ``cuda`` backend on the CPU
with exact integer counters and cycles/pcie_bytes within 1e-6 relative of
``tests/golden/uvm_golden.json``; random lane batches match the reference's
legacy engine; requests outside this slice are refused, never degraded."""
import dataclasses
import json
import os

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.traces.trace import make_records
from repro.uvm import golden as G
from repro.uvm.simulator import UVMSimulator as RefSimulator
from repro_torch.traces.trace import Trace
from repro_torch.uvm import prefetchers as P
from repro_torch.uvm.backends.cuda_backend import (CudaReplayBackend,
                                                   decline_reason)
from repro_torch.uvm.config import UVMConfig
from repro_torch.uvm.replay_core import ReplayRequest, get_backend
from repro_torch.uvm.simulator import UVMSimulator

FIXTURE = os.path.join(os.path.dirname(__file__), "golden", "uvm_golden.json")
with open(FIXTURE) as _f:
    GOLDEN = json.load(_f)["cells"]

#: prefetchers K1 replays in this slice (learned-tf: the distance-16
#: predictions round-tripped through the reference's prediction cache)
SLICE_PREFETCHERS = ("none", "block", "learned", "learned-tf")
CELLS = [c for c in G.golden_cell_ids()
         if G.golden_cell_policy(c) == "lru"
         and c.split("/")[1] in SLICE_PREFETCHERS
         and not G.golden_cell(c)[1].tenant_pages]


def _port_trace(trace) -> Trace:
    return Trace(trace.name, trace.accesses, dict(trace.array_bases),
                 dict(trace.array_pages), trace.n_instructions,
                 dict(trace.meta))


def _port_prefetcher(pf) -> P.Prefetcher:
    if type(pf).__name__ == "LearnedPrefetcher":
        return P.LearnedPrefetcher(np.asarray(pf.predicted_pages),
                                   pf.extra_latency_cycles, pf.prefetch_block)
    return getattr(P, type(pf).__name__)()


def _port_request(cell_id) -> ReplayRequest:
    trace, config, factory = G.golden_cell(cell_id)
    return ReplayRequest(_port_trace(trace), _port_prefetcher(factory()),
                         UVMConfig(**dataclasses.asdict(config)))


@pytest.fixture(scope="module")
def golden_replay():
    """Every slice cell through the backend in one call, so the cells pack
    into family-homogeneous lane batches as a sweep packs them."""
    backend = get_backend("cuda", device="cpu")
    requests = [_port_request(c) for c in CELLS]
    assert len(backend.pack_lanes(requests)) >= 2   # demand and learned
    return dict(zip(CELLS, backend.replay(requests)))


def test_slice_covers_the_lru_golden_cells():
    assert len(CELLS) == 24
    assert {c.split("/")[0] for c in CELLS} == {
        "atax", "pathfinder", "bicg-cluster", "oversub", "tree-churn",
        "mt-shared"}


@pytest.mark.parametrize("cell_id", CELLS)
def test_golden_cell_replays_exactly(cell_id, golden_replay):
    stats = golden_replay[cell_id]
    assert stats.backend == "cuda"
    got, want = G.stats_to_dict(stats), GOLDEN[cell_id]
    for f in G.INT_FIELDS:
        assert got[f] == want[f], f"{cell_id}: {f} {got[f]} != {want[f]}"
    for f in G.FLOAT_FIELDS:
        assert got[f] == pytest.approx(want[f], rel=1e-6, abs=1e-9), (
            f"{cell_id}: {f} {got[f]} != {want[f]}")
    for f in ("tenant_hits", "tenant_accesses"):
        assert list(got.get(f) or []) == list(want.get(f) or []), (
            f"{cell_id}: {f} {got.get(f)} != {want.get(f)}")


def _random_lane(rng, lane):
    """A random trace over a few 2 MB regions with reuse, a random capacity
    and MSHR depth, and a random prefetcher of the slice."""
    n = int(rng.integers(300, 1500))
    base = int(rng.integers(0, 4)) * 4096 + 512 * int(rng.integers(0, 8))
    hot = rng.integers(0, 700, n)
    pages = np.where(rng.random(n) < 0.7, hot,
                     rng.integers(0, 3000, n)) + base
    recs = make_records(n)
    recs["page"] = pages
    recs["sm"] = np.arange(n) % 4
    trace = Trace(f"rand{lane}", recs, {}, {}, n * int(rng.integers(50, 400)))
    ws = len(np.unique(pages))
    cap = None if rng.random() < 0.3 else int(ws * rng.uniform(0.2, 0.9))
    cfg = UVMConfig(device_pages=cap,
                    mshr_entries=int(rng.choice([4, 16, 64])))
    kind = ["none", "block", "learned"][lane % 3]
    if kind == "learned":
        preds = np.where(rng.random(n) < 0.8, np.roll(pages, -8), -1)
        preds[rng.random(n) < 0.1] += 40          # some wrong guesses

        def make(preds=preds, lat=float(rng.uniform(0, 3000))):
            return P.LearnedPrefetcher(preds, extra_latency_cycles=lat)
    else:
        make = P.NoPrefetcher if kind == "none" else P.BlockPrefetcher
    return trace, cfg, make


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_lane_batches_match_legacy(seed):
    rng = np.random.default_rng(seed)
    lanes = [_random_lane(rng, i) for i in range(6)]
    backend = get_backend("cuda", device="cpu")
    stats = backend.replay([ReplayRequest(t, make(), c)
                            for t, c, make in lanes])
    for (trace, cfg, make), got in zip(lanes, stats):
        want = UVMSimulator(cfg).run(trace, make())
        # the port's legacy copy is the reference's loop
        ref = RefSimulator(cfg).run(trace, make())
        assert G.stats_to_dict(want) == G.stats_to_dict(ref)
        g, w = G.stats_to_dict(got), G.stats_to_dict(want)
        for f in G.INT_FIELDS:
            assert g[f] == w[f], f"{trace.name}: {f} {g[f]} != {w[f]}"
        for f in G.FLOAT_FIELDS:
            assert g[f] == pytest.approx(w[f], rel=1e-6, abs=1e-9), f


def _one_lane(prefetcher, **cfg):
    recs = make_records(64)
    recs["page"] = np.arange(64)
    return ReplayRequest(Trace("t", recs, {}, {}, 6400), prefetcher,
                         UVMConfig(**cfg))


@pytest.mark.parametrize("prefetcher,cfg,why", [
    (P.TreePrefetcher(), {}, "tree lanes are a later slice"),
    (P.OraclePrefetcher(np.arange(64)), {}, "oracle lanes are a later slice"),
    (P.NoPrefetcher(), {"eviction": "random", "device_pages": 8},
     "eviction='random' is a later slice"),
    (P.BlockPrefetcher(), {"eviction": "hotcold", "device_pages": 8},
     "eviction='hotcold' is a later slice"),
])
def test_requests_outside_the_slice_raise(prefetcher, cfg, why):
    req = _one_lane(prefetcher, **cfg)
    backend = CudaReplayBackend(device="cpu")
    assert not backend.can_replay(req)
    assert why in decline_reason(req)
    with pytest.raises(ValueError, match="later slice"):
        backend.replay([req])


def test_quota_tenancy_is_refused():
    cell = next(c for c in G.golden_cell_ids() if c.startswith("mt-quota"))
    trace, config, _ = G.golden_cell(cell)
    req = ReplayRequest(_port_trace(trace), P.NoPrefetcher(),
                        UVMConfig(**{**dataclasses.asdict(config),
                                     "eviction": "lru"}))
    assert "quotas" in decline_reason(req)


def test_lane_batches_are_family_homogeneous_and_bounded():
    backend = CudaReplayBackend(device="cpu")
    reqs = ([_one_lane(P.NoPrefetcher()) for _ in range(40)]
            + [_one_lane(P.LearnedPrefetcher(np.arange(64)))
               for _ in range(3)])
    batches = backend.pack_lanes(reqs)
    assert sorted(i for b in batches for i in b) == list(range(43))
    for b in batches:
        assert len(b) <= 32
        assert len({type(reqs[i].prefetcher) for i in b}) == 1
    pages, preds, fparams, iparams, span, buf_len = backend.pack_batch(
        [reqs[40], reqs[41], reqs[42]])
    assert pages.shape == preds.shape == (4, 64)     # lanes padded to 2^k
    assert fparams.shape == (4, 8) and iparams.shape == (4, 9)
    assert iparams[3, 0] == 0                       # padding lane: n = 0
    assert span == 512 and buf_len == 65
