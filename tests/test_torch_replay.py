"""K1's host side and plain version against the reference's pins: the lru
golden cells of the demand and learned families (the mt-shared cells with
their per-tenant hits) replay through the port's ``cuda`` backend on the CPU
with exact integer counters and cycles/pcie_bytes within 1e-6 relative of
``tests/golden/uvm_golden.json``; random lane batches of every family and
policy match the reference's legacy engine; requests K1 cannot replay are
refused, never degraded.  The other golden cells are in
``test_torch_replay_{tree,oracle,policies}.py`` and ``test_torch_mt.py``
(the hard-quota cells), which share the helpers here."""
import dataclasses
import json
import os

import numpy as np
import pytest

pytest.importorskip("torch")
import torch

from repro.traces.trace import make_records
from repro.uvm import golden as R
from repro.uvm.simulator import UVMSimulator as RefSimulator
from repro_torch.kernels.lane_replay import MAX_LANE_STEPS, lane_replay
from repro_torch.traces.trace import Trace
from repro_torch.uvm import golden as G
from repro_torch.uvm import prefetchers as P
from repro_torch.uvm.backends.cuda_backend import (CudaReplayBackend,
                                                   decline_reason)
from repro_torch.uvm.config import UVMConfig
from repro_torch.uvm.replay_core import ReplayRequest, get_backend
from repro_torch.uvm.simulator import UVMSimulator

FIXTURE = os.path.join(os.path.dirname(__file__), "golden", "uvm_golden.json")
with open(FIXTURE) as _f:
    GOLDEN = json.load(_f)["cells"]


def golden_ids(prefetchers, policies=("lru", "random", "hotcold")):
    """Non-quota golden cell ids of ``prefetchers`` under ``policies``, from
    the port's copy of the golden matrix (``repro_torch.uvm.golden``)."""
    return [c for c in G.golden_cell_ids()
            if c.split("/")[1] in prefetchers
            and G.golden_cell_policy(c) in policies
            and not G.golden_cell(c)[1].tenant_pages]


def replay_golden(cell_ids):
    """Every cell through the backend in one call, so the cells pack into
    family- and policy-homogeneous lane batches as a sweep packs them."""
    requests = []
    for c in cell_ids:
        trace, config, factory = G.golden_cell(c)
        requests.append(ReplayRequest(trace, factory(), config))
    stats = get_backend("cuda", device="cpu").replay(requests)
    return dict(zip(cell_ids, stats))


def assert_golden(cell_id, stats):
    """Integer counters exact, cycles/pcie_bytes within 1e-6 relative, the
    per-tenant accounting exact."""
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


#: the lru cells of the demand and learned families (learned-tf: the
#: distance-16 predictions round-tripped through the prediction cache)
SLICE_PREFETCHERS = ("none", "block", "learned", "learned-tf")
CELLS = golden_ids(SLICE_PREFETCHERS, ("lru",))


@pytest.fixture(scope="module")
def golden_replay():
    return replay_golden(CELLS)


def test_slice_covers_the_lru_golden_cells():
    assert len(CELLS) == 24
    assert {c.split("/")[0] for c in CELLS} == {
        "atax", "pathfinder", "bicg-cluster", "oversub", "tree-churn",
        "mt-shared"}


@pytest.mark.parametrize("cell_id", CELLS)
def test_golden_cell_replays_exactly(cell_id, golden_replay):
    assert_golden(cell_id, golden_replay[cell_id])


def test_port_golden_matrix_is_the_reference_matrix():
    """The port's copy builds the reference's cases: the same accesses,
    configs and prefetcher inputs for every one of the 77 cells."""
    assert G.golden_cell_ids() == R.golden_cell_ids()
    assert sorted(GOLDEN) == sorted(G.golden_cell_ids())
    for mine, ref in zip(G.golden_cases(), R.golden_cases()):
        assert mine.name == ref.name
        assert np.array_equal(mine.trace.accesses, ref.trace.accesses)
        assert mine.trace.n_instructions == ref.trace.n_instructions
        assert (dataclasses.asdict(mine.config)
                == dataclasses.asdict(ref.config))
    for cell_id in G.golden_cell_ids():
        mine, ref = G.golden_cell(cell_id)[2](), R.golden_cell(cell_id)[2]()
        assert type(mine).__name__ == type(ref).__name__
        assert mine.extra_latency_cycles == ref.extra_latency_cycles
        for f in ("predicted_pages", "ft_pages", "ft_index"):
            if hasattr(ref, f):
                assert np.array_equal(getattr(mine, f), getattr(ref, f))


KINDS = ("none", "block", "tree", "learned", "oracle")
POLICIES = ("lru", "random", "hotcold")


def _random_lane(rng, combo):
    """A random trace over a few 2 MB regions with reuse, a random capacity
    and MSHR depth, and prefetcher x policy number ``combo`` of the 15."""
    n = int(rng.integers(300, 1500))
    base = int(rng.integers(0, 4)) * 4096 + 512 * int(rng.integers(0, 8))
    hot = rng.integers(0, 700, n)
    pages = np.where(rng.random(n) < 0.7, hot,
                     rng.integers(0, 3000, n)) + base
    recs = make_records(n)
    recs["page"] = pages
    recs["sm"] = np.arange(n) % 4
    trace = Trace(f"rand{combo}", recs, {}, {},
                  n * int(rng.integers(50, 400)))
    ws = len(np.unique(pages))
    cap = None if rng.random() < 0.3 else int(ws * rng.uniform(0.2, 0.9))
    cfg = UVMConfig(device_pages=cap,
                    mshr_entries=int(rng.choice([4, 16, 64])),
                    eviction=POLICIES[(combo // len(KINDS)) % len(POLICIES)])
    kind = KINDS[combo % len(KINDS)]
    if kind == "learned":
        preds = np.where(rng.random(n) < 0.8, np.roll(pages, -8), -1)
        preds[rng.random(n) < 0.1] += 40          # some wrong guesses

        def make(preds=preds, lat=float(rng.uniform(0, 3000))):
            return P.LearnedPrefetcher(preds, extra_latency_cycles=lat)
    elif kind == "oracle":
        def make(pages=pages, look=int(rng.choice([8, 96, 300]))):
            return P.OraclePrefetcher(pages, lookahead=look)
    else:
        make = {"none": P.NoPrefetcher, "block": P.BlockPrefetcher,
                "tree": P.TreePrefetcher}[kind]
    return trace, cfg, make


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_lane_batches_match_legacy(seed):
    """Seeds 0-3 run the 15 prefetcher x policy combinations at least once
    each (6 lanes a seed)."""
    rng = np.random.default_rng(seed)
    lanes = [_random_lane(rng, 6 * seed + i) for i in range(6)]
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


def _one_lane(prefetcher, n=64, **cfg):
    recs = make_records(n)
    recs["page"] = np.arange(n) % 4096
    return ReplayRequest(Trace("t", recs, {}, {}, 100 * n), prefetcher,
                         UVMConfig(**cfg))


@pytest.mark.parametrize("make,kw,why", [
    (lambda: _one_lane(P.NoPrefetcher()),
     {"step_bounds": np.ones(MAX_LANE_STEPS + 1, dtype=np.int64)},
     f"{MAX_LANE_STEPS + 1} step windows outside 1..{MAX_LANE_STEPS}"),
    (lambda: _one_lane(P.BlockPrefetcher()), {"record_timeline": True},
     "K1 records no per-transfer timeline"),
    (lambda: _one_lane(P.OraclePrefetcher(np.arange(64), lookahead=513)), {},
     "oracle lookahead 513 outside 1..512"),
    (lambda: _one_lane(P.TreePrefetcher(), n=(1 << 21) + 1), {},
     "trace length 2097153 outside 1..2097152"),
], ids=["step_bounds", "record_timeline", "oracle_lookahead", "tree_length"])
def test_requests_outside_the_slice_raise(make, kw, why):
    req = dataclasses.replace(make(), **kw)
    backend = CudaReplayBackend(device="cpu")
    assert not backend.can_replay(req)
    assert why in decline_reason(req)
    with pytest.raises(ValueError, match="cannot replay"):
        backend.replay([req])


def test_random_key_guard_raises():
    """The random victim key is (prio << 21) | slot: a span whose slots do
    not fit 21 bits is refused, never truncated."""
    pages = torch.zeros((1, 64), dtype=torch.int32)
    fparams = torch.ones((1, 8), dtype=torch.float64)
    iparams = torch.tensor([[64, 8, 16, 0, -1, 0, 2 ** 31 - 1, -1, -1]],
                           dtype=torch.int32)
    with pytest.raises(ValueError, match="random-policy victim key"):
        lane_replay(pages, None, fparams, iparams, 1 << 21, 17,
                    family="demand", policy="random")
    # the same span is fine for the other keys (checked before any work)
    with pytest.raises(ValueError, match="oracle lookahead"):
        lane_replay(pages, None, fparams, iparams, 1 << 21, 17,
                    family="oracle", policy="hotcold")


def test_quota_tenancy_is_refused():
    """Quotas K1 cannot honour are refused with the tenancy's reason (more
    quota than capacity, quotas on a single-tenant trace), never degraded;
    the golden hard-quota cells are in K1 (``test_torch_mt.py`` replays
    them)."""
    cell = next(c for c in G.golden_cell_ids() if c.startswith("mt-quota"))
    trace, config, _ = G.golden_cell(cell)
    assert decline_reason(ReplayRequest(trace, P.NoPrefetcher(),
                                        config)) is None
    over = dataclasses.replace(config, tenant_pages=(config.device_pages,
                                                     1))
    single = _one_lane(P.NoPrefetcher(), device_pages=100,
                       tenant_pages=(40, 40))
    backend = CudaReplayBackend(device="cpu")
    for req, why in ((ReplayRequest(trace, P.NoPrefetcher(), over),
                      "exceed device_pages"), (single, "not multi-tenant")):
        assert "invalid tenancy" in decline_reason(req)
        assert why in decline_reason(req)
        with pytest.raises(ValueError, match=why):
            backend.replay([req])


def test_lane_batches_are_family_homogeneous_and_bounded():
    backend = CudaReplayBackend(device="cpu")
    reqs = ([_one_lane(P.NoPrefetcher()) for _ in range(40)]
            + [_one_lane(P.LearnedPrefetcher(np.arange(64)))
               for _ in range(3)]
            + [_one_lane(P.NoPrefetcher(), eviction="hotcold")])
    batches = backend.pack_lanes(reqs)
    assert sorted(i for b in batches for i in b) == list(range(44))
    for b in batches:
        assert len(b) <= 32
        assert len({(type(reqs[i].prefetcher), reqs[i].config.eviction)
                    for i in b}) == 1
    batch = backend.pack_batch([reqs[40], reqs[41], reqs[42]])
    assert (batch.family, batch.policy) == ("learned", "lru")
    assert batch.pages.shape == batch.preds.shape == (4, 64)   # 2^k lanes
    assert batch.fparams.shape == (4, 8) and batch.iparams.shape == (4, 9)
    assert batch.ft is None and batch.pos is None
    assert batch.iparams[3, 0] == 0                 # padding lane: n = 0
    assert batch.span == 512 and batch.buf_len == 65
