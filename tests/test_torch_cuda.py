"""The port's kernels on the card: K1 replays the 77 golden cells of every
lane family and eviction policy exactly (the hard-quota cells included) and
matches its plain version, its step-clock and quota lanes equal the legacy
engine, the paper's Table 10/11 tree rows equal the legacy engine's, K2-K4
match their plain versions (K3 and K4 also at the edges of each of their
variants and tilings, K2-K4 at the predictor tables' shapes), the
predictor's inference goes through K2-K4, the other archs' inference
agrees with the CPU, and each request K1 declines replays on the NumPy
engine without a launch, equal to the legacy engine.  The crash-safety
plane runs on the card too: ``chaos-smoke`` on K1 converges, a lease pool
spawned from a CUDA process trains once per trace, and two processes
asking for one prediction key train it once.  The LM zoo trains on the
card as on the CPU (train steps, a checkpoint round trip, the gradient
compressors at full width).
Every test here needs a CUDA device and nvcc (a CUDA kernel has no CPU
mode) and skips without one.  The module imports neither jax nor the
reference package, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import copy
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch
from repro_torch.core import families
from repro_torch.core.model import Predictor
from repro_torch.core.vocab import FEATURE_BUCKETS
from repro_torch.core.quantize import pack_int4_like_fake_quant
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain,
                                                 flash_geometry)
from repro_torch.kernels.hlsh_attention import (hlsh_attention,
                                                hlsh_attention_plain,
                                                hlsh_geometry)
from repro_torch.kernels.int4_matmul import (int4_matmul, int4_matmul_plain,
                                             int4_variant)
from repro_torch.kernels.lane_replay import (FAMILIES, POLICIES, ROOT_PAGES,
                                             lane_replay, lane_replay_plain)
from repro_torch.models import builder as lm
from repro_torch.uvm import golden as G
from repro_torch.uvm import paper_tables, sweep
from repro_torch.offload.serve_trace import (build_serve_trace,
                                             trace_step_bounds)
from repro_torch.traces.interleave import build_mt_trace
from repro_torch.uvm.backends.cuda_backend import CudaReplayBackend
from repro_torch.uvm.config import UVMConfig
from repro_torch.uvm.prefetchers import (BlockPrefetcher, NoPrefetcher,
                                         OraclePrefetcher, TreePrefetcher)
from repro_torch.uvm.replay_core import ReplayRequest, get_backend
from repro_torch.uvm.simulator import UVMSimulator

pytestmark = pytest.mark.cuda

FIXTURE = os.path.join(os.path.dirname(__file__), "golden", "uvm_golden.json")


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 and K2 are CUDA kernels with no "
                    "CPU mode (their plain versions are tested on the CPU)")
    return "cuda"


def test_k1_replays_the_golden_cells_exactly(device):
    """The 77 golden cells: every lane family under lru, random and
    hotcold, and the hard-quota cells, in one backend call (so they pack as
    a sweep packs)."""
    with open(FIXTURE) as f:
        golden = json.load(f)["cells"]
    ids = G.golden_cell_ids()
    assert len(ids) == 77
    requests = []
    for cell_id in ids:
        trace, cfg, factory = G.golden_cell(cell_id)
        requests.append(ReplayRequest(trace, factory(), cfg))
    launches = lane_replay.launches
    stats = get_backend("cuda", device).replay(requests)
    assert lane_replay.launches > launches
    for cell_id, st in zip(ids, stats):
        want = golden[cell_id]
        assert st.backend == "cuda"
        for f in G.INT_FIELDS:
            assert getattr(st, f) == want[f], (cell_id, f)
        for f in ("cycles", "pcie_bytes"):
            assert getattr(st, f) == pytest.approx(want[f], rel=1e-6), (
                cell_id, f)
        if "tenant_hits" in want:
            assert list(st.tenant_hits) == want["tenant_hits"], cell_id


#: the golden prefetcher of each lane family
FAMILY_PREFETCHER = {"demand": "block", "tree": "tree", "learned": "learned",
                     "oracle": "oracle"}


def _variant_lanes(trace, family, policy, bounds=None, quotas=None):
    """Two lanes of ``trace`` at half and three quarters of its working
    set (with step ``bounds``; with hard ``quotas`` fractions)."""
    reqs = []
    for frac in (0.5, 0.75):
        cap = int(trace.working_set_pages * frac)
        tp = None if quotas is None else tuple(int(q * cap) for q in quotas)
        cfg = UVMConfig(device_pages=cap, eviction=policy, tenant_pages=tp)
        pf = G.make_prefetcher(FAMILY_PREFETCHER[family], trace, cfg)
        reqs.append(ReplayRequest(trace, pf, cfg, step_bounds=bounds))
    return reqs


def _k1_equals_plain_and_legacy(device, reqs):
    backend = CudaReplayBackend(device)
    batch = backend.pack_batch(reqs)
    got = lane_replay(**batch.kernel_args(device))
    cpu = batch.kernel_args("cpu")
    cpu.pop("buf_len")
    want = lane_replay_plain(**cpu)
    if batch.steps_len:
        assert torch.equal(got[1].cpu(), want[1])
        got, want = got[0], want[0]
    assert torch.equal(got.cpu(), want)
    for req, st in zip(reqs, backend.replay(reqs)):
        ref = UVMSimulator(req.config).run(
            req.trace, G.make_prefetcher(
                FAMILY_PREFETCHER[batch.family], req.trace, req.config),
            step_bounds=req.step_bounds)
        assert G.stats_to_dict(st) == G.stats_to_dict(ref)
        if req.step_bounds is not None:
            assert np.array_equal(st.step_clocks, ref.step_clocks)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("policy", POLICIES)
def test_k1_step_clocks_match_plain_and_legacy(device, family, policy):
    """Step-clock lanes on ServeBursty@r8 at scale 0.25 (622 of its 762
    windows are empty): window clocks bit for bit."""
    trace = build_serve_trace("ServeBursty@r8", scale=0.25)
    _k1_equals_plain_and_legacy(device, _variant_lanes(
        trace, family, policy, bounds=trace_step_bounds(trace)))


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("policy", POLICIES)
def test_k1_quota_lanes_match_plain_and_legacy(device, family, policy):
    """Quota lanes (0.4/0.4 of the capacity, a 20% spill pool) on the
    ATAX+Pathfinder interleave at scale 0.25, clocked at each tenant's last
    access as the sweep clocks them."""
    trace = build_mt_trace("ATAX+Pathfinder", scale=0.25)
    _k1_equals_plain_and_legacy(device, _variant_lanes(
        trace, family, policy, bounds=sweep._mt_step_bounds(trace),
        quotas=(0.4, 0.4)))


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("policy", POLICIES)
def test_k1_matches_its_plain_version(device, family, policy):
    rng = np.random.default_rng(FAMILIES.index(family))
    n_lanes, t_max, span = 4, 2048, 4096
    pages = rng.integers(0, 3000, (n_lanes, t_max)).astype(np.int32)
    preds = np.where(rng.random((n_lanes, t_max)) < 0.7,
                     np.roll(pages, -8, axis=1), -1).astype(np.int32)
    fparams = np.tile(np.array([1400.2, 384.9, 66645.0, 100.0, 100.0, 600.0,
                                1481.0, 4096.0]), (n_lanes, 1))
    iparams = np.tile(np.array([t_max, 900, 16, 1, -1, 0, 2 ** 31 - 1, -1,
                                -1], dtype=np.int32), (n_lanes, 1))
    iparams[1, 1] = -1                      # one uncapped lane
    iparams[2, 0] = 1000                    # one short lane
    iparams[3, 0] = 0                       # one padding lane
    iparams[:, 3] = family in ("demand", "learned")
    iparams[:, 5] = 12345                   # lane lo of the random draws
    kw = {"family": family, "policy": policy}
    args = [torch.as_tensor(a) for a in (pages, preds, fparams, iparams)]
    if family == "oracle":
        # first-touch stream of each lane, padded with the trash slot
        ft = np.full((n_lanes, 3072 + 96), span, dtype=np.int32)
        pos = np.zeros((n_lanes, t_max), dtype=np.int32)
        for lane in range(n_lanes):
            uniq, first = np.unique(pages[lane], return_index=True)
            order = np.sort(first)
            ft[lane, :len(order)] = pages[lane][order]
            pos[lane] = np.searchsorted(order, np.arange(t_max), side="right")
            iparams[lane, 4] = len(order)
        kw.update(ft=torch.as_tensor(ft), pos=torch.as_tensor(pos),
                  lookahead=96)
    if family != "learned":
        args[1] = None
    want = lane_replay_plain(*args, span, **kw)
    dev_kw = {k: (v.to(device) if torch.is_tensor(v) else v)
              for k, v in kw.items()}
    got = lane_replay(*(None if a is None else a.to(device) for a in args),
                      span, 17, **dev_kw).cpu()
    assert torch.equal(got, want)
    assert got[3].abs().sum() == 0


def _random_lanes(family, seed, span, pages_hi, cap, tenants=None,
                  runs=False):
    """Three lanes of uniform random pages below ``pages_hi`` (a fourth,
    padding lane replays nothing) at capacity ``cap``; ``tenants`` =
    (boundary, q0, q1) makes them quota lanes; ``runs`` makes each lane
    sequential runs of 64-1023 pages from random starts instead.  Returns
    the positional arguments and keywords of ``lane_replay_plain``."""
    rng = np.random.default_rng(seed)
    n_lanes, t_max = 4, 2048
    if runs:
        pages = np.empty((n_lanes, t_max), dtype=np.int32)
        for lane in range(n_lanes):
            seq, n = [], 0
            while n < t_max:
                start, length = rng.integers(0, pages_hi), rng.integers(64, 1024)
                seq.append((start + 8 * np.arange(length)) % pages_hi)
                n += length
            pages[lane] = np.concatenate(seq)[:t_max]
    else:
        pages = rng.integers(0, pages_hi, (n_lanes, t_max)).astype(np.int32)
    preds = np.where(rng.random((n_lanes, t_max)) < 0.7,
                     np.roll(pages, -8, axis=1), -1).astype(np.int32)
    fparams = np.tile(np.array([1400.2, 384.9, 66645.0, 100.0, 100.0, 600.0,
                                1481.0, 4096.0]), (n_lanes, 1))
    iparams = np.tile(np.array([t_max, cap, 16, 1, -1, 12345, 2 ** 31 - 1,
                                -1, -1], dtype=np.int32), (n_lanes, 1))
    iparams[2, 0] = 1000                    # one short lane
    iparams[3, 0] = 0                       # one padding lane
    iparams[:, 3] = family in ("demand", "learned")
    if tenants is not None:
        iparams[:, 6:9] = tenants
    kw = {"family": family, "quotas": tenants is not None}
    if family == "oracle":
        ft = np.full((n_lanes, t_max + 64), span, dtype=np.int32)
        pos = np.zeros((n_lanes, t_max), dtype=np.int32)
        for lane in range(n_lanes):
            _, first = np.unique(pages[lane], return_index=True)
            order = np.sort(first)
            ft[lane, :len(order)] = pages[lane][order]
            pos[lane] = np.searchsorted(order, np.arange(t_max), side="right")
            iparams[lane, 4] = len(order)
        kw.update(ft=torch.as_tensor(ft), pos=torch.as_tensor(pos),
                  lookahead=64)
    args = [torch.as_tensor(pages),
            torch.as_tensor(preds) if family == "learned" else None,
            torch.as_tensor(fparams), torch.as_tensor(iparams), span]
    return args, kw


#: K1's victim search and selection rounds at their edges: a span that is
#: no multiple of the 512-slot chunks (3,008 pages: whole 16-page blocks,
#: so every family but the tree's, whose faults fill whole root windows);
#: quota lanes whose tenant boundary is a chunk edge (1024); a capacity of
#: 2 pages, so that most bursts end at an in-flight victim (the page that
#: just faulted, or its prefetched extras); hotcold's random retouches tie
#: in freq throughout; and bursts: sequential runs over 16 root windows at
#: a quarter of them resident, so that a tree fault's escalation brings in
#: up to a root window and evicts hundreds of pages in one round, some
#: stopped midway by an in-flight victim
K1_SEARCH_CASES = {
    "span-3008": dict(span=3008, pages_hi=3008, cap=900),
    "quota-edge": dict(span=4096, pages_hi=3000, cap=900,
                       tenants=(1024, 400, 400)),
    "in-flight": dict(span=1024, pages_hi=1024, cap=2),
    "burst": dict(span=4096, pages_hi=4096, cap=900, runs=True),
}


@pytest.mark.parametrize("case,family", [
    (c, f) for c in sorted(K1_SEARCH_CASES) for f in FAMILIES
    if K1_SEARCH_CASES[c]["span"] % ROOT_PAGES == 0 or f != "tree"])
@pytest.mark.parametrize("policy", POLICIES)
def test_k1_victim_search_edges_match_its_plain_version(device, case,
                                                        family, policy):
    """Every victim K1's chunk search or selection round picks is the plain
    version's argmin over the span: the stats are equal, each lane scanned
    at least one chunk per eviction its rounds did not make, and its rounds
    made at most its evictions."""
    args, kw = _random_lanes(family, FAMILIES.index(family),
                             **K1_SEARCH_CASES[case])
    want = lane_replay_plain(*args, policy=policy, **kw)
    dev = [a.to(device) if torch.is_tensor(a) else a for a in args]
    dev_kw = {k: (v.to(device) if torch.is_tensor(v) else v)
              for k, v in kw.items()}
    info = torch.zeros((4, 4), dtype=torch.int64, device=device)
    got = lane_replay(*dev, 17, policy=policy, lane_info=info, **dev_kw)
    assert torch.equal(got.cpu(), want)
    evictions = want[:, 7].long()
    assert evictions[:3].min() > 0
    info = info.cpu()
    scans, round_evictions = info[:, 0], info[:, 3]
    assert (scans >= evictions - round_evictions).all()
    assert ((0 <= round_evictions) & (round_evictions <= evictions)).all()
    assert (info[:3, 1] > 0).all()
    if case == "burst" and family == "tree":
        assert (info[:3, 2] > 0).all() and (round_evictions[:3] > 0).all()


#: golden tree lanes under lru: three, so the batch has a padding lane
K1_TRACED_CELLS = ("atax/tree", "oversub/tree", "tree-churn/tree")


def test_k1_lane_info_fills_a_traced_pass(device, monkeypatch):
    """Under a profiler, ``_replay_batch`` hands K1 a ``lane_info`` and
    counts the real lanes' accesses, chunk scans and nanoseconds into the
    pass record, the padding lane left out; its stats equal, bit for bit,
    the untraced replay's, which passes K1 no ``lane_info``."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import spans
    from repro_torch.uvm.backends import cuda_backend
    assert all(G.golden_cell_policy(c) == "lru" for c in K1_TRACED_CELLS)

    def requests():
        out = []
        for cell_id in K1_TRACED_CELLS:
            trace, cfg, factory = G.golden_cell(cell_id)
            out.append(ReplayRequest(trace, factory(), cfg))
        return out
    infos = []
    original = cuda_backend.lane_replay

    def spy(**kw):
        infos.append(kw.get("lane_info"))
        return original(**kw)
    monkeypatch.setattr(cuda_backend, "lane_replay", spy)
    backend = CudaReplayBackend(device)
    untraced = backend._replay_batch(requests())
    assert infos == [None]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]):
        traced = spans.records_pass(backend._replay_batch)(requests())
    info = infos[-1].cpu()
    assert tuple(info.shape) == (4, 4)
    scans, ns = info[:3, 0], info[:3, 1]
    rounds, round_evictions = info[:3, 2], info[:3, 3]
    assert (ns > 0).all() and (scans >= 0).all()
    evictions = sum(st.pages_evicted for st in untraced)
    assert 0 <= int(round_evictions.sum()) <= evictions
    counters = spans.passes()[-1]["counters"]
    assert {k: v for k, v in counters.items() if k.startswith("k1.")} == {
        "k1.lane_accesses": sum(len(r.trace.pages) for r in requests()),
        "k1.lane_scans": int(scans.sum()), "k1.lane_ns_sum": int(ns.sum()),
        "k1.lane_ns_longest_x_lanes": int(ns.max()) * 3,
        "k1.lane_rounds": int(rounds.sum()),
        "k1.lane_round_evictions": int(round_evictions.sum()),
        "k1.lane_evictions": evictions}
    for a, b in zip(traced, untraced):
        assert G.stats_to_dict(a) == G.stats_to_dict(b)
        assert (a.cycles, a.pcie_bytes) == (b.cycles, b.pcie_bytes)


def test_table10_tree_rows_equal_the_legacy_engine(device):
    benches = ("2DCONV", "ATAX")
    rows, _ = paper_tables.run(benches, device=device)
    for bench, row in zip(benches, rows):
        trace = sweep.load_trace(bench, 1.0, 0, paper_tables.EVAL_WINDOW)
        want = UVMSimulator(UVMConfig()).run(trace, TreePrefetcher())
        assert row["bench"] == bench
        assert row["hit_U"] == want.hit_rate
        assert row["simulated_inst"] == trace.n_instructions
        assert 0.0 < row["hit_R"] <= 1.0


@pytest.mark.parametrize("bench", ["Hotspot", "NW"])
def test_oversub_tree_lru_rows_equal_the_legacy_engine(device, bench):
    """Two of the oversubscribed sweep's longest tree lanes under lru at
    half the working set (636,973 and 370,062 evictions, nearly all in
    selection rounds) equal the legacy engine's rows bit for bit."""
    cells = sweep.expand_grid([bench], ["tree"], device_fracs=[0.5],
                              evictions=["lru"])
    got = sweep.run_sweep(cells, device=device)
    want = sweep.run_sweep([dataclasses.replace(c, engine="legacy")
                            for c in cells], device="cpu")
    assert got[0]["backend"] == "cuda" and want[0]["backend"] == "legacy"
    skip = {"engine", "backend", "seconds"}
    assert ({k: v for k, v in got[0].items() if k not in skip}
            == {k: v for k, v in want[0].items() if k not in skip})


@pytest.mark.parametrize("b,n,d", [(4096, 30, 12), (2, 256, 64),
                                   (1, 512, 128), (3, 70, 33)])
def test_k2_matches_its_plain_version(device, b, n, d):
    g = torch.Generator(device="cpu").manual_seed(b + n + d)
    q = torch.randn((b, n, d), generator=g).to(device)
    v = torch.randn((b, n, d), generator=g).to(device)
    keep = (torch.rand((b, n), generator=g) > 0.3).float().to(device)
    keep[:, 32:64] = 0.0                    # a fully erased key tile
    got = hlsh_attention(q, q, v, keep)
    torch.cuda.synchronize()
    want = hlsh_attention_plain(q, q, v, keep)
    assert (got - want).abs().max().item() <= 2e-4


#: K2's warp-per-row tiling at its edges: N of 1, 2, 31 and 32 (the path's
#: 30 between), odd D (7, 13: no float4 rows), D = 64, and rows whose spans
#: are not 16-byte aligned (N * D = 403 and 210 elements); and Table 5's
#: HLSH rows (512 windows x 4 heads of 200 / 4 dims: 2 rows a block)
K2_WARP_SHAPES = [(64, 1, 12), (64, 2, 12), (64, 31, 12), (64, 32, 12),
                  (33, 30, 7), (33, 31, 13), (9, 32, 64), (9, 30, 64),
                  (2048, 30, 50)]


@pytest.mark.parametrize("b,n,d", K2_WARP_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [0, 1])
def test_k2_warp_tiling_matches_its_plain_version(device, b, n, d, dtype,
                                                  offset):
    """The warp tiling, also on tensors one element into their storage (no
    16-byte aligned row) and with a row whose keys are all erased (its
    output is the mean of v): within 2e-4 of the plain version in float32;
    in bf16 within 3e-2 of the plain version on float32 copies of the same
    inputs (the bf16 plain version rounds its logits, K2 does not)."""
    geo = hlsh_geometry(b, n, d, dtype)
    assert geo.tiling == "warp"
    g = torch.Generator(device="cpu").manual_seed(b * n + d)

    def draw(shape):
        base = torch.randn((offset + int(np.prod(shape)),), generator=g)
        return base.to(device, dtype)[offset:].view(shape)
    q, v = draw((b, n, d)), draw((b, n, d))
    keep = (torch.rand((b, n), generator=g) > 0.3).to(device, dtype)
    keep[0] = 0.0                           # every key of row 0 erased
    keep[1] = 1.0
    launches = hlsh_attention.launches
    got = hlsh_attention(q, q, v, keep)
    torch.cuda.synchronize()
    assert hlsh_attention.launches == launches + 1
    assert got.dtype == dtype
    if dtype == torch.float32:
        want, tol = hlsh_attention_plain(q, q, v, keep), 2e-4
    else:
        want = hlsh_attention_plain(q.float(), q.float(), v.float(),
                                    keep.float())
        tol = 3e-2
    assert (got.float() - want.float()).abs().max().item() <= tol
    mean_v = v[0].float().mean(0, keepdim=True).expand(n, d)
    assert (got[0].float() - mean_v).abs().max().item() <= tol


@pytest.mark.parametrize("b,n,d", [(1, 128, 32), (2, 256, 64),
                                   (1, 512, 128)])
def test_k2_bf16_matches_its_plain_version(device, b, n, d):
    """K2 in bf16 at the reference's test shapes, its bf16 tolerance."""
    g = torch.Generator(device="cpu").manual_seed(b + n + d)
    q = torch.randn((b, n, d), generator=g).to(device, torch.bfloat16)
    v = torch.randn((b, n, d), generator=g).to(device, torch.bfloat16)
    keep = (torch.rand((b, n), generator=g) > 0.3).to(device, torch.bfloat16)
    keep[:, :min(128, n) // 2] = 0.0
    got = hlsh_attention(q, q, v, keep)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    want = hlsh_attention_plain(q, q, v, keep)
    assert (got.float() - want.float()).abs().max().item() <= 3e-2


#: the reference's flash-attention test shapes in both of its types, and
#: the Transformer family's inference shape (4096 sequences, 4 heads, 30
#: tokens, head dim 200 / 4) in the family's float32
K4_CASES = [(shape, dtype) for shape in (
    (1, 2, 1, 128, 128, 64), (2, 4, 2, 256, 256, 64),
    (1, 8, 1, 128, 384, 128), (1, 4, 4, 256, 128, 32))
    for dtype in (torch.float32, torch.bfloat16)] + [
    ((4096, 4, 4, 30, 30, 50), torch.float32)]


def _k4_tiling(shape, dtype, causal):
    """The tiling K4 must take: bf16 at D = 64 or 128 (no mask, or a causal
    one with Sk >= Sq) on the tensor cores, split where G x Sq <= 64, mma
    where Sq >= 16; else a warp per head where S <= 32 and D <= 64, else
    general."""
    b, h, hkv, sq, sk, d = shape
    if (dtype == torch.bfloat16 and d in (64, 128)
            and not (causal and sq > sk)):
        if h // hkv * sq <= 64:
            return "split"
        if sq >= 16:
            return "mma"
    return "warp" if max(sq, sk) <= 32 and d <= 64 else "general"


def _k4_geometry(shape, dtype, causal):
    b, h, hkv, sq, sk, d = shape
    return flash_geometry(b * h, sq, sk, d, dtype, h // hkv, causal)


@pytest.mark.parametrize("shape,dtype", K4_CASES)
@pytest.mark.parametrize("causal", [False, True])
def test_k4_matches_its_plain_version(device, shape, dtype, causal):
    b, h, hkv, sq, sk, d = shape
    g = torch.Generator(device="cpu").manual_seed(b * h + sq + sk + d)
    q = torch.randn((b, h, sq, d), generator=g).to(device, dtype)
    k = torch.randn((b, hkv, sk, d), generator=g).to(device, dtype)
    v = torch.randn((b, hkv, sk, d), generator=g).to(device, dtype)
    assert (_k4_geometry(shape, dtype, causal).tiling
            == _k4_tiling(shape, dtype, causal))
    launches = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == launches + 1 and got.dtype == dtype
    want = flash_attention_plain(q, k, v, causal=causal)
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.parametrize("causal", [False, True])
def test_k4_bf16_at_the_path_shape_matches_the_float32_plain_version(
        device, causal):
    """K4 in bf16 at the Transformer family's shape (ragged D = 50, S =
    30), held at the reference's bf16 tolerance against the plain version
    on float32 copies of the same inputs: the bf16 plain version rounds its
    logits and probabilities to bf16 where K4 keeps them in float32."""
    b, h, s, d = 4096, 4, 30, 50
    g = torch.Generator(device="cpu").manual_seed(b + h + s + d)
    q, k, v = (torch.randn((b, h, s, d), generator=g).to(device,
                                                          torch.bfloat16)
               for _ in range(3))
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    want = flash_attention_plain(q.float(), k.float(), v.float(),
                                 causal=causal)
    assert (got.float() - want).abs().max().item() <= 2e-2


def _bf16_qkv(device, b, h, hkv, sq, sk, d, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return (torch.randn((b, h, sq, d), generator=g).to(device, torch.bfloat16),
            torch.randn((b, hkv, sk, d), generator=g).to(device,
                                                        torch.bfloat16),
            torch.randn((b, hkv, sk, d), generator=g).to(device,
                                                        torch.bfloat16))


def test_k4_at_the_llama3_prefill_shape_matches_the_float32_plain_version(
        device):
    """The LM zoo's prefill at llama3-8b's full width: 8 requests of 512
    tokens, 32 query heads over 8 kv heads (GQA 4:1), head dim 128, bf16,
    causal; against the plain version on float32 copies, at the
    reference's bf16 tolerance."""
    q, k, v = _bf16_qkv(device, 8, 32, 8, 512, 512, 128, 1)
    assert flash_geometry(8 * 32, 512, 512, 128, torch.bfloat16, 4,
                          True).tiling == "mma"
    launches = flash_attention.launches
    got = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert flash_attention.launches == launches + 1
    want = flash_attention_plain(q.float(), k.float(), v.float(),
                                 causal=True)
    assert (got.float() - want).abs().max().item() <= 2e-2


@pytest.mark.parametrize("index", [512, 543, 574])
def test_k4_decode_step_over_a_sliced_cache(device, index):
    """A decode step as the LM zoo runs it: one query at position
    ``index`` against a (B, Hkv, 576, D) cache viewed (no copy) as its
    first index + 1 keys, causal (K4's offset Sk - Sq = index), in the
    split tiling, held against the reference's mask over the whole padded
    cache (keys past index, here filled with large values, get weight 0),
    in float32."""
    q, ck, cv = _bf16_qkv(device, 8, 32, 8, 1, 576, 128, index)
    ck[:, :, index + 1:] = 100.0
    cv[:, :, index + 1:] = 100.0
    assert flash_geometry(8 * 32, 1, index + 1, 128, torch.bfloat16, 4,
                          True).tiling == "split"
    launches = flash_attention.launches
    got = flash_attention(q, ck[:, :, :index + 1], cv[:, :, :index + 1],
                          causal=True)
    assert flash_attention.launches == launches + 1
    kx = ck.float().repeat_interleave(4, dim=1)
    vx = cv.float().repeat_interleave(4, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kx) / 128 ** 0.5
    mask = torch.arange(576, device=device) <= index
    logits = logits.masked_fill(~mask, -1e30)
    want = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(logits, -1), vx)
    torch.cuda.synchronize()
    assert (got.float() - want).abs().max().item() <= 2e-2


@pytest.mark.parametrize("sq,sk", [(40, 16), (1, 16), (16, 200)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_cross_attention_matches_its_plain_version(device, sq, sk, dtype):
    """Cross attention (``xattn``): decoder queries over encoder keys,
    Sq != Sk, not causal."""
    g = torch.Generator(device="cpu").manual_seed(sq * 1000 + sk)
    q = torch.randn((2, 16, sq, 64), generator=g).to(device, dtype)
    k = torch.randn((2, 16, sk, 64), generator=g).to(device, dtype)
    v = torch.randn((2, 16, sk, 64), generator=g).to(device, dtype)
    launches = flash_attention.launches
    got = flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert flash_attention.launches == launches + 1
    want = flash_attention_plain(q.float(), k.float(), v.float())
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    assert (got.float() - want).abs().max().item() <= tol


def _k4_tc_check(device, shape, causal, seed, view=0):
    """K4 in bf16 once on random inputs in the tiling ``_k4_tiling`` names
    (k and v, with ``view`` > 0, the first Sk keys of a cache of Sk + view),
    against the plain version on float32 copies at the reference's bf16
    tolerance."""
    b, h, hkv, sq, sk, d = shape
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn((b, h, sq, d), generator=g).to(device, torch.bfloat16)
    ck, cv = (torch.randn((b, hkv, sk + view, d), generator=g).to(
        device, torch.bfloat16) for _ in range(2))
    k, v = ck[:, :, :sk], cv[:, :, :sk]
    assert k.is_contiguous() == (view == 0)
    tiling = _k4_tiling(shape, torch.bfloat16, causal)
    assert _k4_geometry(shape, torch.bfloat16, causal).tiling == tiling
    launches = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == launches + 1
    want = flash_attention_plain(q.float(), k.float(), v.float(),
                                 causal=causal)
    assert (got.float() - want).abs().max().item() <= 2e-2, tiling
    return tiling


#: GQA groups of the full-width archs with K4 blocks (1: smollm, seamless;
#: 3: smollm-135m's 9/3; 4: llama3-8b; 16: qwen3-moe; 48: granite-20b)
K4_TC_GROUPS = (1, 3, 4, 16, 48)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("group", K4_TC_GROUPS)
@pytest.mark.parametrize("s", [1, 63, 64, 65, 512, 1000])
@pytest.mark.parametrize("causal", [False, True])
def test_k4_tensor_core_tilings_self_attention(device, d, group, s, causal):
    """Sq = Sk across the split (G x Sq <= 64) and mma tilings' edges: a
    tile of 64 query rows or keys, one past it, and many."""
    b = 2 if group * s <= 4096 else 1
    _k4_tc_check(device, (b, group, 1, s, s, d), causal, s * group + d)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("group", K4_TC_GROUPS)
@pytest.mark.parametrize("sk", [1, 2, 63, 64, 65, 575, 4097])
def test_k4_split_tiling_decode_step(device, d, group, sk):
    """A decode step (Sq = 1, causal) over key counts around the 64-key
    tiles, llama3's 575 and past 4,096 (splits of several tiles)."""
    assert _k4_tc_check(device, (2, 2 * group, 2, 1, sk, d), True,
                        sk + group + d) == "split"


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("group", K4_TC_GROUPS)
def test_k4_four_queries_over_600_keys(device, d, group):
    """Sq = 4 over Sk = 600, causal: rows with four different last keys in
    one split block (G x 4 <= 64), or off the tensor cores (G = 48)."""
    _k4_tc_check(device, (2, 2 * group, 2, 4, 600, d), True, 600 + group)


@pytest.mark.parametrize("sq,sk", [(40, 16), (16, 200), (100, 7), (300, 90),
                                   (1, 1500)])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("group", [1, 4])
def test_k4_tensor_core_cross_attention(device, sq, sk, d, group):
    """Cross attention in bf16: Sq != Sk, no mask, more queries than keys
    too."""
    _k4_tc_check(device, (2, 4 * group, 4, sq, sk, d), False,
                 sq + sk + d + group)


@pytest.mark.parametrize("shape", [(8, 32, 8, 1, 575, 128),
                                   (2, 16, 1, 4, 333, 64),
                                   (2, 12, 4, 100, 300, 128),
                                   (1, 8, 8, 64, 1000, 64)])
@pytest.mark.parametrize("causal", [False, True])
def test_k4_tensor_core_tilings_read_a_strided_cache_view(device, shape,
                                                          causal):
    """k and v as the first Sk keys of a longer cache (heads and batches
    strided, rows dense), read in place by both tilings."""
    _k4_tc_check(device, shape, causal, sum(shape), view=37)


def test_k4_rejects_an_unaligned_cache_on_the_tensor_cores(device):
    """The tensor-core tilings copy 16 bytes at a time: a k that does not
    start on 16 bytes raises, and nothing launches."""
    q, k, v = _bf16_qkv(device, 2, 8, 2, 1, 600, 64, 3)
    shifted = torch.empty(k.numel() + 1, dtype=k.dtype, device=device)
    shifted = shifted[1:].view(k.shape)
    shifted.copy_(k)
    launches = flash_attention.launches
    with pytest.raises(ValueError):
        flash_attention(q, shifted, v, causal=True)
    assert flash_attention.launches == launches


@pytest.mark.parametrize("name", ["llama3-8b", "seamless-m4t-medium"])
def test_reduced_lm_train_loss_gradients_match_the_cpu(device, monkeypatch,
                                                       name):
    """``train_loss(...).backward()`` of a reduced arch on the card (its
    attention on the differentiable path, never on K4): every parameter
    gets a gradient, equal to the CPU's within 1e-3 of each gradient's
    largest entry (float32, TF32 off; sums in other orders: float32
    rounding alone moves seamless's gradients by up to 1.7e-4 of their
    largest entry against a float64 run, so two float32 runs may differ by
    twice that; a missing path is off by order 1)."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = get_arch(name).reduced()
    model = lm.build_model(cfg)
    rng = np.random.default_rng(2)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 32)))}
    if cfg.family == "audio":
        batch["frames"] = torch.from_numpy(
            rng.normal(size=(2, 4, cfg.d_model))).float()

    def grads(device_):
        params = lm.init_params(model, torch.Generator().manual_seed(2))
        params = params.to(device_)
        loss, _ = lm.train_loss(model, params,
                                {k: t.to(device_) for k, t in batch.items()})
        loss.backward()
        return {n: p.grad for n, p in params.named_parameters()}

    want = grads("cpu")
    launches = flash_attention.launches
    got = grads(device)
    torch.cuda.synchronize()
    assert flash_attention.launches == launches
    assert sorted(got) == sorted(want)
    assert not [n for n, g in got.items() if g is None]
    for n, g in got.items():
        scale = want[n].abs().max().item()
        assert scale > 0, n
        assert (g.cpu() - want[n]).abs().max().item() <= 1e-3 * scale, n


@pytest.mark.parametrize("name", ["llama3-8b", "seamless-m4t-medium",
                                  "recurrentgemma-9b"])
def test_reduced_lm_prefill_and_decode_match_the_cpu(device, monkeypatch,
                                                     name):
    """A reduced arch's prefill and one decode step on the card (K4 on its
    attn, eattn and xattn blocks; recurrentgemma's lattn on the plain
    attention, no launch) against the same parameters on the CPU, float32
    with TF32 off."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = get_arch(name).reduced()
    model = lm.build_model(cfg)
    params = lm.init_params(model, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 32)))}
    if cfg.family == "audio":
        batch["frames"] = torch.from_numpy(
            rng.normal(size=(2, 4, cfg.d_model))).float()
    nxt = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 1)))

    def run(params, batch, nxt):
        logits, states = lm.prefill(model, params, batch, max_len=36)
        step, _ = lm.decode(model, params, states, nxt, 32)
        return logits.cpu(), step.cpu()

    want = run(params, batch, nxt)
    launches = flash_attention.launches
    got = run(params.to(device), {k: t.to(device) for k, t in batch.items()},
              nxt.to(device))
    torch.cuda.synchronize()
    n = flash_attention.launches - launches
    assert (n == 0) if name == "recurrentgemma-9b" else (n > 0)
    for g, w in zip(got, want):
        assert (g - w).abs().max().item() <= 1e-4 * w.abs().max().item()


def _train_steps(model, params, device, mode, steps=4):
    """``steps`` train steps of the port on ``device`` from a copy of
    ``params``: (losses, the types and values of every parameter and
    moment after each step)."""
    from repro_torch.data import TokenPipeline
    from repro_torch.launch import train as port_train
    from repro_torch.optimizer import (AdamW, init_error_feedback,
                                       linear_warmup_cosine)
    params = copy.deepcopy(params).to(device)
    opt = AdamW(weight_decay=0.1, clip_norm=1.0)
    step_fn = port_train.make_train_step(
        model, opt, linear_warmup_cosine(3e-4, 2, steps), mode)
    plist = list(params.parameters())
    state = opt.init(plist)
    ef = init_error_feedback(plist) if mode else None
    pipe = TokenPipeline(vocab=model.cfg.vocab, seq_len=64, batch_size=2)
    losses, after = [], []
    for step in range(steps):
        batch = {"tokens": torch.from_numpy(
            pipe.next_batch()["tokens"]).long().to(device)}
        params, state, ef, met = step_fn(params, state, ef, batch, step)
        losses.append(met["loss"].item())
        after.append([(p.dtype, p.detach().cpu().double(), m.dtype, v.dtype)
                      for p, m, v in zip(params.parameters(), state.mu,
                                         state.nu)])
    return losses, after


@pytest.mark.parametrize("name,dtype,mode", [
    ("llama3-8b", "float32", None), ("smollm-135m", "float32", "int8"),
    ("mamba2-780m", "float32", "topk"), ("smollm-135m", "bfloat16", None),
    ("qwen3-moe-235b-a22b", "bfloat16", "int8")])
def test_reduced_lm_train_steps_match_the_cpu(device, monkeypatch, name,
                                              dtype, mode):
    """Four train steps of a reduced text arch on the card (bf16 configs
    with remat on, as the full-size configs are) against the port on the
    CPU from the same parameters and batches, with no launch of K1-K4.
    Every parameter's and moment's type equal after each step (bf16 turns
    float32 as in the reference); float32: losses within 1e-4 relative and
    the update within 5e-2 of its norm (the CPU tests' limits against the
    reference, float32 with TF32 off); bf16: 2e-2 and 0.6, the CPU tests'
    bf16 limits (the first step's bf16 rounding decides which tiny
    gradients flip sign)."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = get_arch(name).reduced()
    if dtype == "bfloat16":
        cfg = dataclasses.replace(cfg, dtype=dtype, remat=True)
    model = lm.build_model(cfg)
    params = lm.init_params(model, torch.Generator().manual_seed(3))
    p0 = [p.detach().double() for p in params.parameters()]
    loss_tol, upd_tol = (1e-4, 5e-2) if dtype == "float32" else (2e-2, 0.6)
    want_losses, want = _train_steps(model, params, "cpu", mode)
    counts = [k.launches for k in (flash_attention, hlsh_attention,
                                   int4_matmul, lane_replay)]
    got_losses, got = _train_steps(model, params, device, mode)
    torch.cuda.synchronize()
    assert [k.launches for k in (flash_attention, hlsh_attention,
                                 int4_matmul, lane_replay)] == counts
    for step, (gl, wl, g, w) in enumerate(zip(got_losses, want_losses, got,
                                              want)):
        assert np.isfinite(gl)
        assert abs(gl - wl) <= loss_tol * abs(wl), (step, gl, wl)
        assert [(a[0], a[2], a[3]) for a in g] == \
            [(a[0], a[2], a[3]) for a in w], step
        num = sum(float(((a[1] - b[1]) ** 2).sum()) for a, b in zip(g, w))
        den = sum(float(((b[1] - z) ** 2).sum()) for b, z in zip(w, p0))
        assert num ** 0.5 <= upd_tol * den ** 0.5 + 1e-12, (step, num, den)
    if dtype == "bfloat16":
        assert {a[0] for a in got[0]} == {torch.float32}


def test_checkpoint_round_trip_from_and_onto_the_card(device, tmp_path):
    """A bf16 ``LMParams`` on the card saved by ``save_async`` and restored
    onto the card into a fresh template (in place, bit for bit, bf16) and
    onto the CPU; then float32 parameters (as after a step) into the bf16
    template, which turns float32 on the card."""
    from repro_torch.checkpoint import CheckpointManager
    cfg = dataclasses.replace(get_arch("smollm-135m").reduced(),
                              dtype="bfloat16")
    model = lm.build_model(cfg)
    saved = lm.init_params(model, torch.Generator(device=device)
                           .manual_seed(1))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_async(1, saved, {"step": 1})
    mgr.wait()
    template = lm.init_params(model, torch.Generator(device=device)
                              .manual_seed(2))
    got, extra = mgr.restore(template)
    assert got is template and extra == {"step": 1}
    want = dict(saved.named_parameters())
    for n, p in got.named_parameters():
        assert p.device.type == "cuda" and p.dtype == torch.bfloat16, n
        assert torch.equal(p.detach().view(torch.int16),
                           want[n].detach().view(torch.int16)), n
    on_cpu, _ = mgr.restore({n: p.detach() for n, p in
                             saved.named_parameters()}, device="cpu")
    assert all(t.device.type == "cpu" and torch.equal(t, want[n].cpu())
               for n, t in on_cpu.items())
    saved.float()
    mgr.save(2, saved, {"step": 2})
    got, _ = mgr.restore(template, step=2)
    for n, p in got.named_parameters():
        assert p.device.type == "cuda" and p.dtype == torch.float32, n
        assert torch.equal(p.detach(), want[n].detach()), n


def test_compressors_at_the_tied_embedding_size_match_the_cpu(device):
    """``topk`` and ``int8`` on a 49,152 x 960 float32 tensor (47.2M
    entries, smollm-360m's tied embedding) on the card against the CPU:
    top-k equal but among ties at the k-th magnitude (two sorts may break
    them otherwise), int8 within one quantum (the card may round a
    quotient within an ulp of a half quantum otherwise)."""
    from repro_torch.optimizer import (int8_compress, int8_decompress,
                                       topk_compress, topk_decompress)
    x = torch.randn((49152, 960), generator=torch.Generator()
                    .manual_seed(4))
    want = topk_decompress(*topk_compress(x))
    got = topk_decompress(*topk_compress(x.to(device))).cpu()
    k = int(x.numel() * 0.05)
    kth = torch.topk(x.abs().reshape(-1), k).values[-1]
    diff = (got != want).reshape(-1)
    assert bool((x.abs().reshape(-1)[diff] == kth).all())
    assert int((got != 0).sum()) == k
    q, s = int8_compress(x)
    gq, gs = int8_compress(x.to(device))
    assert float(gs) == float(s) and gq.dtype == torch.int8
    assert int((gq.cpu().int() - q.int()).abs().max()) <= 1
    y = int8_decompress(gq, gs)
    assert y.dtype == torch.float32 and y.device.type == "cuda"


#: the reference's int4 test shapes, the simplified predictor's layer
#: products (4096 x 30 token rows, widths 12 and 48) and its head at an even
#: and an odd class count (the odd one padded by one zero column)
K3_SHAPES = [(128, 128, 256), (128, 256, 256), (256, 128, 512),
             (4096 * 30, 12, 12), (4096 * 30, 12, 48), (4096 * 30, 48, 12),
             (4096, 12, 20000), (4096, 12, 19999)]


@pytest.mark.parametrize("m,k,n", K3_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_matches_its_plain_version(device, m, k, n, dtype):
    g = torch.Generator(device="cpu").manual_seed(m + k + n)
    x = torch.randn((m, k), generator=g).to(device, dtype)
    w = torch.randn((k, n), generator=g).to(device) * 0.3
    packed, scale = pack_int4_like_fake_quant(w)
    launches = int4_matmul.launches
    got = int4_matmul(x, packed, scale)[:, :n]
    torch.cuda.synchronize()
    assert int4_matmul.launches == launches + 1 and got.dtype == dtype
    want = int4_matmul_plain(x, packed, scale)[:, :n]
    err = ((got.float() - want.float()).abs()
           / (want.float().abs() + 1.0)).max().item()
    assert err < (1e-4 if dtype == torch.float32 else 2e-2)


#: K3's edges: every K crossed with every N at M = 1000 (no multiple of a
#: tile): K = 1, 13, 65 give rows of x that are no whole 16-byte chunks, K =
#: 65 and N > 64 pass the narrow variant's limit, N = 66 and 130 are wide
#: but take the general variant (rows of out no whole 16-byte chunks), N =
#: 20000 is the head's
K3_EDGE_K = (1, 12, 13, 48, 64, 65)
K3_EDGE_N = (2, 12, 14, 48, 50, 66, 130, 20000)


def _k3_case(device, m, k, n, dtype, seed):
    """Random codes and the reference tests' scale 0.03 as a 0-d float32 on
    the card, x of ``dtype``."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn((m, k), generator=g).to(device, dtype)
    packed = torch.randint(0, 256, (k, n // 2), generator=g,
                           dtype=torch.uint8).to(device)
    return x, packed, torch.tensor(0.03, device=device)


def _k3_check(x, packed, scale, variant):
    """K3 once on (x, packed, scale) in ``variant``, against its plain
    version at the reference's tolerance."""
    m, k = x.shape
    n = 2 * packed.shape[1]
    launches = int4_matmul.launches
    got = int4_matmul(x, packed, scale)
    torch.cuda.synchronize()
    assert int4_matmul.launches == launches + 1 and got.dtype == x.dtype
    assert int4_variant(m, k, n, x.dtype, x.data_ptr(),
                        got.data_ptr()) == variant
    want = int4_matmul_plain(x, packed, scale)
    err = ((got.float() - want.float()).abs()
           / (want.float().abs() + 1.0)).max().item()
    assert err < (1e-4 if x.dtype == torch.float32 else 2e-2)


#: Table 8's quantized revised predictor at the evaluation batch of 512
#: windows: its layer products (15,360 token rows of 12 and 48) and its
#: head at each bench's class count (padded to even), with their bodies
K3_TABLE8_SHAPES = [(15360, 12, 12, "narrow16"), (15360, 12, 48, "narrow48x2"),
                    (15360, 48, 12, "narrow16"), (512, 12, 4, "narrow16")] + [
    (512, 12, n, "general") for n in (6, 26, 70, 142, 146, 158)]


@pytest.mark.parametrize("m,k,n,variant", K3_TABLE8_SHAPES)
def test_k3_at_table8_shapes_matches_its_plain_version(device, m, k, n,
                                                       variant):
    """On weights packed as the path packs them (``fake_quant_tensor``'s
    codes and scale), float32 as the path runs."""
    g = torch.Generator(device="cpu").manual_seed(m + k + n)
    x = torch.randn((m, k), generator=g).to(device)
    packed, scale = pack_int4_like_fake_quant(
        torch.randn((k, n), generator=g).to(device) * 0.3)
    _k3_check(x, packed, scale, variant)


@pytest.mark.parametrize("k", K3_EDGE_K)
@pytest.mark.parametrize("n", K3_EDGE_N)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_edge_shapes_match_its_plain_version(device, k, n, dtype):
    m = 1000
    x, packed, scale = _k3_case(device, m, k, n, dtype, k * n)
    _k3_check(x, packed, scale, int4_variant(m, k, n, dtype, 0, 0))


@pytest.mark.parametrize("k,n,dtype,body", [
    (13, 12, torch.float32, "general"), (12, 12, torch.float32, "narrow16"),
    (48, 32, torch.float32, "narrow32"), (12, 24, torch.float32, "narrow32x2"),
    (48, 48, torch.float32, "narrow48"), (16, 48, torch.float32, "narrow48x2"),
    (64, 64, torch.float32, "narrow64"), (12, 132, torch.float32, "wide16"),
    (32, 68, torch.float32, "wide32"), (12, 12, torch.bfloat16, "general"),
    (16, 16, torch.bfloat16, "narrow16"), (48, 32, torch.bfloat16, "narrow32"),
    (16, 32, torch.bfloat16, "narrow32x2"),
    (48, 48, torch.bfloat16, "narrow48"),
    (32, 48, torch.bfloat16, "narrow48x2"),
    (64, 64, torch.bfloat16, "narrow64"),
    (16, 144, torch.bfloat16, "wide16"),
    # more two-rows-a-thread tiles (x rows of at most 4 chunks, 16 < N <=
    # 48, a tile of 256 rows)
    (16, 32, torch.float32, "narrow32x2"), (24, 40, torch.bfloat16,
                                            "narrow48x2")])
def test_k3_every_body_matches_its_plain_version(device, k, n, dtype, body):
    """Each compiled body of K3 in each type (the wide body of K <= 32 is
    float32's only), at M = 1000 (no multiple of a tile)."""
    x, packed, scale = _k3_case(device, 1000, k, n, dtype, k * n + 2)
    _k3_check(x, packed, scale, body)


@pytest.mark.parametrize("k,n,variant", [(12, 12, "general"),
                                         (48, 48, "general"),
                                         (12, 20000, "wide16")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_unaligned_x_matches_its_plain_version(device, k, n, variant,
                                                  dtype):
    """x sliced one element into its storage, so its pointer is not 16-byte
    aligned: the narrow variant gives way to the general one (the wide one
    reads x by scalars and keeps it)."""
    m = 1000
    x, packed, scale = _k3_case(device, m, k, n, dtype, k + n)
    base = torch.empty(m * k + 1, dtype=dtype, device=device)
    base[1:] = x.view(-1)
    x = base[1:].view(m, k)
    assert x.is_contiguous() and x.data_ptr() % 16
    _k3_check(x, packed, scale, variant)


#: K4's edges: S around a warp's 32 rows, D from 1 to 128 around the warp
#: tiling's 64 and its float4 chunks (D = 32 is 8 chunks, 33 and 40 are 9
#: and 10, 64 the 16 a lane's 4 x 4 output tile holds)
K4_EDGE_S = (1, 29, 30, 31, 33, 129)
K4_EDGE_D = (1, 32, 33, 40, 49, 50, 64, 100, 128)


def _k4_check(device, shape, dtype, causal, seed, float32_plain=False):
    """K4 once on random (B, H, Hkv, Sq, Sk, D) inputs against its plain
    version (``float32_plain``: on float32 copies of the same inputs) at
    the reference's tolerance."""
    b, h, hkv, sq, sk, d = shape
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn((b, h, sq, d), generator=g).to(device, dtype)
    k = torch.randn((b, hkv, sk, d), generator=g).to(device, dtype)
    v = torch.randn((b, hkv, sk, d), generator=g).to(device, dtype)
    assert (_k4_geometry(shape, dtype, causal).tiling
            == _k4_tiling(shape, dtype, causal))
    launches = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == launches + 1 and got.dtype == dtype
    if float32_plain:
        q, k, v = q.float(), k.float(), v.float()
    want = flash_attention_plain(q, k, v, causal=causal)
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.parametrize("s", K4_EDGE_S)
@pytest.mark.parametrize("d", K4_EDGE_D)
@pytest.mark.parametrize("causal", [False, True])
def test_k4_edge_shapes_match_its_plain_version(device, s, d, causal):
    _k4_check(device, (2, 5, 5, s, s, d), torch.float32, causal, s * d)


@pytest.mark.parametrize("s", K4_EDGE_S)
@pytest.mark.parametrize("d", K4_EDGE_D)
@pytest.mark.parametrize("causal", [False, True])
def test_k4_bf16_edge_shapes_match_the_float32_plain_version(device, s, d,
                                                             causal):
    """The same edges in bf16 (staged by 16-byte or, where a head's span is
    unaligned, 4-byte loads), against the float32 plain version on the same
    inputs."""
    _k4_check(device, (2, 5, 5, s, s, d), torch.bfloat16, causal, s * d + 1,
              float32_plain=True)


#: the predictor tables' K4 shapes at the evaluation batch of 512: Fig 5's
#: single-feature Transformers (4 heads of 2, 3, 4, 6 and 8 dims: odd and
#: sub-float4 rows) and the revised rows of Table 8 and Fig 9 (1 head of 12)
K4_TABLE_SHAPES = [(512, 4, 4, 30, 30, d) for d in (2, 3, 4, 6, 8)] + [
    (512, 1, 1, 30, 30, 12)]


@pytest.mark.parametrize("shape", K4_TABLE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_at_the_tables_shapes_matches_its_plain_version(device, shape,
                                                           dtype):
    """In the warp tiling; bf16 against the float32 plain version on the
    same inputs."""
    _k4_check(device, shape, dtype, False, sum(shape) + shape[-1],
              float32_plain=dtype == torch.bfloat16)


@pytest.mark.parametrize("shape", [
    (2, 4, 2, 33, 33, 50), (1, 8, 1, 30, 30, 50),     # GQA
    (2, 4, 2, 33, 29, 50), (1, 2, 1, 129, 31, 64),   # Sq > Sk
    (3, 2, 2, 31, 1, 49), (1, 4, 4, 30, 129, 100)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_gqa_and_short_keys_match_its_plain_version(device, shape,
                                                       causal, dtype):
    """Grouped kv heads, and Sq > Sk (under the causal mask the first rows
    see no key and are spread evenly over all Sk keys, as the reference's
    oracle does); bf16 against the float32 plain version on the same
    inputs."""
    _k4_check(device, shape, dtype, causal, sum(shape),
              float32_plain=dtype == torch.bfloat16)


@pytest.mark.parametrize("causal", [False, True])
def test_k4_bf16_unaligned_heads_match_the_float32_plain_version(device,
                                                                 causal):
    """bf16 at S x D = 1,500: a head is 3,000 bytes, so every other head's
    span is not 16-byte aligned and is staged by 4-byte loads."""
    _k4_check(device, (3, 3, 3, 30, 30, 50), torch.bfloat16, causal, 1500,
              float32_plain=True)


@pytest.mark.parametrize("quantize", [False, True])
def test_predictor_inference_at_other_window_lengths(device, quantize):
    """Windows of 34 tokens (the configuration's are 30): inference on the
    card still launches K2 (and K3 on every weight product when quantized)
    and agrees with the same model on the CPU, both with torch's draws for
    that length."""
    cfg = families.revised_config(40, convergence=0.2, quantize=quantize)
    assert cfg.attention == "hlsh" and cfg.seq_len != 34
    model = Predictor(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(3)
    x = torch.as_tensor(np.stack(
        [rng.integers(0, FEATURE_BUCKETS[f], (256, 34))
         for f in cfg.features], -1))
    with torch.no_grad():
        want = model(x)
        k2, k3 = hlsh_attention.launches, int4_matmul.launches
        got = model.to(device)(x.to(device)).cpu()
    assert hlsh_attention.launches == k2 + 1
    assert int4_matmul.launches == k3 + (6 if quantize else 0)
    assert (got.argmax(-1) == want.argmax(-1)).float().mean() >= 0.99


def test_predictor_inference_runs_k2_and_matches_the_cpu(device):
    cfg = families.revised_config(40, convergence=0.2)
    assert cfg.attention == "hlsh"
    model = Predictor(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(1)
    x = torch.as_tensor(np.stack(
        [rng.integers(0, FEATURE_BUCKETS[f], (256, cfg.seq_len))
         for f in cfg.features], -1))
    with torch.no_grad():
        want = model(x)
        launches = hlsh_attention.launches
        got = model.to(device)(x.to(device)).cpu()
    assert hlsh_attention.launches == launches + 1
    assert (got.argmax(-1) == want.argmax(-1)).float().mean() >= 0.99


@pytest.mark.parametrize("family,quantize,kernel", [
    ("transformer", False, flash_attention),
    ("simplified", True, int4_matmul)])
def test_predictor_inference_runs_k3_k4_and_matches_the_cpu(
        device, family, quantize, kernel):
    """The Transformer family's inference launches K4 (one per layer) and
    the quantized simplified predictor's launches K3 (one per weight
    product), both agreeing with the same model's CPU inference."""
    cfg = families.family_config(family, 40, convergence=0.2,
                                 quantize=quantize)
    model = Predictor(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(2)
    x = torch.as_tensor(np.stack(
        [rng.integers(0, FEATURE_BUCKETS[f], (256, cfg.seq_len))
         for f in cfg.features], -1))
    with torch.no_grad():
        want = model(x)
        launches = kernel.launches
        got = model.to(device)(x.to(device)).cpu()
    assert kernel.launches == launches + (2 if family == "transformer"
                                          else 6)
    assert (got.argmax(-1) == want.argmax(-1)).float().mean() >= 0.99
    if not quantize:
        assert (got - want).abs().max().item() <= 1e-4


#: the other archs and LSH attention at the widths of Table 4 and Fig 9
#: (13 features, d_model 200, hidden 128), fc also quantized
ARCH_CONFIGS = {
    "fc": dict(arch="fc"), "fc-quantized": dict(arch="fc", quantize=True),
    "mlp": dict(arch="mlp"), "cnn": dict(arch="cnn"),
    "lstm": dict(arch="lstm"), "transformer-lsh": dict(attention="lsh")}


@pytest.mark.parametrize("name", sorted(ARCH_CONFIGS))
def test_other_archs_inference_matches_the_cpu(device, monkeypatch, name):
    """Each arch's inference on the card agrees with the same model on the
    CPU (float32 convolutions in full precision, TF32 off, as on the CPU);
    the quantized fc head launches K3 once, no other arch a kernel."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = families.PredictorConfig(n_classes=40, **ARCH_CONFIGS[name])
    model = Predictor(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(4)
    x = torch.as_tensor(np.stack(
        [rng.integers(0, FEATURE_BUCKETS[f], (512, cfg.seq_len))
         for f in cfg.features], -1))
    counted = (int4_matmul, hlsh_attention, flash_attention)
    with torch.no_grad():
        want = model(x)
        before = [fn.launches for fn in counted]
        got = model.to(device)(x.to(device)).cpu()
    torch.cuda.synchronize()
    assert [fn.launches - b for fn, b in zip(counted, before)] == (
        [1, 0, 0] if cfg.quantize else [0, 0, 0])
    if cfg.quantize:
        assert (got.argmax(-1) == want.argmax(-1)).float().mean() >= 0.99
    elif cfg.attention == "lsh":
        # a token whose hash sits at a near tie can land in another bucket
        # under last-ulp differences of q (the hash is an argmax), which
        # changes its row's mask: the rows where no bucket flips agree
        rows = (got - want).abs().amax(-1) <= 1e-4
        assert rows.float().mean() >= 0.99
    else:
        assert (got - want).abs().max().item() <= 1e-4


def _synth_request(pages, prefetcher, **cfg):
    from repro_torch.traces.trace import Trace, make_records
    recs = make_records(len(pages))
    recs["page"] = pages
    return ReplayRequest(Trace("synth", recs, {}, {}, 100 * len(pages)),
                         prefetcher, UVMConfig(**cfg))


def _cyclic(n, width, base=0):
    return base + (np.arange(n, dtype=np.int64) * 7) % width


#: one request per decline route of K1 (the CPU test's, in
#: tests/test_torch_chain.py), built fresh per call
DECLINE_ROUTES = {
    "oracle_lookahead": lambda: _synth_request(
        _cyclic(1500, 300), OraclePrefetcher(_cyclic(1500, 300),
                                             lookahead=1024),
        device_pages=200),
    "step_windows": lambda: dataclasses.replace(_synth_request(
        _cyclic(70_000, 3000), NoPrefetcher(), device_pages=1000,
        eviction="random"), step_bounds=np.arange(1, 70_001)),
    "span": lambda: _synth_request(
        np.stack([_cyclic(800, 400), _cyclic(800, 400, 1 << 20)],
                 axis=1).ravel(), TreePrefetcher(), device_pages=500,
        eviction="hotcold"),
    "tree_length": lambda: _synth_request(
        _cyclic((1 << 21) + 1, 600), TreePrefetcher()),
    "timeline": lambda: dataclasses.replace(_synth_request(
        _cyclic(1500, 600), BlockPrefetcher(), device_pages=400),
        record_timeline=True),
}


@pytest.mark.parametrize("route", list(DECLINE_ROUTES))
def test_declined_requests_replay_on_numpy_without_k1(device, route):
    """Each decline route on the card: K1 declines the request, ``dispatch``
    on the ``cuda`` chain replays it on the NumPy engine without launching
    K1, and the result equals the legacy engine (counters exact, floats
    within 1e-6, step clocks and timeline too)."""
    from repro_torch.uvm.backends.cuda_backend import decline_reason
    from repro_torch.uvm.replay_core import dispatch
    req = DECLINE_ROUTES[route]()
    assert decline_reason(req) is not None
    launches = lane_replay.launches
    got = dispatch(req, "cuda", device)
    assert lane_replay.launches == launches
    assert got.backend == "numpy"
    want_req = DECLINE_ROUTES[route]()
    want = UVMSimulator(want_req.config, want_req.record_timeline).run(
        want_req.trace, want_req.prefetcher,
        step_bounds=want_req.step_bounds)
    for f in G.INT_FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    for f in G.FLOAT_FIELDS:
        assert getattr(got, f) == pytest.approx(getattr(want, f), rel=1e-6,
                                                abs=1e-9), f
    for f in ("step_clocks", "timeline"):
        g, w = getattr(got, f), getattr(want, f)
        assert (g is None) == (w is None), f
        if w is not None:
            np.testing.assert_allclose(g, w, rtol=1e-6)


def test_accepted_cell_under_auto_runs_on_k1(device):
    """A cell K1 accepts records ``cuda`` under ``backend="auto"``, and K1
    launched for it."""
    cell = sweep.SweepCell("ATAX", "tree", scale=0.25, device_frac=0.5,
                           backend="auto")
    launches = lane_replay.launches
    (row,) = sweep.run_sweep([cell], device=device)
    assert lane_replay.launches == launches + 1
    assert row["backend"] == "cuda"
    trace, config, pf, _ = sweep.prepare_cell(cell, device=device)
    want = UVMSimulator(config).run(trace, pf)
    assert (row["hits"], row["faults"], row["pages_evicted"]) == (
        want.hits, want.faults, want.pages_evicted)


# ---------------------------------------------------------------------------
# crash safety on the card
# ---------------------------------------------------------------------------

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")


def test_chaos_smoke_on_k1_converges(device, tmp_path):
    """``chaos-smoke`` under the default plan with ``--backend cuda``: the
    drivers replay the 8 cells as K1 lanes on the card, survive the kills
    and transient K1 raises, and end on the fault-free rows, all ``cuda``,
    with an empty quarantine manifest."""
    import subprocess
    import sys
    from repro_torch.uvm import faults
    env = dict(os.environ, PYTHONPATH=_SRC)
    env.pop(faults.FAULT_PLAN_ENV, None)
    out = str(tmp_path / "chaos")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.uvm.faults", "--scenario",
         "chaos-smoke", "--backend", "cuda", "--device", device, "--out",
         out], env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    report = json.loads(res.stdout.strip().splitlines()[-1])
    assert report["cells"] == 8 and report["faults_fired"] > 0
    with open(os.path.join(out, "chaos", "quarantine.json")) as f:
        assert json.load(f)["cells"] == []
    rows = sweep.read_results(os.path.join(out, "chaos"))
    assert [r["backend"] for r in rows] == ["cuda"] * 8
    assert faults.rows_digest(rows) == report["digest"]


def test_lease_pool_spawns_from_a_cuda_parent(device, tmp_path,
                                              monkeypatch):
    """A 2-worker lease pool started by a process that has initialised
    CUDA: the workers start by spawn, train the learned cells' predictors
    on the card (one fit per trace, through the prediction cache's lock),
    and the rows equal those of a serial run that fits its own predictors
    on a fresh cache (the digest leaves the fit columns aside).  The
    workers' quantized inference launches K3 (their launch log)."""
    from repro_torch import kernels
    from repro_torch.kernels.int4_matmul import int4_matmul
    log_dir = str(tmp_path / "launches")
    monkeypatch.setenv(kernels.LAUNCH_LOG_ENV, log_dir)
    monkeypatch.setattr(int4_matmul, "launches", 0)   # the workers' alone
    torch.zeros(1, device=device)
    assert torch.cuda.is_initialized()
    assert sweep._mp_context().get_start_method() == "spawn"
    cells = sweep.expand_grid(["ATAX", "Pathfinder"], ["learned"],
                              scales=[0.25], prediction_us=[1.0, 2.0],
                              backend="numpy", service_steps=20)
    pool = sweep.run_sweep(cells, out_dir=str(tmp_path / "pool"),
                           device=device, workers=2)
    assert sorted(r["bench"] for r in pool if "fit_top1" in r) == [
        "ATAX", "Pathfinder"]
    assert kernels.read_launch_log(log_dir)["int4_matmul"] > 0
    from repro_torch.uvm import predcache
    predcache.clear_memo()
    serial = sweep.run_sweep(cells, out_dir=str(tmp_path / "serial"),
                             device=device)
    assert sorted(r["bench"] for r in serial if "fit_top1" in r) == [
        "ATAX", "Pathfinder"]
    from repro_torch.uvm import faults
    assert faults.rows_digest(serial) == faults.rows_digest(pool)


def _get_or_train_on_card(cache_dir: str, out_path: str) -> None:
    """One process's ``get_or_train`` on the card (a spawned child)."""
    import sys
    sys.path.insert(0, _SRC)
    from repro_torch.uvm import predcache
    from repro_torch.uvm import sweep as child_sweep
    trace = child_sweep.load_trace("ATAX", 0.25, 0, 0.6)
    timings = {}
    preds = predcache.get_or_train(trace, steps=20, cache_dir=cache_dir,
                                   device="cuda", timings=timings)
    np.save(out_path, preds)
    with open(out_path + ".json", "w") as f:
        json.dump({"trained": "train_s" in timings}, f)


def test_two_processes_train_one_key_once(device, tmp_path):
    """Two spawned processes ask for the same key on the card at once: the
    training lock lets one fit, the other waits for its array."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    cache = str(tmp_path / "cache")
    outs = [str(tmp_path / f"p{i}.npy") for i in range(2)]
    procs = [ctx.Process(target=_get_or_train_on_card, args=(cache, out))
             for out in outs]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=600)
    assert all(p.exitcode == 0 for p in procs)
    trained = []
    for out in outs:
        with open(out + ".json") as f:
            trained.append(json.load(f)["trained"])
    assert sorted(trained) == [False, True]
    np.testing.assert_array_equal(np.load(outs[0]), np.load(outs[1]))


# ---------------------------------------------------------------------------
# K4's registered op (repro_torch::flash_attention): the launch it makes on
# real tensors, its fake implementation, and its FLOP formula
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,extra", [((8, 32, 8, 512, 512, 128), 0),
                                         ((8, 32, 8, 1, 575, 128), 1),
                                         ((2, 4, 4, 30, 30, 16), 0)])
def test_k4_registered_op_matches_the_direct_launch(device, shape, extra):
    """On real CUDA tensors the op launches K4 once and equals the direct
    call bit for bit (k and v a cache view where ``extra`` > 0)."""
    from repro_torch.kernels.flash_attention import flash_attention_op
    b, h, hkv, sq, sk, d = shape
    g = torch.Generator(device=device).manual_seed(sq)
    dtype = torch.bfloat16 if d == 128 else torch.float32
    q = torch.randn((b, h, sq, d), generator=g, device=device, dtype=dtype)
    ck = torch.randn((b, hkv, sk + extra, d), generator=g, device=device,
                     dtype=dtype)
    cv = torch.randn((b, hkv, sk + extra, d), generator=g, device=device,
                     dtype=dtype)
    k, v = ck[:, :, :sk], cv[:, :, :sk]
    causal = sq > 1 or extra > 0
    launches = flash_attention.launches
    got = flash_attention_op(q, k, v, causal)
    assert flash_attention.launches == launches + 1
    want = flash_attention(q, k, v, causal=causal)
    assert flash_attention.launches == launches + 2
    torch.cuda.synchronize()
    assert got.dtype == q.dtype and torch.equal(got, want)


def test_k4_registered_op_on_cuda_fakes_launches_nothing(device):
    """On fake CUDA tensors the op gives the output's shape and type, counts
    K4's formula in ``torch.utils.flop_counter`` and launches nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.kernels.flash_attention import (flash_attention_cost,
                                                     flash_attention_op)
    launches = flash_attention.launches
    with FakeTensorMode():
        q = torch.empty((8, 32, 512, 128), dtype=torch.bfloat16,
                        device=device)
        k = torch.empty((8, 8, 512, 128), dtype=torch.bfloat16,
                        device=device)
        with FlopCounterMode(display=False) as fc:
            out = flash_attention_op(q, k, k, True)
    assert flash_attention.launches == launches
    assert tuple(out.shape) == (8, 32, 512, 128)
    assert out.dtype == torch.bfloat16 and out.device.type == "cuda"
    assert fc.get_total_flops() == flash_attention_cost(
        q.shape, k.shape, True, 2)[0]
