"""The port's kernels on the card: K1 replays the lru golden cells of this
slice exactly, K2 matches its plain version, and the predictor's inference
goes through K2.  Every test here needs a CUDA device and nvcc (a CUDA
kernel has no CPU mode) and skips without one.  The module imports neither
jax nor the reference package, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import families
from repro_torch.core.model import Predictor
from repro_torch.core.vocab import FEATURE_BUCKETS
from repro_torch.kernels.hlsh_attention import (hlsh_attention,
                                                hlsh_attention_plain)
from repro_torch.kernels.lane_replay import lane_replay, lane_replay_plain
from repro_torch.traces import GPUModel, generate_benchmark
from repro_torch.traces.interleave import build_mt_trace
from repro_torch.traces.trace import ROOT_PAGES, Trace, make_records
from repro_torch.uvm.config import UVMConfig
from repro_torch.uvm.prefetchers import (BlockPrefetcher, LearnedPrefetcher,
                                         NoPrefetcher)
from repro_torch.uvm.replay_core import ReplayRequest, get_backend

pytestmark = pytest.mark.cuda

FIXTURE = os.path.join(os.path.dirname(__file__), "golden", "uvm_golden.json")
INT_FIELDS = ("n_accesses", "n_instructions", "hits", "late", "faults",
              "prefetch_issued", "prefetch_used", "pages_migrated",
              "pages_evicted")


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 and K2 are CUDA kernels with no "
                    "CPU mode (their plain versions are tested on the CPU)")
    return "cuda"


def _synthetic(name, pages):
    recs = make_records(len(pages))
    recs["page"] = pages
    recs["sm"] = np.arange(len(pages)) % 4
    return Trace(name, recs, {}, {}, len(pages) * 100)


def _perfect(trace, distance):
    pages = np.asarray(trace.pages, dtype=np.int64)
    preds = np.full(len(pages), -1, dtype=np.int64)
    preds[:-distance] = pages[distance:]
    return preds


def _golden_lru_cases():
    """The lru cases of the reference's golden matrix
    (``repro.uvm.golden.golden_cases``), rebuilt from the port's copies."""
    atax = GPUModel().run(generate_benchmark("ATAX", scale=0.25))
    pathfinder = GPUModel().run(generate_benchmark("Pathfinder", scale=0.25))
    bicg = np.concatenate([np.arange(k, k + 50, dtype=np.int64)
                           for k in range(0, 12000, 200)])
    oversub = np.tile(np.arange(2500, dtype=np.int64), 6)
    n_churn = 3 * ROOT_PAGES
    perm = (np.arange(n_churn, dtype=np.int64) * 7) % n_churn
    churn = np.concatenate([perm + (0 if k % 2 == 0 else 8192)
                            for k in range(8)])
    mt = build_mt_trace("ATAX+Pathfinder", scale=0.25)
    return {
        "atax": (atax, UVMConfig()),
        "pathfinder": (pathfinder, UVMConfig()),
        "bicg-cluster": (_synthetic("bicg-cluster", bicg),
                         UVMConfig(mshr_entries=16)),
        "oversub": (_synthetic("oversub", oversub),
                    UVMConfig(device_pages=1500)),
        "tree-churn": (_synthetic("tree-churn", churn),
                       UVMConfig(device_pages=2048)),
        "mt-shared": (mt, UVMConfig(
            device_pages=int(0.6 * mt.working_set_pages))),
    }


def test_k1_replays_the_golden_cells_exactly(device):
    with open(FIXTURE) as f:
        golden = json.load(f)["cells"]
    ids, requests = [], []
    for case, (trace, cfg) in _golden_lru_cases().items():
        lat = cfg.cycles_per_us
        for name, pf in (
                ("none", NoPrefetcher()), ("block", BlockPrefetcher()),
                ("learned", LearnedPrefetcher(_perfect(trace, 32), lat)),
                ("learned-tf", LearnedPrefetcher(_perfect(trace, 16), lat))):
            ids.append(f"{case}/{name}")
            requests.append(ReplayRequest(trace, pf, cfg))
    launches = lane_replay.launches
    stats = get_backend("cuda", device).replay(requests)
    assert lane_replay.launches > launches
    for cell_id, st in zip(ids, stats):
        want = golden[cell_id]
        assert st.backend == "cuda"
        for f in INT_FIELDS:
            assert getattr(st, f) == want[f], (cell_id, f)
        for f in ("cycles", "pcie_bytes"):
            assert getattr(st, f) == pytest.approx(want[f], rel=1e-6), (
                cell_id, f)
        if "tenant_hits" in want:
            assert list(st.tenant_hits) == want["tenant_hits"], cell_id


def test_k1_matches_its_plain_version(device):
    rng = np.random.default_rng(0)
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
    args = [torch.as_tensor(a) for a in (pages, preds, fparams, iparams)]
    want = lane_replay_plain(*args, span)
    got = lane_replay(*(a.to(device) for a in args), span, 17).cpu()
    assert torch.equal(got, want)
    assert got[3].abs().sum() == 0


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
