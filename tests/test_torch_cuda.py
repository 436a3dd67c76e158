"""The port's kernels on the card: K1 replays the non-quota golden cells of
every lane family and eviction policy exactly and matches its plain version,
the paper's Table 10/11 tree rows equal the legacy engine's, K2 matches its
plain version, and the predictor's inference goes through K2.  Every test
here needs a CUDA device and nvcc (a CUDA kernel has no CPU mode) and skips
without one.  The module imports neither jax nor the reference package, so
it runs where only PyTorch is installed:

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
from repro_torch.kernels.lane_replay import (FAMILIES, POLICIES, lane_replay,
                                             lane_replay_plain)
from repro_torch.uvm import golden as G
from repro_torch.uvm import paper_tables, sweep
from repro_torch.uvm.config import UVMConfig
from repro_torch.uvm.prefetchers import TreePrefetcher
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
    """The 70 non-quota golden cells: every lane family under lru, random
    and hotcold, in one backend call (so they pack as a sweep packs)."""
    with open(FIXTURE) as f:
        golden = json.load(f)["cells"]
    ids = [c for c in G.golden_cell_ids()
           if not G.golden_cell(c)[1].tenant_pages]
    assert len(ids) == 70
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
