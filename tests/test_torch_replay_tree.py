"""K1's tree lane family (the UVMSmart baseline: per-level node counts, the
2 MB root-window classify and the >50% escalation walk) on the CPU: the
non-quota tree golden cells, under lru, random and hotcold eviction, replay
through the port's ``cuda`` backend exactly as ``tests/golden/uvm_golden.json``
pins them."""
import numpy as np
import pytest

pytest.importorskip("torch")

from test_torch_replay import assert_golden, golden_ids, replay_golden

from repro_torch.uvm import prefetchers as P
from repro_torch.uvm.backends.cuda_backend import (CudaReplayBackend,
                                                   MAX_TREE_LANE_ACCESSES)
from repro_torch.uvm.replay_core import ReplayRequest
from test_torch_replay import _one_lane

CELLS = golden_ids(("tree",))


@pytest.fixture(scope="module")
def golden_replay():
    return replay_golden(CELLS)


def test_tree_cells_cover_every_policy():
    assert len(CELLS) == 10
    assert sorted(c.split("/")[0] for c in CELLS) == [
        "atax", "bicg-cluster", "churn-hotcold", "churn-random",
        "mt-shared", "oversub", "oversub-hotcold", "oversub-random",
        "pathfinder", "tree-churn"]


@pytest.mark.parametrize("cell_id", CELLS)
def test_tree_golden_cell_replays_exactly(cell_id, golden_replay):
    assert_golden(cell_id, golden_replay[cell_id])


def test_tree_lanes_pack_apart_and_cap_their_length():
    """Tree lanes batch only with tree lanes of the same policy and are
    capped at 2^21 accesses (a fault can stamp a whole root window)."""
    backend = CudaReplayBackend(device="cpu")
    reqs = [_one_lane(P.TreePrefetcher()), _one_lane(P.BlockPrefetcher()),
            _one_lane(P.TreePrefetcher(), eviction="random",
                      device_pages=8)]
    assert sorted(map(sorted, backend.pack_lanes(reqs))) == [[0], [1], [2]]
    batch = backend.pack_batch([reqs[0]])
    assert (batch.family, batch.policy) == ("tree", "lru")
    assert batch.preds is None and batch.ft is None
    assert MAX_TREE_LANE_ACCESSES == 1 << 21
    assert backend.can_replay(ReplayRequest(
        reqs[0].trace, P.TreePrefetcher(), reqs[0].config))
