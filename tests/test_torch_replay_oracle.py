"""K1's oracle lane family (the first-touch stream scanned over a lookahead
window, twice on a fault, with the trash slot at ``span``) on the CPU: the
non-quota oracle golden cells, under lru, random and hotcold eviction, replay
through the port's ``cuda`` backend exactly as ``tests/golden/uvm_golden.json``
pins them; the host-side packing of the oracle streams follows the
reference's."""
import numpy as np
import pytest

pytest.importorskip("torch")

from test_torch_replay import (_one_lane, assert_golden, golden_ids,
                               replay_golden)

from repro_torch.uvm import prefetchers as P
from repro_torch.uvm.backends.cuda_backend import CudaReplayBackend

CELLS = golden_ids(("oracle",))


@pytest.fixture(scope="module")
def golden_replay():
    return replay_golden(CELLS)


def test_oracle_cells_cover_every_policy():
    assert len(CELLS) == 10
    assert {c.split("/")[0] for c in CELLS} >= {
        "oversub-random", "oversub-hotcold", "churn-random",
        "churn-hotcold", "oversub"}


@pytest.mark.parametrize("cell_id", CELLS)
def test_oracle_golden_cell_replays_exactly(cell_id, golden_replay):
    assert_golden(cell_id, golden_replay[cell_id])


def test_oracle_streams_are_packed_like_the_reference():
    """``ft`` is the first-touch stream relative to the lane's span, padded
    with the trash slot; ``pos`` counts the first touches at or before each
    access; lookaheads never share a batch."""
    backend = CudaReplayBackend(device="cpu")
    req = _one_lane(P.OraclePrefetcher(np.arange(64) % 4096, lookahead=32))
    other = _one_lane(P.OraclePrefetcher(np.arange(64), lookahead=96))
    assert sorted(map(sorted, backend.pack_lanes([req, other]))) == [[0],
                                                                     [1]]
    batch = backend.pack_batch([req])
    assert (batch.family, batch.lookahead) == ("oracle", 32)
    assert batch.ft.shape == (1, 64 + 32)
    assert np.array_equal(batch.ft[0, :64], np.arange(64))
    assert (batch.ft[0, 64:] == batch.span).all()       # the trash slot
    assert np.array_equal(batch.pos[0, :64], np.arange(1, 65))
    assert batch.iparams[0, 4] == 64                    # n_ft
