"""K1's random and hotcold victim keys on the demand and learned lane
families, on the CPU: the non-quota random/hotcold golden cells of
``none``, ``block``, ``learned``, ``learned-tf`` and ``learned-cached``,
and the lru ``learned-cached`` cells, replay through the port's ``cuda``
backend exactly as ``tests/golden/uvm_golden.json`` pins them.
``learned-cached`` round-trips its predictions through the port's own
prediction cache (``repro_torch.uvm.golden``)."""
import pytest

pytest.importorskip("torch")

from test_torch_replay import assert_golden, golden_ids, replay_golden

from repro_torch.uvm.eviction import eviction_score, eviction_scores

PREFETCHERS = ("none", "block", "learned", "learned-tf", "learned-cached")
CELLS = (golden_ids(PREFETCHERS, ("random", "hotcold"))
         + golden_ids(("learned-cached",), ("lru",)))


@pytest.fixture(scope="module")
def golden_replay():
    return replay_golden(CELLS)


def test_policy_cells_cover_the_demand_and_learned_families():
    assert len(CELLS) == 26
    assert {c.split("/")[0] for c in CELLS[:20]} == {
        "oversub-random", "oversub-hotcold", "churn-random",
        "churn-hotcold"}


@pytest.mark.parametrize("cell_id", CELLS)
def test_policy_golden_cell_replays_exactly(cell_id, golden_replay):
    assert_golden(cell_id, golden_replay[cell_id])


def test_random_draw_is_the_uint32_hash_chain():
    """The plain version's priority draw (the scalar mixer) equals the
    array mixer on page ids past 2^32, where both wrap."""
    pages = [0, 5, 2 ** 32 + 7, 2 ** 33 - 1]
    draws = [0, 1, 2 ** 31 - 1, 12345]
    assert [eviction_score(p, d) for p, d in zip(pages, draws)] == [
        int(x) for x in eviction_scores(pages, draws)]
