"""Each configuration and mix expands to the grid its cell states, in the
same order in the driver and in the reference."""
import pytest

from uvmbench import spec

#: the cells' grids, and the quota mix that no cell names yet
ROWS = {"paper11.oversub": 264, "paper-pairs.shared": 96,
        "paper-pairs.quota": 192}


@pytest.mark.parametrize("name", sorted(ROWS))
def test_grid_size_and_order(bench, name):
    config_name, mix = name.rsplit(".", 1)
    config = spec.config(config_name, bench)
    traffic = spec.traffic(mix)
    driver = spec.driver(config["driver"])
    reference = spec.reference(config["driver"])
    for seed in (0, 2 ** 31 + 11, -5):
        ours = driver.grid(config, traffic, seed)
        theirs = reference.grid(config, traffic, seed)
        assert len(ours) == len(theirs) == ROWS[name]
        assert ours == theirs
        keys = {tuple(sorted((k, str(v)) for k, v in c.items()))
                for c in ours}
        assert len(keys) == ROWS[name]
        assert all(c["seed"] == config["trace_seed"] for c in ours)


def test_seed_orders_the_grid_and_keeps_its_cells(bench):
    from uvmbench.drivers.sweep_pass import grid
    config = spec.config("paper11", bench)
    traffic = spec.traffic("oversub")
    a, b = grid(config, traffic, 1), grid(config, traffic, 2)
    assert a != b
    assert sorted(map(str, a)) == sorted(map(str, b))
    assert grid(config, traffic, 1) == a


def test_cells_are_the_measured_ones(bench):
    assert [w["name"] for w in bench["workloads"]] == [
        "paper11.oversub", "paper-pairs.shared", "smollm-360m.train"]


def test_every_cell_names_files_that_exist(bench):
    for cell in bench["workloads"]:
        config = spec.config(cell["config"], bench)
        spec.traffic(cell["traffic"])
        spec.driver(config["driver"])
        spec.reference(config["driver"])
    for m in bench["per_layer"]:
        assert callable(spec.metric_reader(m["name"]).read)


def test_sample_is_drawn_from_the_seed_per_group(bench):
    from uvmbench.reference.sweep_pass import draw_sample, grid
    config = spec.config("paper-pairs", bench)
    traffic = spec.traffic("quota")
    cells = grid(config, traffic, 5)
    a = draw_sample(cells, 7, 5, traffic["check_per_group"])
    assert a == draw_sample(cells, 7, 5, traffic["check_per_group"])
    assert a != draw_sample(cells, 7, 6, traffic["check_per_group"])
    groups = {(cells[i]["prefetcher"], cells[i]["eviction"],
               cells[i]["capacity_split"]) for _, i in a}
    assert len(groups) == len(a) == 24
    assert all(0 <= p < 7 for p, _ in a)
