"""The control: the reference computed with float32 clocks, put in the
program's place, comes out not correct; the reference itself in that place
comes out correct."""
import pytest

from uvmbench.tools.control import control_readings

from .conftest import small_cell


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 1])
@pytest.mark.parametrize("name,benches,prefetchers", [
    ("paper11.oversub", ["ATAX", "Pathfinder"], ("none", "tree")),
    ("paper-pairs.quota", ["MVT+StreamTriad"], ("none", "block"))])
def test_control_is_rejected(bench, name, benches, prefetchers, seed):
    config, traffic = small_cell(bench, name, benches, scale=0.25,
                                 prefetchers=prefetchers)
    limits = config["limits"]
    r = control_readings(config, traffic, seed, workers=0)["readings"]
    assert any(v > limits[k] for k, v in r.items()), r
    sound = control_readings(config, traffic, seed, workers=0,
                             clock="float64")["readings"]
    assert all(v <= limits[k] for k, v in sound.items()), sound
