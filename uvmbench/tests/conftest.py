"""The benchmark's CPU tests: the repository root and the program's
``src`` on the path, and small copies of the configurations and mixes."""
import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
for _path in (os.path.join(ROOT, "src"), ROOT):
    if _path not in sys.path:
        sys.path.insert(0, _path)


@pytest.fixture(scope="session")
def bench():
    from uvmbench import spec
    return spec.benchmark()


def with_cell(bench, name):
    """``bench`` with the cell ``<config>.<mix>`` among its workloads (the
    files of a mix that no cell of ``BENCHMARK.json`` names yet)."""
    if any(w["name"] == name for w in bench["workloads"]):
        return bench
    config, traffic = name.rsplit(".", 1)
    out = copy.deepcopy(bench)
    out["workloads"].append({"name": name, "config": config,
                             "traffic": traffic, "chips": 1, "why": "test"})
    return out


def small_cell(bench, name, benches, scale=0.1, prefetchers=("none",
                                                             "block"),
               ratios=(0.5,)):
    """A cell's configuration and mix cut down to run on the CPU."""
    from uvmbench import spec
    cell = spec.workload(name, with_cell(bench, name))
    config = copy.deepcopy(spec.config(cell["config"], bench))
    config.update(benches=list(benches), scale=scale)
    traffic = copy.deepcopy(spec.traffic(cell["traffic"]))
    traffic.update(prefetchers=list(prefetchers), ratios=list(ratios))
    return config, traffic
