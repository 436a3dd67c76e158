"""The port's scenario registry against the reference's: the same built-in
scenarios expand to the same cells (only the backend differs: the port's
cells name ``cuda``), the oversubscription smoke replays through K1's plain
version on the CPU to the reference's NumPy rows, and scenarios whose cells
need a later slice of the port expand but refuse to run."""
import dataclasses

import pytest

pytest.importorskip("torch")

from repro.offload.serve_trace import is_serve_bench as ref_is_serve_bench
from repro.uvm import scenarios as ref_scenarios
from repro.uvm import sweep as ref_sweep
from repro_torch.uvm import scenarios, sweep
from repro_torch.uvm.scenarios import (Scenario, expand_scenario,
                                       get_scenario, register_scenario,
                                       scenario_from_dict)

INT_COLUMNS = ("n_accesses", "n_instructions", "device_pages", "hits",
               "late", "faults", "prefetch_issued", "prefetch_used",
               "pages_migrated", "pages_evicted")
FLOAT_COLUMNS = ("cycles", "pcie_bytes", "hit_rate", "unity")


def test_registry_is_the_reference_registry():
    assert (scenarios.available_scenarios()
            == ref_scenarios.available_scenarios())
    for name in scenarios.available_scenarios():
        mine = get_scenario(name).to_dict()
        ref = ref_scenarios.get_scenario(name).to_dict()
        assert mine.pop("description") and ref.pop("description")
        assert mine == ref, name


@pytest.mark.parametrize("name", ["oversub-full", "oversub-smoke",
                                  "serve-smoke", "mt-smoke",
                                  "transformer-smoke", "chaos-smoke"])
def test_scenario_expands_to_the_reference_cells(name):
    mine = [c.to_dict() for c in expand_scenario(name)]
    ref = [c.to_dict() for c in ref_scenarios.expand_scenario(name)]
    assert len(mine) == len(ref) == get_scenario(name).n_cells()
    assert all(c.pop("backend") == "cuda" for c in mine)
    assert all(c.pop("backend") == "auto" for c in ref)
    assert mine == ref


def test_oversub_full_is_the_660_cell_matrix():
    cells = expand_scenario("oversub-full")
    assert len(cells) == 660
    assert len({(c.bench, c.device_frac, c.eviction, c.prefetcher)
                for c in cells}) == 660
    assert {c.prefetcher for c in cells} == set(sweep.PREFETCHERS)
    assert {c.eviction for c in cells} == {"lru", "random", "hotcold"}
    assert {c.device_frac for c in cells} == {1.5, 1.0, 0.75, 0.5}
    assert all(c.scale == 1.0 and c.window == 0.6 for c in cells)
    for cell in cells:
        sweep.check_cell(cell)          # every cell is in the port


def test_oversub_smoke_equals_the_reference_numpy_rows():
    """24 rows: ATAX and Pathfinder at scale 0.25 x ratios 0.75 and 0.5 x
    three policies x none and tree.  The reference's Pallas path cannot run
    on this host, so its NumPy backend is the reference named here."""
    ref = ref_sweep.run_sweep(expand_scenario("oversub-smoke",
                                              backend="numpy"))
    got = sweep.run_sweep(expand_scenario("oversub-smoke"), device="cpu")
    assert len(got) == len(ref) == 24
    assert {r["backend"] for r in ref} == {"numpy"}
    for r, g in zip(ref, got):
        assert g["backend"] == "cuda"
        for f in ("bench", "prefetcher", "device_frac", "eviction",
                  "scenario", *INT_COLUMNS):
            assert g[f] == r[f], (r["bench"], r["prefetcher"], f)
        for f in FLOAT_COLUMNS:
            assert g[f] == pytest.approx(r[f], rel=1e-6), (r["bench"], f)
    assert any(g["pages_evicted"] > 0 for g in got)


@pytest.mark.parametrize("name,match", [
    ("serve-smoke", "serve scenarios with step clocks"),
    ("mt-smoke", "mt quotas"),
    ("transformer-smoke", "adaptive policy is a later slice"),
])
def test_later_slice_scenarios_expand_but_raise(name, match):
    cells = expand_scenario(name)
    assert cells
    with pytest.raises(ValueError, match=match):
        sweep.run_sweep(cells[:1], device="cpu")


def test_scenario_json_round_trip_and_validation():
    sc = get_scenario("oversub-full")
    assert scenario_from_dict(sc.to_dict()) == sc
    with pytest.raises(ValueError, match="unknown benches"):
        Scenario("bad", "", benches=("Nope",), ratios=(0.5,)).validate()
    with pytest.raises(ValueError, match="need multi-tenant benches"):
        Scenario("bad", "", benches=("ATAX",), ratios=(0.5,),
                 capacity_splits=("0.5/0.5",)).validate()
    with pytest.raises(ValueError, match="unknown evictions"):
        Scenario("bad", "", benches=("ATAX",), ratios=(0.5,),
                 evictions=("fifo",)).validate()


@pytest.mark.parametrize("name", ["ServeDecode", "ServeTenantMix",
                                  "ServeBursty@r128", "ServeBursty@r0",
                                  "ServeBursty@x2", "ServeNope", "ATAX",
                                  "ATAX+Pathfinder"])
def test_serve_bench_names_resolve_as_in_the_reference(name):
    assert scenarios.is_serve_bench(name) == ref_is_serve_bench(name)


def test_sweep_cli_runs_a_scenario(tmp_path, capsys):
    register_scenario(Scenario(
        name="port-cli-test", description="CLI test", benches=("2DCONV",),
        ratios=(0.5,), evictions=("random",), prefetchers=("oracle",),
        scale=0.25), replace=True)
    sweep.main(["--scenario", "port-cli-test", "--device", "cpu",
                "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert "scenario 'port-cli-test': 1 cells" in out
    assert "2DCONV,oracle,0.5000,random,cuda" in out
    with pytest.raises(SystemExit):
        sweep.main(["--scenario", "no-such-scenario", "--device", "cpu"])
