"""The harness is driven by data, imports no JAX, and refuses to run where
it cannot measure."""
import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

from uvmbench import harness, spec

UVMBENCH = os.path.join(spec.ROOT, "uvmbench")
REFERENCE = os.path.join(UVMBENCH, "reference")


def _modules():
    for base, _, files in os.walk(UVMBENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)


def _imported_tops(path):
    """Top-level names of every module ``path`` imports (relative imports
    resolved against its package)."""
    rel = os.path.relpath(path, spec.ROOT)
    package = os.path.dirname(rel).split(os.sep)
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = package[:len(package) - node.level + 1]
                tops.add(base[0] if base else "")
            else:
                tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", sorted(_modules()),
                         ids=lambda p: os.path.relpath(p, UVMBENCH))
def test_no_jax_and_a_reference_apart_from_the_program(path):
    tops = _imported_tops(path)
    assert not tops & {"jax", "jaxlib", "flax", "repro"}, tops
    if path.startswith(REFERENCE + os.sep):
        assert "repro_torch" not in tops, tops


def test_import_scan_compares_whole_names(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import repro_torch.uvm\nfrom jaxtyping import x\n"
                   "from repro.uvm import sweep\n")
    assert _imported_tops(str(src)) == {"repro_torch", "jaxtyping", "repro"}


def test_forbidden_modules_by_whole_top_level_name():
    found = harness.forbidden_loaded
    assert found(["repro_torch", "repro_torch.uvm.sweep", "jaxtyping",
                  "flaxen", "numpy"]) == []
    assert found(["repro_torch", "jax.numpy", "repro.uvm", "flax",
                  "jaxlib.xla_client"]) == ["flax", "jax", "jaxlib", "repro"]


def test_no_card_no_result():
    if harness.look_for_chip(1) is None:
        pytest.skip("a card is here: the harness would measure")
    proc = subprocess.run(
        [sys.executable, "uvmbench/run.py", "--workload", "paper11.oversub",
         "--seed", "1", "--seconds", "1"], cwd=spec.ROOT,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2
    assert proc.stdout == ""
    assert "torch.cuda.is_available() is false" in proc.stderr


def _copy(tmp_path):
    """The benchmark alone: BENCHMARK.json and the files under its paths."""
    bench = spec.benchmark()
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    for p in bench["paths"]:
        shutil.copytree(os.path.join(spec.ROOT, p), tmp_path / p,
                        ignore=shutil.ignore_patterns("__pycache__"))
    return bench


def test_benchmark_alone_gives_no_result(tmp_path):
    _copy(tmp_path)
    proc = subprocess.run(
        [sys.executable, "uvmbench/run.py", "--workload", "paper11.oversub",
         "--seed", "1", "--seconds", "1"], cwd=tmp_path,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout == ""


def test_new_mix_cell_and_metric_are_found_without_an_edit(tmp_path):
    bench = _copy(tmp_path)
    mix = dict(spec.traffic("oversub"), ratios=[0.9],
               prefetchers=["none"], why="a mix a later change adds")
    (tmp_path / "uvmbench" / "traffic" / "tiny.json").write_text(
        json.dumps(mix))
    (tmp_path / "uvmbench" / "metrics" / "rows.per_pass.py").write_text(
        "def read(record):\n    return len(record['rows']) / "
        "record['passes']\n")
    bench["workloads"].append({"name": "paper11.tiny", "config": "paper11",
                               "traffic": "tiny", "chips": 1, "why": "x"})
    # a sweep cell joins the sweep's end-to-end metric, and so its metrics
    next(m for m in bench["end_to_end"]
         if m["name"] == "sim_accesses_per_s")["workloads"].append(
        "paper11.tiny")
    bench["per_layer"].append({"name": "rows.per_pass", "unit": "count",
                               "better": "higher", "source": "host_clock",
                               "layer": "sweep driver",
                               "moves": "sim_accesses_per_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import json, sys\n"
        f"sys.path[:0] = [{str(tmp_path)!r}, "
        f"{os.path.join(spec.ROOT, 'src')!r}]\n"
        "from uvmbench import spec\n"
        "b = spec.benchmark()\n"
        "w = spec.workload('paper11.tiny', b)\n"
        "c = spec.config(w['config'], b)\n"
        "cells = spec.driver(c['driver']).grid(c, spec.traffic('tiny'), 1)\n"
        "names = [m['name'] for m in spec.cell_metrics('paper11.tiny', b, "
        "'per_layer')]\n"
        "r = spec.metric_reader('rows.per_pass').read("
        "{'rows': [1, 2, 3, 4], 'passes': 2})\n"
        "print(json.dumps([len(cells), names, r, spec.__file__]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, names, r, where = json.loads(out.stdout.strip().splitlines()[-1])
    assert n == 11 * 3
    assert "rows.per_pass" in names and "k1_roofline" in names
    assert r == 2.0
    assert where.startswith(str(tmp_path))
