"""The port stands alone: ``repro_torch`` imports with ``jax`` and ``repro``
blocked, and no line of it (or of ``chip_smoke.py``) imports either."""
import os
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.join(os.path.dirname(__file__), "..")
PKG = os.path.join(ROOT, "src", "repro_torch")

_BLOCKED_IMPORT = """
import importlib, importlib.abc, pkgutil, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for name in names:
    importlib.import_module(name)
assert not any(m.split(".")[0] in ("jax", "repro") for m in sys.modules)
print(" ".join(names))
print(len(names))
"""


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(PKG):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_port_imports_with_jax_and_repro_blocked():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-4000:]
    # every module of the port was imported, not a vacuous package
    names, count = res.stdout.strip().splitlines()[-2:]
    assert int(count) >= 88
    assert {"repro_torch.uvm.scenarios", "repro_torch.uvm.paper_tables",
            "repro_torch.uvm.engine", "repro_torch.uvm.backends.numpy_backend",
            "repro_torch.uvm.backends.legacy_backend",
            "repro_torch.core.predictor_tables",
            "repro_torch.uvm.golden", "repro_torch.kernels.lane_replay",
            "repro_torch.uvm.backends.cuda_backend",
            "repro_torch.uvm.adaptive", "repro_torch.kernels.int4_matmul",
            "repro_torch.kernels.flash_attention",
            "repro_torch.uvm.faults",
            "repro_torch.distributed.fault_tolerance",
            "repro_torch.configs", "repro_torch.configs.arch",
            "repro_torch.configs.registry", "repro_torch.configs.llama3_8b",
            "repro_torch.models", "repro_torch.models.layers",
            "repro_torch.models.moe", "repro_torch.models.ssm",
            "repro_torch.models.rglru", "repro_torch.models.builder",
            "repro_torch.models.convert",
            "repro_torch.launch.serve", "repro_torch.launch.train",
            "repro_torch.data", "repro_torch.data.lm_pipeline",
            "repro_torch.checkpoint", "repro_torch.checkpoint.manager",
            "repro_torch.optimizer.grad_compress",
            "repro_torch.distributed.sharding", "repro_torch.launch.mesh",
            "repro_torch.launch.dryrun", "repro_torch.launch.hillclimb",
            "repro_torch.launch.roofline",
            "repro_torch.launch.report"} <= set(names.split())


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+jaxlib\b|from\s+jaxlib\b|"
    r"from\s+repro(\.|\s+import)|import\s+repro(\.|\s*$|\s*,))")


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_reference_import_lines(path):
    assert os.path.exists(path), path
    with open(path) as f:
        bad = [f"{i}: {line.rstrip()}" for i, line in enumerate(f, 1)
               if _FORBIDDEN.match(line)]
    assert not bad, f"{path} imports jax or the reference package: {bad}"
