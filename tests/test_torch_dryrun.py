"""The port's dry-run, roofline, hill-climb and report tooling
(``repro_torch.launch.{dryrun,roofline,hillclimb,report}``) against the
reference's, on the CPU.

* ``model_flops`` and ``_active_params`` for the ten archs x four shapes,
  exactly: the reference's values come from a subprocess, since importing
  ``repro.launch.dryrun`` (or ``hillclimb``) sets ``XLA_FLAGS`` to 512 host
  devices in the importing process.
* ``hillclimb.CELLS``, equal to the reference's as parsed from its source.
* The report's three tables, byte-equal to ``repro.launch.report``'s (which
  imports no jax) on the same records.
* The collective accounting against ``repro.launch.roofline.
  collective_bytes`` on the matching HLO text.
* The FLOP count per partition: on a data-only (4, 1) fake mesh it is a
  quarter of the (1, 1) mesh's, exactly; K4's registered op counts its
  formula.
* Lowering on a fake (2, 2) CPU mesh: smollm-135m and a MoE arch, reduced,
  train, prefill and decode.

The lowerings run on a fake process group of 512 ranks, made for this module
and destroyed after it.
"""
import ast
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

import repro.launch.report as ref_report
import repro.launch.roofline as ref_roofline
from repro_torch.configs import ARCHS, SHAPES, ShapeSpec, get_arch
from repro_torch.distributed.sharding import make_mesh
from repro_torch.kernels.flash_attention import (causal_pairs,
                                                 flash_attention_cost,
                                                 flash_attention_op)
from repro_torch.launch import dryrun as D
from repro_torch.launch import hillclimb, report
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import init_fake_world
from repro_torch.models import build_model, init_params

ROOT = os.path.join(os.path.dirname(__file__), "..")

_REF_FLOPS = r"""
import json
import jax
import repro.launch.dryrun as d
from repro.configs import ARCHS, SHAPES, get_arch
from repro.launch import roofline as rl
from repro.models import build_model, init_params
out = {}
for arch in sorted(ARCHS):
    cfg = get_arch(arch)
    model = build_model(cfg)
    shapes = jax.eval_shape(lambda k: init_params(model, k),
                            jax.random.PRNGKey(0))
    total, active = d._active_params(shapes, cfg)
    out[arch] = {"total": total, "active": active,
                 "model_flops": {s: rl.model_flops(cfg, spec, active)
                                 for s, spec in SHAPES.items()}}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def fake_world():
    if dist.is_initialized():
        pytest.fail("a process group exists before the dry-run tests")
    init_fake_world(512)
    yield
    dist.destroy_process_group()


def test_model_flops_and_params_equal_the_reference():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", _REF_FLOPS], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    ref = json.loads(res.stdout.strip().splitlines()[-1])
    assert sorted(ref) == sorted(ARCHS)
    for arch in sorted(ARCHS):
        cfg = get_arch(arch)
        with FakeTensorMode():
            params = init_params(build_model(cfg),
                                 torch.Generator().manual_seed(0))
        total, active = D._active_params(params, cfg)
        assert (total, active) == (ref[arch]["total"],
                                   ref[arch]["active"]), arch
        for s, spec in SHAPES.items():
            assert rl.model_flops(cfg, spec, active) == \
                ref[arch]["model_flops"][s], (arch, s)


def test_hillclimb_cells_equal_the_reference():
    path = os.path.join(ROOT, "src", "repro", "launch", "hillclimb.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    node = next(n for n in tree.body if isinstance(n, ast.Assign)
                and any(getattr(t, "id", None) == "CELLS"
                        for t in n.targets))
    assert ast.literal_eval(node.value) == hillclimb.CELLS
    assert sum(len(c["variants"]) for c in hillclimb.CELLS.values()) == 15


def _records():
    """Dry-run records of every status, with the keys the tables read."""
    def ok(arch, shape, c, m, x, peak, counts, ratio):
        roof = rl.Roofline(flops=c * rl.PEAK_FLOPS, hbm_bytes=m * rl.HBM_BW,
                           coll_bytes=x * rl.LINK_BW, chips=256,
                           coll_detail={"all-gather": x * rl.LINK_BW,
                                        "_counts": counts})
        return {"arch": arch, "shape": shape, "status": "ok",
                "memory": {"peak_bytes": peak, "temp_bytes": 7},
                "compile_s": 0.0, "roofline": roof.as_dict(),
                "useful_flops_ratio": ratio}
    counts = {"all-gather": 3, "all-reduce": 2, "reduce-scatter": 1,
              "all-to-all": 0, "collective-permute": 4}
    return [
        ok("llama3-8b", "train_4k", 0.5, 0.25, 0.125, 3.2e10, counts, 0.41),
        ok("llama3-8b", "decode_32k", 1e-4, 0.02, 0.3, 1e9, counts, None),
        ok("qwen3-moe-235b-a22b", "prefill_32k", 2.0, 1.0, 0.5, None,
           counts, 0.123456),
        ok("mamba2-780m", "long_500k", 1e-6, 1e-5, 1e-7, 5e8, {}, 0.9),
        ok("zz-new", "odd_shape", 0.1, 0.2, 0.3, 1.0, counts, 0.5),
        {"arch": "llama3-8b", "shape": "long_500k", "status": "skipped",
         "reason": "full quadratic-attention family: 512k-token KV decode "
                   "excluded per assignment (sub-quadratic archs only)"},
        {"arch": "granite-20b", "shape": "prefill_32k", "status": "failed",
         "error": "aten.view.default: cannot unflatten " + "x" * 80},
    ]


def test_report_tables_equal_the_reference(tmp_path, monkeypatch,
                                           capsys):
    recs = _records()
    assert report.dryrun_table(recs) == ref_report.dryrun_table(recs)
    assert report.roofline_table(recs) == ref_report.roofline_table(recs)
    base = tmp_path / "experiments"
    perf = base / "perf"
    perf.mkdir(parents=True)
    for i, (cell, variant) in enumerate([("qwen3_train", "baseline"),
                                         ("qwen3_train", "cap_1.0"),
                                         ("qwen3_train", "no_remat"),
                                         ("llama3_decode", "baseline"),
                                         ("llama3_decode", "tp_resident")]):
        rec = dict(recs[i % 3], hypothesis=f"hypothesis {i} " + "y" * 70,
                   variant=variant)
        if variant == "no_remat":
            rec = {"variant": variant, "status": "failed", "error": "boom"}
        (perf / f"{cell}.{variant}.json").write_text(json.dumps(rec))
    assert report.perf_table(str(perf)) == ref_report.perf_table(str(perf))
    # main over a records tree, as each package's tools write it
    for mesh in ("single_pod_16x16", "multi_pod_2x16x16"):
        for rec in recs:
            d = base / "dryrun" / mesh / rec["arch"]
            d.mkdir(parents=True, exist_ok=True)
            (d / f"{rec['shape']}.json").write_text(json.dumps(rec))
    monkeypatch.chdir(tmp_path)
    ref_report.main()
    want = capsys.readouterr().out
    report.main([])
    assert capsys.readouterr().out == want
    report.main(["--base", str(base)])
    assert capsys.readouterr().out == want


def test_collective_accounting_equals_the_reference_on_hlo(fake_world):
    import torch.distributed._functional_collectives as funcol
    mesh = make_mesh((4,), ("data",), device_type="cpu")
    counter = D.StepCounter()
    with FakeTensorMode():
        x = torch.empty(8, 16)
        y = torch.empty(4, 16)
        z = torch.empty(4, 16)
        w = torch.empty(4, 16)
        with counter:
            funcol.all_gather_single(x, 0, (mesh, 0))
            funcol.all_reduce(y, "sum", (mesh, 0))
            pending = funcol.all_reduce(z, "sum", (mesh, 0))
            funcol.wait_tensor(pending)
            # DTensor's own all-to-all (a shard moved from dim 1 to dim 0)
            torch.ops._dtensor.shard_dim_alltoall(
                w, 1, 0, mesh.get_group(0).group_name)
    hlo = """
HloModule m
ENTRY %main {
  %x = f32[8,16]{1,0} parameter(0)
  %ag = f32[32,16]{1,0} all-gather(f32[8,16]{1,0} %x), dimensions={0}
  %ar = f32[4,16]{1,0} all-reduce(f32[4,16]{1,0} %y), to_apply=%sum
  %ars = f32[4,16]{1,0} all-reduce-start(f32[4,16]{1,0} %z), to_apply=%sum
  %ard = f32[4,16]{1,0} all-reduce-done(f32[4,16]{1,0} %ars)
  ROOT %a2a = f32[1,64]{1,0} all-to-all(f32[4,16]{1,0} %w), dimensions={0}
}
"""
    assert counter.coll.detail() == ref_roofline.collective_bytes(hlo)
    assert counter.flops == 0


def _reduced(arch):
    full, red = get_arch(arch), get_arch(arch).reduced()
    return {f.name: getattr(red, f.name) for f in dataclasses.fields(full)
            if getattr(red, f.name) != getattr(full, f.name)
            and f.name != "name"}


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_flops_per_partition_split_over_data(fake_world, kind):
    shape = ShapeSpec(kind, 32, 4, kind)
    flops = {}
    for data in (1, 4):
        mesh = make_mesh((data, 1), ("data", "model"), device_type="cpu")
        rec = D.lower_cell("smollm-135m", shape, mesh,
                           cfg_override=_reduced("smollm-135m"))
        assert rec["status"] == "ok" and rec["chips"] == data
        flops[data] = rec["roofline"]["flops"]
    assert flops[1] > 0 and flops[4] * 4 == flops[1]


def test_k4_op_counts_its_formula(fake_world):
    from repro_torch.launch.roofline import tensors_of
    counter = D.StepCounter()
    with FakeTensorMode():
        q = torch.empty(2, 8, 5, 64, dtype=torch.bfloat16)
        k = torch.empty(2, 2, 9, 64, dtype=torch.bfloat16)
        with counter:
            out = flash_attention_op(q, k, k, True)
    assert tuple(out.shape) == (2, 8, 5, 64) and out.dtype == q.dtype
    ops, nbytes = flash_attention_cost(q.shape, k.shape, True, 2)
    assert counter.flops == ops == 4 * 2 * 8 * 64 * causal_pairs(5, 9, True)
    assert counter.bytes == nbytes
    assert causal_pairs(5, 9, True) == sum(min(9, i + 1 + 4)
                                           for i in range(5))
    assert causal_pairs(7, 3, True) == sum(max(0, min(3, i + 1 - 4))
                                           for i in range(7))
    assert not tensors_of(None)


@pytest.mark.parametrize("arch", ["smollm-135m", "qwen3-moe-235b-a22b"])
def test_reduced_archs_lower_on_a_2x2_mesh(fake_world, arch):
    mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
    for kind in ("train", "prefill", "decode"):
        rec = D.lower_cell(arch, ShapeSpec(kind, 32, 4, kind), mesh,
                           cfg_override=_reduced(arch))
        assert rec["status"] == "ok", rec
        assert rec["chips"] == 4 and rec["mesh"] == {"data": 2, "model": 2}
        roof = rec["roofline"]
        assert roof["flops"] > 0 and roof["hbm_bytes"] > 0
        assert rec["roofline_raw"] == roof
        mem = rec["memory"]
        assert 0 < mem["argument_bytes"] <= mem["peak_bytes"]
        assert rec["useful_flops_ratio"] > 0


def test_long_500k_skips_quadratic_archs(fake_world):
    mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
    rec = D.lower_cell("llama3-8b", "long_500k", mesh)
    assert rec["status"] == "skipped" and "quadratic" in rec["reason"]
