"""The ``lm_train`` driver on the CPU at a small size: a sound run comes
out correct; each fault planted in the program, and the control, come out
not correct; the reference draws the program's weights and tokens bit for
bit; the configuration is the registry's architecture; the FLOP count and
the metrics that attach to each cell."""
import copy

import numpy as np
import pytest
import torch

from uvmbench import lm_flops, spec
from uvmbench.tools import lm_control

CELL = "smollm-360m.train"
#: the registry's reduced widths, two layers; bf16 weights at init as the
#: cell's
SMALL = dict(n_layers=2, d_model=64, n_heads=4, n_kv=2, head_dim=16,
             d_ff=128, vocab=512)
SEED = 2 ** 31 + 17


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Ops this small run fastest on one thread (and the suite's workers
    share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def small(bench):
    config = copy.deepcopy(spec.config("smollm-360m", bench))
    config.update(SMALL)
    traffic = dict(spec.traffic("train"), batch=2, seq_len=64)
    return config, traffic


def _run(bench, small, fault=None, seed=SEED):
    config, traffic = small
    return lm_control.run_program(CELL, seed, 0.01, "cpu", bench=bench,
                                  config=config, traffic=traffic,
                                  fault=fault)


def test_small_cell_is_correct(bench, small):
    result = _run(bench, small)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["metrics"]) == {"train_tokens_per_s", "setup_s"}
    assert all(c["value"] <= c["limit"] for c in result["checks"].values())


@pytest.mark.parametrize("fault", sorted(lm_control.FAULTS))
def test_planted_fault_is_not_correct(bench, small, fault):
    result = _run(bench, small, fault)
    assert not result["correct"], result["checks"]
    assert result["failed"] >= 1


def test_control_is_rejected(small):
    # the bf16 control (TF32 has no effect on the CPU)
    config, traffic = small
    out = lm_control.stand_in_readings(config, traffic, SEED, "cpu", "bf16")
    limits = config["limits"]
    assert any(v > limits[k] for k, v in out["readings"].items()), out


def test_reference_draws_the_programs_weights_and_tokens(small):
    from repro_torch.data import TokenPipeline
    from repro_torch.models import build_model, init_params
    from uvmbench.drivers.lm_train import arch
    from uvmbench.reference.lm import pipeline, weights
    config, traffic = small
    params = init_params(build_model(arch(config, traffic)),
                         torch.Generator().manual_seed(0))
    ours = dict(params.named_parameters())
    theirs = weights.draw(config, "cpu")
    assert list(ours) == list(theirs)
    for k, v in theirs.items():
        assert v.dtype == ours[k].dtype and torch.equal(v, ours[k]), k
    for seed in (0, SEED % 2 ** 32, 2 ** 32 - 1):
        a = TokenPipeline(vocab=512, seq_len=64, batch_size=2, seed=seed)
        b = pipeline.TokenPipeline(512, 64, 2, seed=seed)
        for _ in range(3):
            assert np.array_equal(a.next_batch()["tokens"],
                                  b.next_batch()["tokens"])


def test_configuration_is_the_registrys_architecture(bench):
    from repro_torch.configs import get_arch
    from uvmbench.drivers.lm_train import ARCH_KEYS, arch
    config = spec.config("smollm-360m", bench)
    traffic = spec.traffic("train")
    assert arch(config, traffic) == get_arch(config["arch"])
    registry = get_arch(config["arch"])
    assert {k: config[k] for k in ARCH_KEYS} == {
        k: getattr(registry, k) for k in ARCH_KEYS}
    assert traffic["batch"] * traffic["seq_len"] == 16384


def test_model_flops_of_smollm_360m(bench):
    config = spec.config("smollm-360m", bench)
    assert lm_flops.matmul_params(config) == 361_758_720
    assert lm_flops.flops_per_token(config, 2048) == 2_548_039_680
    assert lm_flops.step_flops(config, 8, 2048) == 2_548_039_680 * 16384


def test_metrics_attach_by_cell(bench):
    names = {c: {m["name"] for m in spec.cell_metrics(c, bench, s)}
             for c in ("paper11.oversub", "paper-pairs.shared", CELL)
             for s in ("per_layer",)}
    sweep = {m["name"] for m in bench["per_layer"]
             if m["moves"] == "sim_accesses_per_s"}
    train = {"train_mfu", "train_idle_pct", "train_device_ms_per_step"}
    assert len(sweep) == 12
    assert names["paper11.oversub"] == names["paper-pairs.shared"] == sweep
    assert names[CELL] == train
    e2e = {c: [m["name"] for m in spec.cell_metrics(c, bench, "end_to_end")]
           for c in ("paper11.oversub", CELL)}
    assert e2e == {"paper11.oversub": ["sim_accesses_per_s", "setup_s"],
                   CELL: ["train_tokens_per_s", "setup_s"]}


def test_train_metric_readers():
    rows = [{"tokens": 16384, "model_flops": 4.0e13}] * 2
    record = {"passes": 2, "rows": rows, "window_s": 4.0,
              "trace": {"busy_s": 3.0, "window_s": 4.0}}

    def read(name, rec=record):
        return spec.metric_reader(name).read(rec)
    assert read("train_mfu") == pytest.approx(100 * 8e13 / (4.0 * 67e12))
    assert read("train_idle_pct") == pytest.approx(25.0)
    assert read("train_device_ms_per_step") == pytest.approx(1500.0)
    bare = {"passes": 2, "rows": rows, "window_s": 4.0, "trace": {}}
    assert read("train_idle_pct", bare) is None
    assert read("train_device_ms_per_step", bare) is None
    assert read("train_mfu", {"rows": [], "window_s": 4.0}) is None


def test_rounding_look_at_a_small_size(small):
    # the reference against itself: float64 follows the float32 steps to
    # rounding, and the fan-in draw spreads attention's logits less
    from uvmbench.reference.lm import weights
    from uvmbench.tools import lm_rounding
    config, traffic = small
    out = lm_rounding.read_seed(config, traffic, SEED, "cpu")
    n = config["n_layers"]
    for part in ("draw", "fan_in"):
        look = out[part]["look"]
        assert len(look["rms_in"]) == n and len(look["grad_in"]) == n + 1
        for variant in ("block2", "float64"):
            gaps = out[part]["gaps"][variant]
            assert gaps["readings"]["mismatches"] == 0
            assert gaps["readings"]["change_gap_median"] < 1e-3, gaps
            assert sum(g["leaves"] for g in gaps["groups"]) == len(
                weights.draw(config, "cpu"))
    assert max(out["fan_in"]["look"]["logit_std"]) < max(
        out["draw"]["look"]["logit_std"]) / 3
