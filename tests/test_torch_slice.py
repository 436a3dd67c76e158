"""The slice end to end on the CPU: Backprop at scale 0.25 (3.7k accesses,
HLSH attention, not the bypass), 60 training steps, half the working set
on the device, LRU.  The JAX service and the port agree on the predictions
when they hold the same parameters; the port's replay of JAX's predictions
equals the legacy engine's; the port's own sweep row lands next to it."""
import dataclasses

import jax
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core.service import PredictorService as RefService
from repro.traces import GPUModel as RefGPUModel
from repro.traces import generate_benchmark as ref_generate
from repro_torch.core.convert import params_from_jax
from repro_torch.core.service import PredictorService
from repro_torch.uvm import sweep
from repro_torch.uvm.config import UVMConfig
from repro_torch.uvm.prefetchers import LearnedPrefetcher
from repro_torch.uvm.replay_core import ReplayRequest, get_backend
from repro_torch.uvm.simulator import UVMSimulator

BENCH, SCALE, STEPS, FRAC = "Backprop", 0.25, 60, 0.5


@pytest.fixture(scope="module")
def trace():
    return sweep.load_trace(BENCH, SCALE, 0, 0.6)


@pytest.fixture(scope="module")
def reference(trace):
    """The JAX service trained on the same trace: (service, predictions)."""
    svc = RefService(steps=STEPS)
    svc.fit(trace)
    return svc, svc.predict_trace()


def test_port_trace_is_the_reference_trace(trace):
    ref, _ = RefGPUModel().run(ref_generate(BENCH, scale=SCALE)).split(0.6)
    assert np.array_equal(trace.accesses, ref.accesses)
    assert trace.n_instructions == ref.n_instructions
    assert 3000 < len(trace) < 4500


def test_jax_params_give_the_same_predictions(trace, reference):
    ref_svc, ref_preds = reference
    assert ref_svc.result.cfg.attention == "hlsh"
    # not vacuous: most accesses carry a prediction
    assert (ref_preds >= 0).mean() > 0.5
    svc = PredictorService(steps=1, device="cpu")
    svc.fit(trace)
    assert dataclasses.asdict(svc.result.cfg) == dataclasses.asdict(
        ref_svc.result.cfg)
    svc.result.model.load_state_dict(
        params_from_jax(jax.tree.map(np.asarray, ref_svc.result.params)))
    preds = svc.predict_trace()
    assert preds.shape == ref_preds.shape
    assert (preds == ref_preds).mean() >= 0.995


def _learned_request(trace, preds):
    cfg = UVMConfig(device_pages=int(trace.working_set_pages * FRAC))
    return ReplayRequest(trace, LearnedPrefetcher(
        preds, extra_latency_cycles=cfg.cycles_per_us), cfg)


def test_replay_of_jax_predictions_equals_legacy(trace, reference):
    _, ref_preds = reference
    req = _learned_request(trace, ref_preds)
    (got,) = get_backend("cuda", device="cpu").replay([req])
    want = UVMSimulator(req.config).run(trace, _learned_request(
        trace, ref_preds).prefetcher)
    assert got.backend == "cuda"
    for f in ("hits", "late", "faults", "prefetch_issued", "prefetch_used",
              "pages_migrated", "pages_evicted"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.cycles == pytest.approx(want.cycles, rel=1e-6)
    assert got.pcie_bytes == pytest.approx(want.pcie_bytes, rel=1e-6)
    assert got.prefetch_used > 0 and got.pages_evicted > 0


def test_port_sweep_row_lands_next_to_the_jax_replay(trace, reference):
    _, ref_preds = reference
    (want,) = get_backend("cuda", device="cpu").replay(
        [_learned_request(trace, ref_preds)])
    cell = sweep.SweepCell(BENCH, "learned", scale=SCALE, device_frac=FRAC,
                           service_steps=STEPS)
    (row,) = sweep.run_sweep([cell], device="cpu")
    assert row["backend"] == "cuda" and row["eviction"] == "lru"
    assert row["n_accesses"] == len(trace)
    assert row["train_seconds"] > 0 and row["predict_seconds"] > 0
    assert abs(row["hit_rate"] - want.hit_rate) <= 0.005


def test_port_training_reaches_the_reference_accuracy(trace, reference):
    ref_svc, _ = reference
    svc = PredictorService(steps=STEPS, device="cpu")
    res = svc.fit(trace)
    assert res.steps == STEPS
    assert res.metrics["top1"] >= ref_svc.result.metrics["top1"] - 0.05
    assert dataclasses.asdict(res.cfg) == dataclasses.asdict(
        ref_svc.result.cfg)
