"""The reference's frozen trace generators give the port's traces byte for
byte."""
import numpy as np
import pytest


@pytest.mark.parametrize("bench,seed", [("ATAX", 0), ("NW", 3),
                                        ("Hotspot", 2 ** 31 + 5),
                                        ("2DCONV", 17)])
def test_benchmark_traces_equal_the_ports(bench, seed):
    from repro_torch.traces import GPUModel, generate_benchmark
    from repro_torch.traces.gpu_model import GPUModelConfig
    from uvmbench.reference.traces import GPUModel as RGPUModel
    from uvmbench.reference.traces import generate_benchmark as rgen
    from uvmbench.reference.traces.gpu_model import (GPUModelConfig as
                                                     RGPUModelConfig)
    ours = GPUModel(GPUModelConfig(seed=seed)).run(
        generate_benchmark(bench, scale=0.25, seed=seed))
    theirs = RGPUModel(RGPUModelConfig(seed=seed)).run(
        rgen(bench, scale=0.25, seed=seed))
    assert ours.accesses.tobytes() == theirs.accesses.tobytes()
    assert ours.n_instructions == theirs.n_instructions
    assert ours.array_bases == theirs.array_bases


@pytest.mark.parametrize("pair,seed", [("ATAX+Pathfinder", 0),
                                       ("Backprop+NW", 9)])
def test_pair_traces_equal_the_ports(pair, seed):
    from repro_torch.traces.interleave import (build_mt_trace,
                                               mt_component_trace)
    from uvmbench.reference.traces import interleave as ref
    ours = build_mt_trace(pair, scale=0.25, seed=seed).split(0.6)[0]
    theirs = ref.build_mt_trace(pair, scale=0.25, seed=seed).split(0.6)[0]
    assert ours.accesses.tobytes() == theirs.accesses.tobytes()
    assert ours.meta == theirs.meta
    for t in (0, 1):
        a, b = mt_component_trace(ours, t), ref.mt_component_trace(theirs, t)
        assert np.array_equal(a.pages, b.pages)
        assert a.n_instructions == b.n_instructions
