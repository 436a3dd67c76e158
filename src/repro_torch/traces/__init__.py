"""Trace substrate: benchmark access-pattern generators + GPU execution model.

Replaces the paper's GPGPU-Sim trace source.  Each benchmark generator emits
per-CTA page-level access streams derived from the benchmark's actual
algorithmic access pattern; the GPU model schedules CTAs onto SMs and merges
per-SM streams into the GMMU-arrival-order trace the predictor trains on.
"""
from repro_torch.traces.trace import Trace, PAGE_SIZE, BASIC_BLOCK_PAGES, ROOT_PAGES
from repro_torch.traces.generators import BENCHMARKS, generate_benchmark
from repro_torch.traces.gpu_model import GPUModel, GPUModelConfig

__all__ = [
    "Trace", "PAGE_SIZE", "BASIC_BLOCK_PAGES", "ROOT_PAGES",
    "BENCHMARKS", "generate_benchmark", "GPUModel", "GPUModelConfig",
]
