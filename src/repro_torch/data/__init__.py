"""Data pipeline substrate."""
from repro_torch.data.lm_pipeline import TokenPipeline

__all__ = ["TokenPipeline"]
