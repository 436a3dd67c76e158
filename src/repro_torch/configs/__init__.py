"""Architecture configs: one module per assigned architecture plus the
paper's own predictor config.  ``get_arch(id)`` / ``--arch <id>``."""
from repro_torch.configs.arch import ArchConfig, SHAPES, ShapeSpec
from repro_torch.configs.registry import ARCHS, get_arch, list_archs

__all__ = ["ArchConfig", "ARCHS", "get_arch", "list_archs", "SHAPES",
           "ShapeSpec"]
