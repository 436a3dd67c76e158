"""Model zoo: the 10 assigned architectures in PyTorch (the reference's
``repro.models``).

Architectures are described by ``ArchConfig`` (``repro_torch.configs``): a
sequence of homogeneous *segments*, each a repeated block pattern (attention
+ dense FFN, attention + MoE, SSD, RG-LRU, local attention, ...).  Every
attention block but the windowed one runs on K4.
"""
from repro_torch.models.builder import (
    build_model, init_params, train_loss, prefill, decode, Model,
)

__all__ = ["build_model", "init_params", "train_loss", "prefill", "decode",
           "Model"]
