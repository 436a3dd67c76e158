"""Plain PyTorch oracles of the kernels, mirroring the reference's
``repro.kernels.ref``."""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import (
    flash_attention_plain as flash_attention_ref)
from repro_torch.kernels.hlsh_attention import hlsh_attention_plain
from repro_torch.kernels.int4_matmul import (
    int4_matmul_plain as int4_matmul_ref)

__all__ = ["flash_attention_ref", "hlsh_attention_ref", "int4_matmul_ref"]


def hlsh_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       keep: torch.Tensor, share_src: torch.Tensor
                       ) -> torch.Tensor:
    """q/k/v: (B, N, D); keep: (B, N) {0,1}; share_src: (B, N) source row
    per output row."""
    out = hlsh_attention_plain(q, k, v, keep)
    return torch.gather(out, 1, share_src.long()[..., None].expand_as(out))
