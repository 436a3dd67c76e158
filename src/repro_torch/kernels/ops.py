"""Public kernel entry points with the reference ``repro.kernels.ops``
signatures."""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.hlsh_attention import hlsh_attention as _hlsh_core
from repro_torch.kernels.int4_matmul import int4_matmul

__all__ = ["flash_attention", "hlsh_attention", "int4_matmul"]


def hlsh_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   keep: torch.Tensor, share_src: torch.Tensor
                   ) -> torch.Tensor:
    """Full HLSH semantics: masked attention core (K2 on CUDA tensors) plus
    the share map, an output-row gather."""
    out = _hlsh_core(q, k, v, keep)
    return torch.gather(out, 1, share_src.long()[..., None].expand_as(out))
