"""Plain PyTorch oracle of the HLSH kernel, mirroring the reference's
``repro.kernels.ref.hlsh_attention_ref``."""
from __future__ import annotations

import torch

from repro_torch.kernels.hlsh_attention import hlsh_attention_plain


def hlsh_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       keep: torch.Tensor, share_src: torch.Tensor
                       ) -> torch.Tensor:
    """q/k/v: (B, N, D); keep: (B, N) {0,1}; share_src: (B, N) source row
    per output row."""
    out = hlsh_attention_plain(q, k, v, keep)
    return torch.gather(out, 1, share_src.long()[..., None].expand_as(out))
