"""Quantization (paper §6): clamp weights and activations to [-8, +8] on a
4-bit integer grid, trained with straight-through estimation, and the
device-side int4 packer of the quantized inference path on K3
(:func:`pack_int4_like_fake_quant`).
"""
from __future__ import annotations

from typing import Tuple

import torch

QMIN, QMAX = -8.0, 7.0   # 16 levels, step 1.0, representable in 4 bits


def fake_quant(x: torch.Tensor, step: float = 1.0) -> torch.Tensor:
    """Round to the 4-bit grid in [-8, +8] with a straight-through gradient."""
    q = torch.clamp(torch.round(x / step), QMIN, QMAX) * step
    return x + (q - x).detach()


def fake_quant_tensor(x: torch.Tensor) -> torch.Tensor:
    """Per-tensor symmetric 4-bit fake quant: the grid step adapts to the
    tensor's dynamic range.  Activations use the unit grid of
    :func:`fake_quant`."""
    s = torch.clamp(x.detach().abs().max(), min=1e-6) / (-QMIN)
    q = torch.clamp(torch.round(x / s), QMIN, QMAX) * s
    return x + (q - x).detach()


def pack_int4_like_fake_quant(w: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pack a (K, N) weight for K3 with exactly the codes and scale of
    :func:`fake_quant_tensor` (float32, on w's device): returns the (K,
    ceil(N / 2)) uint8 codes (hi nibble = even column, code = value + 8) and
    the 0-d float32 scale, so ``codes * scale`` is the fake-quantized
    weight.  An odd N gets one zero column; the caller slices the product's
    last column off."""
    w = w.detach().float()
    s = torch.clamp(w.abs().max(), min=1e-6) / (-QMIN)
    codes = torch.clamp(torch.round(w / s), QMIN, QMAX)
    if codes.shape[1] % 2:
        codes = torch.nn.functional.pad(codes, (0, 1))
    u = (codes - QMIN).to(torch.uint8)                    # 0..15
    return ((u[:, 0::2] << 4) | u[:, 1::2]).contiguous(), s

