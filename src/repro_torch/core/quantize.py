"""Quantization (paper §6): clamp weights and activations to [-8, +8] on a
4-bit integer grid, trained with straight-through estimation; plus the int4
pack/unpack of the quantized inference path (kept in numpy, as in the
reference ``repro.core.quantize``).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
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


def quantize_int4(x: np.ndarray) -> Tuple[np.ndarray, float]:
    """Real int4 quantization: returns packed uint8 (two nibbles each) and
    the per-tensor scale."""
    s = max(float(np.max(np.abs(x))), 1e-6) / (-QMIN)
    q = np.clip(np.round(x / s), QMIN, QMAX).astype(np.int8)
    u = (q - int(QMIN)).astype(np.uint8)           # 0..15
    flat = u.reshape(-1)
    if flat.size % 2:
        flat = np.concatenate([flat, np.zeros(1, np.uint8)])
    packed = (flat[0::2] << 4) | flat[1::2]
    return packed, s


def dequantize_int4(packed: np.ndarray, scale: float, size: int,
                    shape) -> np.ndarray:
    hi = (packed >> 4).astype(np.int8)
    lo = (packed & 0xF).astype(np.int8)
    flat = np.empty(packed.size * 2, np.int8)
    flat[0::2] = hi
    flat[1::2] = lo
    return ((flat[:size] + int(QMIN)) * scale).reshape(shape).astype(np.float32)
