"""K3: packed-int4 weight matmul -- wrapper of ``csrc/int4_matmul.cu``.

Replaces the reference's Pallas kernel
``repro.kernels.int4_matmul._int4_kernel``.  The quantized simplified
predictor's weight products run it at inference on the card, on weights
packed by ``core.quantize.pack_int4_like_fake_quant``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

#: element types of x and the output K3 takes, with their code in the C
#: entry point
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def unpack_int4(w_packed: torch.Tensor) -> torch.Tensor:
    """(K, N/2) uint8 -> (K, N) int32 values in [-8, 7]: hi nibble = even
    column, lo nibble = odd column, code = value + 8."""
    hi = (w_packed >> 4).to(torch.int32) - 8
    lo = (w_packed & 0xF).to(torch.int32) - 8
    return torch.stack([hi, lo], dim=-1).reshape(w_packed.shape[0], -1)


def int4_matmul_plain(x: torch.Tensor, w_packed: torch.Tensor,
                      scale) -> torch.Tensor:
    """The plain PyTorch version (the reference's ``int4_matmul_ref``):
    ``x @ (W * scale)`` with W unpacked in x's type."""
    return x @ (unpack_int4(w_packed).to(x.dtype) * scale)


def int4_matmul(x: torch.Tensor, w_packed: torch.Tensor,
                scale) -> torch.Tensor:
    """x (M, K) float32 or bf16, w_packed (K, N/2) uint8, scale a float or a
    one-element tensor -> (M, N) in x's type: ``(x @ W)`` accumulated in
    float32, rounded to x's type, times ``scale`` in x's type.  Launches K3
    for CUDA tensors (counted in ``int4_matmul.launches``); CPU tensors take
    the plain version."""
    if x.device.type == "cpu":
        return int4_matmul_plain(x, w_packed, scale)
    if x.dim() != 2 or w_packed.dim() != 2:
        raise ValueError(f"int4_matmul: x and w_packed must be 2-D, got "
                         f"{tuple(x.shape)} and {tuple(w_packed.shape)}")
    m, kdim = x.shape
    n = 2 * w_packed.shape[1]
    if x.dtype not in DTYPES:
        raise ValueError(f"int4_matmul: dtype {x.dtype} is not one of "
                         f"{sorted(map(str, DTYPES))}")
    if (w_packed.dtype != torch.uint8 or w_packed.shape[0] != kdim
            or w_packed.device != x.device):
        raise ValueError(
            f"int4_matmul: w_packed must be uint8 of shape ({kdim}, N/2) on "
            f"{x.device}, got {w_packed.dtype} {tuple(w_packed.shape)} on "
            f"{w_packed.device}")
    if not (x.is_contiguous() and w_packed.is_contiguous()):
        raise ValueError("int4_matmul: x and w_packed must be contiguous")
    if kdim < 1 or m >= 2 ** 31 or kdim >= 2 ** 31 or n >= 2 ** 31:
        raise ValueError(f"int4_matmul: shape ({m}, {kdim}) x ({kdim}, {n}) "
                         "outside the kernel's int32 indexing")
    scale_t = torch.as_tensor(scale, dtype=torch.float32).to(x.device)
    if scale_t.numel() != 1:
        raise ValueError(f"int4_matmul: scale must be one value, got shape "
                         f"{tuple(scale_t.shape)}")
    scale_t = scale_t.reshape(()).contiguous()
    lib = build.load("int4_matmul")
    fn = lib.int4_matmul_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), w_packed.data_ptr(), scale_t.data_ptr(),
             out.data_ptr(), m, kdim, n, DTYPES[x.dtype], stream)
    build.check(lib, err, "int4_matmul")
    int4_matmul.launches += 1
    return out


int4_matmul.launches = 0
