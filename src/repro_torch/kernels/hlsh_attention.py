"""K2: HLSH masked attention -- wrapper of ``csrc/hlsh_attention.cu``.

Replaces the reference's Pallas kernel
``repro.kernels.hlsh_attention._hlsh_kernel``.  The share map is applied by
the caller (``ops.hlsh_attention``), as in the reference.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

MAX_D = 128


def hlsh_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         keep: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: softmax((q*keep)(k*keep)^T/sqrt(D)) v."""
    d = q.shape[-1]
    kf = keep[..., None].to(q.dtype)
    logits = torch.einsum("bnd,bmd->bnm", q * kf, k * kf) / math.sqrt(d)
    return torch.einsum("bnm,bmd->bnd",
                        torch.softmax(logits.float(), dim=-1).to(q.dtype), v)


def hlsh_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   keep: torch.Tensor) -> torch.Tensor:
    """Masked-attention core.  q/k/v: (B, N, D) float32; keep: (B, N)
    float32 {0, 1}.  Launches K2 for CUDA tensors (counted in
    ``hlsh_attention.launches``); CPU tensors take the plain version."""
    if q.device.type == "cpu":
        return hlsh_attention_plain(q, k, v, keep)
    b, n, d = q.shape
    for name, t, shape in (("q", q, (b, n, d)), ("k", k, (b, n, d)),
                           ("v", v, (b, n, d)), ("keep", keep, (b, n))):
        if (t.device != q.device or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(
                f"hlsh_attention: {name} must be a contiguous float32 tensor "
                f"of shape {shape} on {q.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    if not 0 < d <= MAX_D:
        raise ValueError(f"hlsh_attention: head dim {d} not in 1..{MAX_D}")
    lib = build.load("hlsh_attention")
    fn = lib.hlsh_attention_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), keep.data_ptr(),
             out.data_ptr(), b, n, d, stream)
    build.check(lib, err, "hlsh_attention")
    hlsh_attention.launches += 1
    return out


hlsh_attention.launches = 0
