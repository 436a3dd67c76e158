"""K2: HLSH masked attention -- wrapper of ``csrc/hlsh_attention.cu``.

Replaces the reference's Pallas kernel
``repro.kernels.hlsh_attention._hlsh_kernel``.  The share map is applied by
the caller (``ops.hlsh_attention``), as in the reference.
:func:`hlsh_geometry` picks the kernel's tiling from the shape.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import build

MAX_D = 128
#: element types K2 takes, with their code in the C entry point
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: K2's tilings, in the order of their code in the C entry point
TILINGS = ("general", "warp")
#: the warp-per-row tiling: largest N and D, rows (warps) per block, and
#: the shared memory a block may take (q, k and v staged as float32)
WARP_N = 32
WARP_MAX_D = 64
WARP_ROWS = 4
WARP_SMEM = 48 * 1024


class HlshGeometry(NamedTuple):
    """K2's tiling (one of ``TILINGS``) and the batch rows of a block."""
    tiling: str
    rows: int

    def name(self) -> str:
        if self.tiling == "warp":
            return f"a warp per row, {self.rows} rows/block"
        return "general: 32 query rows a block, keys in tiles of 32"


@functools.lru_cache(maxsize=None)
def hlsh_geometry(b: int, n: int, d: int, dtype: torch.dtype
                  ) -> HlshGeometry:
    """The tiling of ``b`` rows of ``n`` tokens of dim ``d`` in ``dtype``: a
    warp per row where a row's queries and keys fit one warp (N <= 32,
    D <= 64), as many rows a block as the shared memory takes (at most 4),
    else the general one (a row's query tile a block).  Both types stage as
    float32, so ``dtype`` only has to be one K2 takes."""
    if dtype not in DTYPES:
        raise ValueError(f"hlsh_attention: dtype {dtype} is not one of "
                         f"{sorted(map(str, DTYPES))}")
    if n <= WARP_N and d <= WARP_MAX_D:
        per_row = 3 * 4 * (-(-n * d // 4) * 4)
        return HlshGeometry("warp", max(1, min(b, WARP_ROWS,
                                               WARP_SMEM // per_row)))
    return HlshGeometry("general", 1)


def hlsh_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         keep: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: softmax((q*keep)(k*keep)^T/sqrt(D)) v."""
    d = q.shape[-1]
    kf = keep[..., None].to(q.dtype)
    logits = torch.einsum("bnd,bmd->bnm", q * kf, k * kf) / math.sqrt(d)
    return torch.einsum("bnm,bmd->bnd",
                        torch.softmax(logits.float(), dim=-1).to(q.dtype), v)


@functools.lru_cache(maxsize=None)
def _entry():
    """The C entry point, bound once."""
    lib = build.load("hlsh_attention")
    fn = lib.hlsh_attention_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    return lib, fn


def hlsh_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   keep: torch.Tensor) -> torch.Tensor:
    """Masked-attention core.  q/k/v: (B, N, D) float32 or bf16; keep:
    (B, N) {0, 1} in q's type.  Launches K2 for CUDA tensors (counted in
    ``hlsh_attention.launches``); CPU tensors take the plain version."""
    if q.device.type == "cpu":
        return hlsh_attention_plain(q, k, v, keep)
    b, n, d = q.shape
    if q.dtype not in DTYPES:
        raise ValueError(f"hlsh_attention: dtype {q.dtype} is not one of "
                         f"{sorted(map(str, DTYPES))}")
    for name, t, shape in (("q", q, (b, n, d)), ("k", k, (b, n, d)),
                           ("v", v, (b, n, d)), ("keep", keep, (b, n))):
        if (t.device != q.device or t.dtype != q.dtype
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(
                f"hlsh_attention: {name} must be a contiguous {q.dtype} "
                f"tensor of shape {shape} on {q.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    if not 0 < d <= MAX_D:
        raise ValueError(f"hlsh_attention: head dim {d} not in 1..{MAX_D}")
    geo = hlsh_geometry(b, n, d, q.dtype)
    lib, fn = _entry()
    out = torch.empty_like(q)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), keep.data_ptr(),
             out.data_ptr(), b, n, d, DTYPES[q.dtype],
             TILINGS.index(geo.tiling), geo.rows,
             build.stream_handle(q.device))
    build.check(lib, err, "hlsh_attention")
    hlsh_attention.launches += 1
    return out


hlsh_attention.launches = 0
