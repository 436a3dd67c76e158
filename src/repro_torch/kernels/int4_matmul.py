"""K3: packed-int4 weight matmul -- wrapper of ``csrc/int4_matmul.cu``.

Replaces the reference's Pallas kernel
``repro.kernels.int4_matmul._int4_kernel``.  The quantized simplified
predictor's weight products run it at inference on the card, on weights
packed by ``core.quantize.pack_int4_like_fake_quant``.  The kernel has three
variants (narrow, wide, general; see the source) in nine compiled bodies;
:func:`int4_variant` picks one body from the shape and the pointers.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

#: element types of x and the output K3 takes, with their code in the C
#: entry point
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the kernel's bodies, in the order of their code in the C entry point:
#: ``narrowN`` holds up to N output columns (``x2``: two rows a thread),
#: ``wideK`` up to K rows of the weight
VARIANTS = ("general", "narrow16", "narrow32", "narrow32x2", "narrow48",
            "narrow48x2", "narrow64", "wide16", "wide32")
#: largest K and N of the narrow variant
NARROW_MAX = 64
#: the wide variant keeps K x (16 bytes of columns) weights in registers,
#: and its row tiles of 32 lie on the grid's y dimension (at most 65535)
WIDE_MAX_WEIGHTS = 128
WIDE_MAX_ROWS = 65535 * 32


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


def int4_variant(m: int, kdim: int, n: int, dtype: torch.dtype,
                 x_ptr: int = 0, out_ptr: int = 0) -> str:
    """The body K3 runs for an (M, K) x (K, N) product of ``dtype`` whose
    x and output start at ``x_ptr`` and ``out_ptr``.  Narrow needs whole
    16-byte chunks in the rows of x and of the output and both pointers
    16-byte aligned; it holds N in the next multiple of 16, and takes two
    rows a thread where x's rows are at most 4 chunks and 16 < N <= 48.
    Wide needs whole chunks in the output's rows only (x is read by
    scalars), K x (16 bytes of columns) weights in registers and at most
    ``WIDE_MAX_ROWS`` rows.  Everything else is general."""
    vec = 16 // dtype.itemsize
    if n % vec or out_ptr % 16:
        return "general"
    if n <= NARROW_MAX:
        if kdim > NARROW_MAX or kdim % vec or x_ptr % 16:
            return "general"
        two = kdim // vec <= 4 and 16 < n <= 48
        return f"narrow{-(-n // 16) * 16}" + ("x2" if two else "")
    if kdim * vec > WIDE_MAX_WEIGHTS or m > WIDE_MAX_ROWS:
        return "general"
    return "wide16" if kdim <= 16 else "wide32"


@functools.lru_cache(maxsize=None)
def _entry():
    """The C entry point, bound once."""
    lib = build.load("int4_matmul")
    fn = lib.int4_matmul_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    return lib, fn


def _device_scale(scale, device: torch.device) -> torch.Tensor:
    """The scale as one float32 on ``device``: a one-element float32
    tensor already there is used as it is."""
    if not (torch.is_tensor(scale) and scale.dtype == torch.float32
            and scale.device == device):
        scale = torch.as_tensor(scale, dtype=torch.float32).to(device)
    if scale.numel() != 1:
        raise ValueError(f"int4_matmul: scale must be one value, got shape "
                         f"{tuple(scale.shape)}")
    return scale


def int4_matmul(x: torch.Tensor, w_packed: torch.Tensor,
                scale) -> torch.Tensor:
    """x (M, K) float32 or bf16, w_packed (K, N/2) uint8, scale a float or a
    one-element tensor -> (M, N) in x's type: ``(x @ W)`` accumulated in
    float32, rounded to x's type, times ``scale`` in x's type.  Launches K3
    for CUDA tensors (counted in ``int4_matmul.launches``); CPU tensors take
    the plain version."""
    dev = x.device
    if dev.type == "cpu":
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
            or w_packed.device != dev):
        raise ValueError(
            f"int4_matmul: w_packed must be uint8 of shape ({kdim}, N/2) on "
            f"{dev}, got {w_packed.dtype} {tuple(w_packed.shape)} on "
            f"{w_packed.device}")
    if not (x.is_contiguous() and w_packed.is_contiguous()):
        raise ValueError("int4_matmul: x and w_packed must be contiguous")
    if kdim < 1 or m >= 2 ** 31 or kdim >= 2 ** 31 or n >= 2 ** 31:
        raise ValueError(f"int4_matmul: shape ({m}, {kdim}) x ({kdim}, {n}) "
                         "outside the kernel's int32 indexing")
    scale_t = _device_scale(scale, dev)
    out = x.new_empty((m, n))
    x_ptr, out_ptr = x.data_ptr(), out.data_ptr()
    variant = int4_variant(m, kdim, n, x.dtype, x_ptr, out_ptr)
    lib, fn = _entry()
    err = fn(x_ptr, w_packed.data_ptr(), scale_t.data_ptr(), out_ptr, m,
             kdim, n, DTYPES[x.dtype], VARIANTS.index(variant),
             build.stream_handle(dev))
    build.check(lib, err, "int4_matmul")
    int4_matmul.launches += 1
    return out


int4_matmul.launches = 0
