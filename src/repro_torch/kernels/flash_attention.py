"""K4: flash (online-softmax) multi-head attention -- wrapper of
``csrc/flash_attention.cu``.

Replaces the reference's Pallas kernel
``repro.kernels.flash_attention._flash_kernel``.  The reference Transformer
family's full softmax attention runs it at inference on the card (heads as
``(B, H, S, D)``, ``causal=False``, ``Hkv = H``).  The reference has no
backward for it, so neither has the port: training keeps the differentiable
``core.attention.full_attention``.  :func:`flash_geometry` picks the
kernel's tiling from the shape.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import build

MAX_D = 128
#: element types K4 takes, with their code in the C entry point
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: K4's tilings, in the order of their code in the C entry point
TILINGS = ("general", "warp")
#: the warp-per-head tiling: largest Sq and Sk, largest D, heads per block
WARP_ROWS = 32
WARP_MAX_D = 64
WARP_HEADS = 2


class FlashGeometry(NamedTuple):
    """K4's tiling (one of ``TILINGS``) and the heads of a block."""
    tiling: str
    heads: int

    def name(self) -> str:
        if self.tiling == "warp":
            return f"a warp per head, {self.heads} heads/block"
        return "general: 32 query rows a block, keys in tiles of 32"


@functools.lru_cache(maxsize=None)
def flash_geometry(bh: int, sq: int, sk: int, d: int) -> FlashGeometry:
    """The tiling of ``bh`` heads of ``sq`` queries over ``sk`` keys of dim
    ``d``: a warp per head where the head's queries and keys fit one warp's
    register tiles, else the general one (a head's query tile a block)."""
    if sq <= WARP_ROWS and sk <= WARP_ROWS and d <= WARP_MAX_D:
        return FlashGeometry("warp", min(bh, WARP_HEADS))
    return FlashGeometry("general", 1)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = False) -> torch.Tensor:
    """The plain PyTorch version (the reference's ``flash_attention_ref``):
    q (B, H, Sq, D), k/v (B, Hkv, Sk, D), softmax in float32."""
    b, h, sq, d = q.shape
    group = h // k.shape[1]
    kx = torch.repeat_interleave(k, group, dim=1)
    vx = torch.repeat_interleave(v, group, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, kx) / math.sqrt(d)
    if causal:
        sk = kx.shape[2]
        mask = (torch.arange(sq, device=q.device)[:, None] + (sk - sq)
                >= torch.arange(sk, device=q.device)[None, :])
        logits = logits.masked_fill(~mask, -1e30)
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs.to(q.dtype), vx)


@functools.lru_cache(maxsize=None)
def _entry():
    """The C entry point, bound once."""
    lib = build.load("flash_attention")
    fn = lib.flash_attention_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [
        ctypes.c_void_p]
    return lib, fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> torch.Tensor:
    """q (B, H, Sq, D), k/v (B, Hkv, Sk, D) with H % Hkv == 0, float32 or
    bf16 -> (B, H, Sq, D) in q's type.  Launches K4 for CUDA tensors
    (counted in ``flash_attention.launches``); CPU tensors take the plain
    version."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal)
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"flash_attention: q and k/v must be 4-D, got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if q.dtype not in DTYPES:
        raise ValueError(f"flash_attention: dtype {q.dtype} is not one of "
                         f"{sorted(map(str, DTYPES))}")
    if hkv < 1 or h % hkv:
        raise ValueError(f"flash_attention: {h} heads are not a multiple of "
                         f"{hkv} kv heads")
    for name, t, shape in (("q", q, (b, h, sq, d)), ("k", k, (b, hkv, sk, d)),
                           ("v", v, (b, hkv, sk, d))):
        if (t.device != q.device or t.dtype != q.dtype
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(
                f"flash_attention: {name} must be a contiguous {q.dtype} "
                f"tensor of shape {shape} on {q.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    if not 0 < d <= MAX_D or sk < 1:
        raise ValueError(f"flash_attention: head dim {d} not in 1..{MAX_D} "
                         f"or no keys (Sk = {sk})")
    geo = flash_geometry(b * h, sq, sk, d)
    lib, fn = _entry()
    out = torch.empty_like(q)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h,
             hkv, sq, sk, d, int(causal), DTYPES[q.dtype],
             TILINGS.index(geo.tiling), geo.heads,
             build.stream_handle(q.device))
    build.check(lib, err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
