"""K4: flash (online-softmax) multi-head attention -- wrapper of
``csrc/flash_attention.cu``.

Replaces the reference's Pallas kernel
``repro.kernels.flash_attention._flash_kernel``.  The reference Transformer
family's full softmax attention runs it at inference on the card (heads as
``(B, H, S, D)``, ``causal=False``, ``Hkv = H``), and so does the LM zoo's
serving path (bf16, GQA, causal prefill and decode over the KV cache).  The
reference has no backward for it, so neither has the port: training keeps
the differentiable attention of each caller (``core.attention.
full_attention``, ``models.layers.attend_plain``).  :func:`flash_geometry`
picks the kernel's tiling from the shape, the type, the GQA group and the
mask; :func:`split_plan` the split tiling's key splits.

k and v may be views (a KV cache sliced to its live keys): their last two
dims must be dense (stride D, then 1), their batch and head strides are
free.  q is contiguous, and so is the output.

:func:`flash_attention_op` is K4 registered with ``torch.library`` as
``repro_torch::flash_attention``: on real tensors it calls
:func:`flash_attention` (the same launch, counted once); on fake tensors it
gives the output's shape and type and launches nothing; on DTensors it
shards by :func:`_k4_sharding` (batch, or heads with their kv heads;
:func:`register_k4_sharding`), and a
FLOP count (``torch.utils.flop_counter``) reads :func:`flash_attention_cost`,
the work the kernel does, not the plain version's S x S logits.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Tuple

import torch
import torch.utils.flop_counter

from repro_torch.kernels import build

MAX_D = 128
#: element types K4 takes, with their code in the C entry point
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: K4's tilings, in the order of their code in the C entry point
TILINGS = ("general", "warp", "mma", "split")
#: the warp-per-head tiling: largest Sq and Sk, largest D, heads per block
WARP_ROWS = 32
WARP_MAX_D = 64
WARP_HEADS = 2
#: the tensor-core tilings: head dims (bf16 only), q rows of a block (the
#: split tiling's most rows G x Sq), keys of a tile, and the least Sq of
#: the mma tiling (a warp's 16-row slice)
MMA_DIMS = (64, 128)
MMA_ROWS = 64
MMA_KEYS = 64
MMA_MIN_SQ = 16
#: the split tiling aims at this many blocks: 4 a streaming multiprocessor
#: of the H100's 132
SPLIT_BLOCKS = 4 * 132


class FlashGeometry(NamedTuple):
    """K4's tiling (one of ``TILINGS``) and the heads of a block."""
    tiling: str
    heads: int

    def name(self) -> str:
        if self.tiling == "warp":
            return f"a warp per head, {self.heads} heads/block"
        if self.tiling == "mma":
            return (f"mma: {MMA_ROWS} query rows a block on the tensor "
                    f"cores, keys in tiles of {MMA_KEYS}")
        if self.tiling == "split":
            return ("split: a kv head's G x Sq rows a block on the tensor "
                    "cores, keys in splits, merged")
        return "general: 32 query rows a block, keys in tiles of 32"


@functools.lru_cache(maxsize=None)
def flash_geometry(bh: int, sq: int, sk: int, d: int,
                   dtype: torch.dtype = torch.float32, group: int = 1,
                   causal: bool = False) -> FlashGeometry:
    """The tiling of ``bh`` heads of ``sq`` queries over ``sk`` keys of dim
    ``d`` in ``dtype``, ``group`` query heads to a kv head.  bf16 at D = 64
    or 128 (no mask, or a causal one with Sk >= Sq) runs on the tensor
    cores: the split tiling where a kv head's G x Sq rows fit one block
    (decode), else the mma tiling where Sq fills a warp's 16-row slice
    (prefill).  Everything else: a warp per head where the head's queries
    and keys fit one warp's register tiles, else the general one."""
    if (dtype == torch.bfloat16 and d in MMA_DIMS
            and not (causal and sq > sk)):
        if group * sq <= MMA_ROWS:
            return FlashGeometry("split", 1)
        if sq >= MMA_MIN_SQ:
            return FlashGeometry("mma", 1)
    if sq <= WARP_ROWS and sk <= WARP_ROWS and d <= WARP_MAX_D:
        return FlashGeometry("warp", min(bh, WARP_HEADS))
    return FlashGeometry("general", 1)


@functools.lru_cache(maxsize=None)
def split_plan(pairs: int, sk: int, rows: int) -> Tuple[int, int, int]:
    """The split tiling's (splits, keys a split, key groups) for ``pairs``
    (batch, kv head) pairs of ``rows`` = G x Sq rows over ``sk`` keys:
    enough splits of whole key tiles that the blocks fill the card
    (``SPLIT_BLOCKS``, at most one tile a split), and 4 / (16-row slices)
    warps sharing each key tile."""
    tiles = -(-sk // MMA_KEYS)
    splits = max(1, min(tiles, -(-SPLIT_BLOCKS // pairs)))
    split_keys = -(-tiles // splits) * MMA_KEYS
    return -(-sk // split_keys), split_keys, 4 // -(-rows // 16)


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
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])
    return lib, fn


def _dense_rows(t: torch.Tensor) -> bool:
    """Whether the last two dims of ``t`` are dense: stride 1, then D."""
    n, d = t.shape[2], t.shape[3]
    return (t.stride(3) == 1 or d == 1) and (t.stride(2) == d or n == 1)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise unless q is a contiguous (B, H, Sq, D) tensor and k, v are
    (B, Hkv, Sk, D) tensors of its type and device, H % Hkv == 0, whose
    last two dims are dense."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"flash_attention: q and k/v must be 4-D, got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if hkv < 1 or h % hkv:
        raise ValueError(f"flash_attention: {h} heads are not a multiple of "
                         f"{hkv} kv heads")
    if not q.is_contiguous():
        raise ValueError("flash_attention: q must be contiguous")
    for name, t in (("k", k), ("v", v)):
        if (t.device != q.device or t.dtype != q.dtype
                or tuple(t.shape) != (b, hkv, sk, d) or not _dense_rows(t)):
            raise ValueError(
                f"flash_attention: {name} must be a {q.dtype} tensor of "
                f"shape {(b, hkv, sk, d)} on {q.device} whose last two dims "
                f"are dense (strides ({d}, 1)), got {t.dtype} "
                f"{tuple(t.shape)} with strides {t.stride()} on {t.device}")


def _check_aligned(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """The tensor-core tilings copy rows 16 bytes at a time: q, k and v must
    start on 16 bytes, and k's and v's batch and head strides be whole
    16-byte chunks."""
    chunk = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16 or any(
                t.stride(i) % chunk for i in (0, 1) if t.shape[i] > 1):
            raise ValueError(
                f"flash_attention: {name} must start on 16 bytes with batch "
                f"and head strides of whole 16-byte chunks for K4's "
                f"tensor-core tilings, got strides {t.stride()} at "
                f"{t.data_ptr():#x}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> torch.Tensor:
    """q (B, H, Sq, D) contiguous, k/v (B, Hkv, Sk, D) with dense last two
    dims and H % Hkv == 0, float32 or bf16 -> (B, H, Sq, D) in q's type.
    Launches K4 for CUDA tensors (counted in ``flash_attention.launches``;
    the split tiling's merge pass is part of the one call); CPU tensors
    take the plain version."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal)
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if q.dtype not in DTYPES:
        raise ValueError(f"flash_attention: dtype {q.dtype} is not one of "
                         f"{sorted(map(str, DTYPES))}")
    if not 0 < d <= MAX_D or sk < 1:
        raise ValueError(f"flash_attention: head dim {d} not in 1..{MAX_D} "
                         f"or no keys (Sk = {sk})")
    group = h // hkv
    geo = flash_geometry(b * h, sq, sk, d, q.dtype, group, causal)
    splits, split_keys, key_groups = 1, 0, 1
    part_o = part_ml = None
    if geo.tiling in ("mma", "split"):
        _check_aligned(q, k, v)
    if geo.tiling == "split":
        splits, split_keys, key_groups = split_plan(b * hkv, sk, group * sq)
        n_ml = b * hkv * splits * key_groups * group * sq * 2
        scratch = torch.empty(n_ml * (d // 2 + 1), dtype=torch.float32,
                              device=q.device)
        part_ml = scratch.data_ptr()
        part_o = part_ml + 4 * n_ml
    lib, fn = _entry()
    out = torch.empty_like(q)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             part_o, part_ml, b, h, hkv, sq, sk, d, k.stride(0), k.stride(1),
             v.stride(0), v.stride(1), int(causal), DTYPES[q.dtype],
             TILINGS.index(geo.tiling), geo.heads, splits, split_keys,
             key_groups, build.stream_handle(q.device))
    build.check(lib, err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def causal_pairs(sq: int, sk: int, causal: bool) -> int:
    """The (query, key) pairs a mask lets through: query i sees keys up to
    ``i + Sk - Sq`` when causal, all Sk otherwise."""
    if not causal:
        return sq * sk

    def upto(n):        # sum over j = 1..n of min(j, Sk), 0 for n <= 0
        if n <= 0:
            return 0
        m = min(n, sk)
        return m * (m + 1) // 2 + (n - m) * sk

    return upto(sk) - upto(sk - sq)


def flash_attention_cost(q_shape, k_shape, causal: bool,
                         itemsize: int) -> Tuple[int, int]:
    """(operations, bytes) of one K4 call, the work its bound counts: a
    product of D in each of its two matrix products for every (query, key)
    pair the mask lets through; q, k, v read once and the output written
    once."""
    b, h, sq, d = q_shape
    hkv, sk = k_shape[1], k_shape[2]
    ops = 4 * b * h * d * causal_pairs(sq, sk, causal)
    nbytes = itemsize * (2 * b * h * sq * d + 2 * b * hkv * sk * d)
    return ops, nbytes


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool) -> torch.Tensor:
    """K4 as a registered op (see the module docstring)."""
    return flash_attention(q, k, v, causal)


@flash_attention_op.register_fake
def _k4_fake(q, k, v, causal):
    _check(q, k, v)
    return torch.empty_like(q, memory_format=torch.contiguous_format)


def _k4_flops(q_shape, k_shape, v_shape, causal, *args, out_shape=None,
              **kwargs) -> int:
    return flash_attention_cost(q_shape, k_shape, causal, 1)[0]


torch.utils.flop_counter.register_flop_formula(
    torch.ops.repro_torch.flash_attention)(_k4_flops)


def _k4_sharding(q, k, v, causal):
    """K4's DTensor strategies, per mesh dim: everything replicated; the
    batch (dim 0) sharded; or the heads (dim 1) of q, k, v and the output
    sharded alike, which keeps each query head with its kv head where both
    head counts divide the axis (DTensor drops a strategy that does not
    divide; ``models.layers.match_kv_heads`` repeats k and v first where
    the kv heads do not)."""
    from torch.distributed.tensor import Replicate, Shard
    return [([Replicate()], [Replicate(), Replicate(), Replicate(), None]),
            ([Shard(0)], [Shard(0), Shard(0), Shard(0), None]),
            ([Shard(1)], [Shard(1), Shard(1), Shard(1), None])]


def register_k4_sharding() -> None:
    """Give DTensor K4's strategies (:func:`_k4_sharding`).
    ``repro_torch.distributed.sharding`` calls it before the port's first
    DTensor: ``torch.distributed.tensor`` takes over a second to import,
    and the processes that only launch K4 skip it."""
    from torch.distributed.tensor.experimental import register_sharding
    register_sharding(torch.ops.repro_torch.flash_attention.default)(
        _k4_sharding)
