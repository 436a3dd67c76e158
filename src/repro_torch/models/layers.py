"""Shared neural layers: RMSNorm, RoPE, GQA attention (train/prefill/decode),
SwiGLU MLP.

Counterpart of the reference's ``repro.models.layers``, with the same cast
order: ``rmsnorm`` takes the variance in float32 and casts ``rsqrt`` to the
input's type; ``rope`` takes its angles in float32 and casts cos/sin.

Attention is routed by mode, in code, never by catching a kernel error:

* Training (autograd on, and q, k or v requires a gradient): every block
  takes :func:`attend_plain`, the reference's differentiable ``_attend``,
  with the ``f32_logits`` knob honoured.  K4 has no backward (neither has
  the reference's flash kernel), and the reference's models train through
  ``_attend``; the port's predictor follows the same rule.
* Otherwise (``prefill`` and ``decode`` run under ``torch.no_grad``):
  ``attn``, ``eattn`` and ``xattn`` blocks take K4
  (``kernels.flash_attention.flash_attention``) over the block's keys,
  ``causal`` as the reference's mask gives it (``attn`` causal, ``eattn``
  and ``xattn`` not).  A decode step (``attn`` with a cache) hands K4 the
  cache's view ``[0, index + S)``, the keys written so far, with no copy,
  and ``causal=True``: K4's causal offset is ``Sk - Sq``, here ``index``,
  the reference's mask ``qpos >= kpos`` over the padded cache, whose
  masked keys get weight exactly 0.
* ``lattn`` (sliding window; only ``recurrentgemma-9b``, whose head dim of
  256 exceeds K4's ``MAX_D`` of 128) always takes :func:`attend_plain`,
  over the same cache view.

``attn_f32_logits=False`` (the reference's tuning knob: logits in the
inputs' type) changes nothing on K4's blocks: K4 always takes its logits
and softmax in float32.

A K4 launch that fails raises.  The port keeps attention caches head-major,
``(B, Hkv, S_max, D)``, the layout K4 reads (rows dense, batch and head
strides free), and writes decode steps into them in place (the reference
returns updated copies).  K4 is called through its registered op
(``kernels.flash_attention.flash_attention_op``, bound here as
``flash_attention``), which launches the same wrapper and lets a DTensor or
fake run (``repro_torch.launch.dryrun``) shard and count it.

Under a mesh (DTensor arguments) these sites do by hand what GSPMD does on
its own; plain tensors take the code above them unchanged:

* :func:`match_kv_heads`: DTensor refuses ``aten.view`` of q's heads, sharded
  over an axis whose size does not divide the kv heads, into (kv heads,
  group); k and v are repeated to q's heads and laid out as q's.
* :func:`per_shard`: ``attend_plain`` on each rank's batch and head shards.
* :func:`_project`, :func:`_unproject`: the projections as einsums on each
  rank's shards (``distributed.sharding.einsum``).
* a decode step's cache write into a cache whose sequence dim is sharded
  (``launch.dryrun.decode_state_shardings``' context parallelism) is made on
  the local shard that holds the position: DTensor refuses the in-place
  ``aten.copy_`` into a slice of a sharded dim.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.distributed.sharding import einsum as shard_einsum
from repro_torch.distributed.sharding import local_shard, shard_range
# K4 through its registered op: the same launch on real tensors, a shape
# and a FLOP count on fake ones, a sharding rule on DTensors
from repro_torch.kernels.flash_attention import \
    flash_attention_op as flash_attention

Cache = Tuple[torch.Tensor, torch.Tensor]


def rmsnorm(x: torch.Tensor, g: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    var = x.float().square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * g


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, D); positions: (..., S)."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(
        0, half, dtype=torch.float32, device=x.device) / half))
    angles = positions[..., None].float() * freqs          # (..., S, half)
    cos = torch.cos(angles)[..., None, :].to(x.dtype)
    sin = torch.sin(angles)[..., None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def match_kv_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k and v as attention under a mesh needs them: unchanged, unless q is
    a DTensor whose heads (dim 1) are sharded over a mesh axis whose size
    does not divide the kv heads.  DTensor then refuses ``aten.view`` of q's
    heads into (kv heads, group), and K4's sharding rule cannot pair q's
    head shards with k's; GSPMD reshards there on its own.  So k and v are
    repeated to q's heads (head i reads kv head i // group) and
    redistributed to q's head sharding.  Plain tensors pass unchanged."""
    if not isinstance(q, DTensor):
        return k, v
    h, hkv = q.shape[1], k.shape[1]
    mesh = q.device_mesh
    head_axes = [i for i, p in enumerate(q.placements)
                 if isinstance(p, Shard) and p.dim == 1]
    if h == hkv or all(hkv % mesh.size(i) == 0 for i in head_axes):
        return k, v

    def repeat(t):
        b, _, sk, d = t.shape
        t = t[:, :, None].expand(b, hkv, h // hkv, sk, d).reshape(b, h, sk, d)
        return t.redistribute(mesh, [
            Shard(1) if i in head_axes else p
            for i, p in enumerate(t.placements)]).contiguous()

    return repeat(k), repeat(v)


def per_shard(fn, q: DTensor, k: DTensor, v: DTensor, **kw) -> DTensor:
    """``fn(q, k, v, **kw)`` (attention: independent per batch row and
    head) on each rank's shards: q, k and v laid out alike, batch and heads
    as q's, their sequence and head dims whole.  DTensor cannot run the
    products of ``attend_plain`` itself: ``einsum`` flattens the batch and
    kv-head dims into one, sharded over two axes, which ``aten.bmm`` has no
    strategy for."""
    mesh = q.device_mesh
    want = [p if isinstance(p, Shard) and p.dim in (0, 1) else Replicate()
            for p in q.placements]
    q, k, v = (t.redistribute(mesh, want) for t in (q, k, v))
    out = fn(local_shard(q), local_shard(k), local_shard(v), **kw).contiguous()
    return DTensor.from_local(out, mesh, want, run_check=False,
                              shape=q.shape,
                              stride=torch.empty(q.shape, device="meta")
                              .stride())


def attend_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool, window: Optional[int] = None,
                 f32_logits: bool = True) -> torch.Tensor:
    """The reference's ``_attend`` head-major: q (B, H, Sq, D), k/v
    (B, Hkv, Sk, D), query i at key position ``i + Sk - Sq``; a key is
    masked (-1e30) if it lies in the query's future (``causal``) or
    ``window`` or more positions back.  On DTensors it runs shard by shard
    (:func:`per_shard`)."""
    if isinstance(q, DTensor):
        k, v = match_kv_heads(q, k, v)
        return per_shard(attend_plain, q, k, v, causal=causal, window=window,
                         f32_logits=f32_logits)
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    acc = torch.float32 if f32_logits else q.dtype
    qg = q.reshape(b, hkv, h // hkv, sq, d)
    logits = torch.einsum("bkgqd,bksd->bkgqs", qg.to(acc), k.to(acc))
    logits = logits / torch.sqrt(torch.tensor(float(d), dtype=acc))
    qpos = torch.arange(sq, device=q.device) + (sk - sq)
    kpos = torch.arange(sk, device=q.device)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window is not None:
        mask &= qpos[:, None] - kpos[None, :] < window
    logits = logits.masked_fill(~mask, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bkgqs,bksd->bkgqd", probs, v).reshape(b, h, sq, d)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool, f32_logits: bool) -> torch.Tensor:
    """An ``attn``, ``eattn`` or ``xattn`` block's attention: differentiable
    while training, else K4."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return attend_plain(q, k, v, causal=causal, f32_logits=f32_logits)
    k, v = match_kv_heads(q, k, v)
    return flash_attention(q, k, v, causal=causal)


def _project(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, S, d) x (d, H, D) -> (B, S, H, D).  On DTensors, an einsum on
    each rank's shards: the flat product's (H x D) columns would hold the
    head shards of a weight sharded over heads, or whatever DTensor gives
    an unsharded one, and ``aten.view`` cannot split a shard of fewer
    heads than the axis (or a shard inside D) back into (H, D)."""
    if isinstance(w, DTensor):
        return shard_einsum("bsd,dhk->bshk", h, w)
    return (h @ w.reshape(w.shape[0], -1)).reshape(
        *h.shape[:-1], *w.shape[1:])


def _unproject(o: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, S, H, D) x (H, D, d) -> (B, S, d), the output projection; on
    DTensors an einsum on each rank's shards (flattening a weight sharded
    over heads and over D would leave a strided shard no product takes)."""
    if isinstance(w, DTensor):
        return shard_einsum("bshk,hkd->bsd", o, w)
    return o.reshape(*o.shape[:2], -1) @ w.reshape(-1, w.shape[-1])


def _heads(x: torch.Tensor) -> torch.Tensor:
    """(B, S, H, D) -> contiguous (B, H, S, D)."""
    return x.transpose(1, 2).contiguous()


def attention_block(x: torch.Tensor, p: Dict, *, n_heads: int, n_kv: int,
                    head_dim: int, causal: bool = True,
                    window: Optional[int] = None,
                    cache: Optional[Cache] = None,
                    cache_index: Optional[int] = None,
                    positions: Optional[torch.Tensor] = None,
                    cross_kv: Optional[Cache] = None,
                    want_cache: bool = False, f32_logits: bool = True):
    """Pre-norm attention block.  Returns (y, new_cache).

    * train: cache None, want_cache False -> new_cache None.
    * prefill: cache None, want_cache True -> new_cache = fresh (k, v),
      head-major (B, Hkv, S, D).
    * decode: cache (B, Hkv, S_max, D) x2 + cache_index -> written in place.
    * cross attention: cross_kv (B, Hkv, F, D) x2 gives fixed K/V (the
      encoder's output).

    ``window`` is set only for ``lattn`` blocks, which take
    :func:`attend_plain`; every other block runs K4 unless it is training
    (:func:`_attend`).
    """
    b, s, _ = x.shape
    h = rmsnorm(x, p["ln"])
    q = _project(h, p["wq"])
    if positions is None:
        start = 0 if cache_index is None else int(cache_index)
        positions = torch.arange(start, start + s, device=x.device)[None, :]
    if cross_kv is None:
        k = _project(h, p["wk"])
        v = _project(h, p["wv"])
        q = _heads(rope(q, positions))
        k = _heads(rope(k, positions))
        v = _heads(v)
        new_cache = (k, v) if want_cache else None
        if cache is not None:
            ck, cv = cache
            idx = 0 if cache_index is None else int(cache_index)
            if idx + s > ck.shape[2]:
                raise ValueError(f"attention_block: positions {idx}..{idx + s}"
                                 f" past the cache's {ck.shape[2]}")
            _write_cache(ck, k, idx)
            _write_cache(cv, v, idx)
            new_cache = (ck, cv)
            # a view of the keys written so far (the whole cache once it is
            # full); K4's causal offset Sk - Sq is idx
            if idx + s < ck.shape[2]:
                ck, cv = ck[:, :, :idx + s], cv[:, :, :idx + s]
            k, v = ck, cv
        if window is not None:
            out = attend_plain(q, k, v, causal=causal, window=window,
                               f32_logits=f32_logits)
        else:
            out = _attend(q, k, v, causal=causal, f32_logits=f32_logits)
    else:
        k, v = cross_kv
        out = _attend(_heads(q), k, v, causal=False, f32_logits=f32_logits)
        new_cache = None
    y = _unproject(out.transpose(1, 2), p["wo"])
    return x + y, new_cache


def _write_cache(cache: torch.Tensor, x: torch.Tensor, idx: int) -> None:
    """``cache[:, :, idx:idx + S] = x`` in place.  A DTensor cache whose
    sequence dim (2) is sharded is written on its local shard, the rows of
    the positions that shard holds (DTensor refuses ``aten.copy_`` into a
    slice of a sharded dim)."""
    s = x.shape[2]
    if not (isinstance(cache, DTensor) and any(
            isinstance(p, Shard) and p.dim == 2 for p in cache.placements)):
        cache[:, :, idx:idx + s] = x
        return
    first, count = shard_range(cache.shape[2], cache.device_mesh, [
        isinstance(p, Shard) and p.dim == 2 for p in cache.placements])
    lo, hi = max(idx, first) - first, min(idx + s, first + count) - first
    # x laid out as the cache's shard, whole along the sequence
    x = x.redistribute(cache.device_mesh, [
        Replicate() if isinstance(p, Shard) and p.dim == 2 else p
        for p in cache.placements])
    if lo < hi:
        cache.to_local()[:, :, lo:hi] = \
            x.to_local()[:, :, lo + first - idx:hi + first - idx]


def cross_kv_proj(enc: torch.Tensor, p: Dict) -> Cache:
    """The encoder output's K/V for ``xattn``, head-major (B, Hkv, F, D)."""
    return _heads(_project(enc, p["wk"])), _heads(_project(enc, p["wv"]))


def swiglu_block(x: torch.Tensor, p: Dict) -> torch.Tensor:
    h = rmsnorm(x, p["ln"])
    gate = F.silu(h @ p["wg"])
    up = h @ p["wu"]
    return x + (gate * up) @ p["wd"]
