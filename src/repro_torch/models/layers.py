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
returns updated copies).  The reference's ``constrain`` (sharding hints, a
no-op without a mesh) has no counterpart here.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import flash_attention

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


def attend_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool, window: Optional[int] = None,
                 f32_logits: bool = True) -> torch.Tensor:
    """The reference's ``_attend`` head-major: q (B, H, Sq, D), k/v
    (B, Hkv, Sk, D), query i at key position ``i + Sk - Sq``; a key is
    masked (-1e30) if it lies in the query's future (``causal``) or
    ``window`` or more positions back."""
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
    return flash_attention(q, k, v, causal=causal)


def _project(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, S, d) x (d, H, D) -> (B, S, H, D)."""
    return (h @ w.reshape(w.shape[0], -1)).reshape(
        *h.shape[:-1], *w.shape[1:])


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
            ck[:, :, idx:idx + s] = k
            cv[:, :, idx:idx + s] = v
            new_cache = (ck, cv)
            # a view of the keys written so far; K4's causal offset Sk - Sq
            # is idx
            k = ck[:, :, :idx + s]
            v = cv[:, :, :idx + s]
        if window is not None:
            out = attend_plain(q, k, v, causal=causal, window=window,
                               f32_logits=f32_logits)
        else:
            out = _attend(q, k, v, causal=causal, f32_logits=f32_logits)
    else:
        k, v = cross_kv
        out = _attend(_heads(q), k, v, causal=False, f32_logits=f32_logits)
        new_cache = None
    y = out.transpose(1, 2).reshape(b, s, -1) @ p["wo"].reshape(
        -1, p["wo"].shape[-1])
    return x + y, new_cache


def cross_kv_proj(enc: torch.Tensor, p: Dict) -> Cache:
    """The encoder output's K/V for ``xattn``, head-major (B, Hkv, F, D)."""
    return _heads(_project(enc, p["wk"])), _heads(_project(enc, p["wv"]))


def swiglu_block(x: torch.Tensor, p: Dict) -> torch.Tensor:
    h = rmsnorm(x, p["ln"])
    gate = F.silu(h @ p["wg"])
    up = h @ p["wu"]
    return x + (gate * up) @ p["wd"]
