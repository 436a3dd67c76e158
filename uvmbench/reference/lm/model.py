"""The forward pass of a dense decoder-only LM and its next-token loss, in
plain ``torch``: RMSNorm, RoPE, grouped-query attention under a causal
mask, SwiGLU, a head tied to the embedding.

Types follow the JAX package's model, which the port reproduces: the
embedding's rows are cast to the configuration's ``dtype`` and scaled by
``sqrt(d_model)`` in that type; RMSNorm takes its variance in float32 and
casts ``rsqrt`` to its input's type before the gain; RoPE's angles are
float32, cast to the input's type; attention's logits and softmax are
float32, the probabilities cast back to the values' type.  Everything
else takes torch's promotion of its operands: once the parameters are
float32, so is the residual stream after the first block.  Where "float32"
is said, the wider of float32 and the operand's type is meant, so that
float64 parameters run the same function in float64.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from uvmbench.reference.lm.weights import DTYPES

EPS = 1e-6
ROPE_THETA = 10000.0
MASKED = -1e30


def wide(t: torch.Tensor) -> torch.Tensor:
    """``t`` in float32, or in its own type where that is wider."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def rmsnorm(x, g):
    var = wide(x).square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + EPS).to(x.dtype)) * g


def rope(x, positions):
    """x: (B, S, H, D); positions: (S,)."""
    half = x.shape[-1] // 2
    inv = 1.0 / (ROPE_THETA ** (torch.arange(
        0, half, dtype=torch.float32, device=x.device) / half))
    ang = positions.float()[:, None] * inv
    cos = torch.cos(ang)[:, None, :].to(x.dtype)
    sin = torch.sin(ang)[:, None, :].to(x.dtype)
    a, b = x[..., :half], x[..., half:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def attention_logits(x, p: Dict[str, torch.Tensor], config: Dict):
    """The masked logits (B, kv, group, S, S) of the attention block on
    the residual stream ``x``, and its values (B, kv, S, D)."""
    bsz, s, d = x.shape
    heads, kv, hd = (int(config["n_heads"]), int(config["n_kv"]),
                     int(config["head_dim"]))
    h = rmsnorm(x, p["ln"])
    pos = torch.arange(s, device=x.device)
    q = rope((h @ p["wq"].reshape(d, -1)).reshape(bsz, s, heads, hd), pos)
    k = rope((h @ p["wk"].reshape(d, -1)).reshape(bsz, s, kv, hd), pos)
    v = (h @ p["wv"].reshape(d, -1)).reshape(bsz, s, kv, hd)
    # (B, kv, group, S, D) queries against (B, kv, S, D) keys
    q = q.permute(0, 2, 1, 3).reshape(bsz, kv, heads // kv, s, hd)
    k, v = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    logits = torch.einsum("bkgqd,bksd->bkgqs", wide(q), wide(k))
    logits = logits / math.sqrt(hd)
    future = torch.ones((s, s), dtype=torch.bool, device=x.device).triu(1)
    return logits.masked_fill(future, MASKED), v


def attention(x, p: Dict[str, torch.Tensor], config: Dict):
    bsz, s, d = x.shape
    heads = int(config["n_heads"])
    logits, v = attention_logits(x, p, config)
    probs = torch.softmax(logits, dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", probs.to(v.dtype), v)
    o = o.reshape(bsz, heads, s, -1).permute(0, 2, 1, 3).reshape(bsz, s, -1)
    return x + o @ p["wo"].reshape(-1, d)


def swiglu(x, p: Dict[str, torch.Tensor]):
    h = rmsnorm(x, p["ln"])
    return x + (F.silu(h @ p["wg"]) * (h @ p["wu"])) @ p["wd"]


def layer_params(params: Dict[str, torch.Tensor], layer: int, block: str):
    prefix = f"segments.0.{layer}.{block}."
    return {k[len(prefix):]: v for k, v in params.items()
            if k.startswith(prefix)}


def embed(params: Dict[str, torch.Tensor], tokens: torch.Tensor,
          config: Dict) -> torch.Tensor:
    """The residual stream entering the first layer."""
    dtype = DTYPES[config["dtype"]]
    x = params["embed"][tokens].to(dtype)
    return x * torch.tensor(math.sqrt(int(config["d_model"])),
                            dtype=torch.float32).to(dtype)


def layer(x: torch.Tensor, params: Dict[str, torch.Tensor], index: int,
          config: Dict) -> torch.Tensor:
    """Layer ``index``: attention, then the MLP, each with its residual."""
    x = attention(x, layer_params(params, index, "b0_attn"), config)
    return swiglu(x, layer_params(params, index, "b1_ffn"))


def head_nll_sum(x: torch.Tensor, params: Dict[str, torch.Tensor],
                 tokens: torch.Tensor) -> torch.Tensor:
    """The summed next-token negative log-likelihood of the last layer's
    output ``x`` (B, S, d) against ``tokens`` (B, S), float32: B x (S - 1)
    targets."""
    logits = rmsnorm(x, params["final_ln"]) @ params["embed"].T
    logp = torch.log_softmax(wide(logits), dim=-1)[:, :-1]
    return -torch.gather(logp, -1, tokens[:, 1:, None]).sum()


def nll_sum(params: Dict[str, torch.Tensor], tokens: torch.Tensor,
            config: Dict) -> torch.Tensor:
    """The whole forward pass: :func:`head_nll_sum` of ``tokens``."""
    x = embed(params, tokens, config)
    for index in range(int(config["n_layers"])):
        x = layer(x, params, index, config)
    return head_nll_sum(x, params, tokens)
