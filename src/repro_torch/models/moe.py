"""Mixture-of-experts FFN with top-k routing and capacity-limited dispatch.

Counterpart of the reference's ``repro.models.moe``, with its three
dispatches (``ArchConfig.moe_dispatch``): ``grouped`` (GShard-style token
groups, one-hot einsum dispatch within each group), ``einsum`` (one global
one-hot einsum) and ``scatter`` (slot buffers filled by index-add), and the
Switch-style load-balancing auxiliary loss.

Under a mesh the dispatch and combine products, and the scatter
dispatch's slot writes and reads, run shard by shard
(``distributed.sharding.einsum``, ``scatter_rows``, ``take_rows``); on
plain tensors they are ``torch.einsum``, ``index_add`` and indexing.

Top-k selection breaks ties as ``jax.lax.top_k`` does, lower expert index
first: :func:`_top_k` takes the first k of a stable descending sort
(``torch.topk`` leaves the order of equal values open).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.distributed.sharding import einsum as shard_einsum
from repro_torch.distributed.sharding import (keep_shards, scatter_rows,
                                              take_rows)
from repro_torch.models.layers import rmsnorm


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest entries of each row, in
    descending order, ties to the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _routing(ht, router, n_experts, top_k, capacity):
    """Shared routing: returns (gate_vals, gate_idx, pos, keep, probs,
    onehot)."""
    logits = ht.float() @ router
    probs = torch.softmax(logits, dim=-1)                          # (T, E)
    gate_vals, gate_idx = _top_k(probs, top_k)                     # (T, K)
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)
    onehot = F.one_hot(gate_idx, n_experts).to(torch.int32)        # (T,K,E)
    flat = onehot.reshape(-1, n_experts)
    pos = torch.cumsum(flat, dim=0) - flat                         # (TK, E)
    pos = (pos * flat).sum(-1).reshape(gate_idx.shape)
    keep = pos < capacity
    return gate_vals * keep, gate_idx, pos, keep, probs, onehot


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    return F.one_hot(idx, n).to(dtype)


def _experts(xe: torch.Tensor, p: Dict) -> torch.Tensor:
    """SwiGLU of each expert's slots: xe (E, C, D) -> (E, C, D)."""
    gate = F.silu(torch.bmm(xe, p["wg"]))
    up = torch.bmm(xe, p["wu"])
    return torch.bmm(gate * up, p["wd"])


def moe_block(x: torch.Tensor, p: Dict, *, n_experts: int, top_k: int,
              capacity_factor: float = 1.25, dispatch: str = "grouped",
              group_tokens: int = 512) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D).  p: router (D, E), experts wg/wu (E, D, F), wd (E, F, D).
    Returns (y, aux_loss)."""
    b, s, d = x.shape
    h = rmsnorm(x, p["ln"])
    n_tokens = b * s
    ht = h.reshape(n_tokens, d)

    if dispatch == "grouped":
        g = max(n_tokens // max(group_tokens, 1), 1)
        tg = n_tokens // g
        if g * tg != n_tokens:
            raise ValueError(f"moe grouped dispatch: {n_tokens} tokens do not "
                             f"split into {g} groups of {tg}")
        cap = max(int(capacity_factor * tg * top_k / n_experts), 4)
        gate_vals, gate_idx, pos, keep, probs, onehot = _routing(
            ht, p["router"], n_experts, top_k, cap)
        # per-group positions: the cumsum again, within groups
        flat = onehot.reshape(g, tg * top_k, n_experts)
        posg = torch.cumsum(flat, dim=1) - flat
        posg = (posg * flat).sum(-1).reshape(g, tg, top_k)
        keep = posg < cap
        gv = gate_vals.reshape(g, tg, top_k) * keep
        hg = ht.reshape(g, tg, d)
        disp = (_one_hot(gate_idx.reshape(g, tg, top_k), n_experts,
                         ht.dtype)[..., None]
                * _one_hot(torch.where(keep, posg, cap), cap + 1,
                           ht.dtype)[..., None, :])
        disp = disp[..., :cap]                       # (G,Tg,K,E,C)
        dispatch_t = disp.sum(2)                     # (G,Tg,E,C)
        combine_t = (disp * gv[..., None, None].to(ht.dtype)).sum(2)
        xe = shard_einsum("gtd,gtec->gecd", hg, dispatch_t)   # (G,E,C,D)
        xe = xe.permute(1, 0, 2, 3).reshape(n_experts, g * cap, d)
        ye = _experts(xe, p)
        ye = ye.reshape(n_experts, g, cap, d).permute(1, 0, 2, 3)
        y = shard_einsum("gecd,gtec->gtd", ye, combine_t).reshape(b, s, d)

    elif dispatch == "einsum":
        cap = max(int(capacity_factor * n_tokens * top_k / n_experts), 4)
        gate_vals, gate_idx, pos, keep, probs, onehot = _routing(
            ht, p["router"], n_experts, top_k, cap)
        disp = (_one_hot(gate_idx, n_experts, ht.dtype)[..., None]
                * _one_hot(torch.where(keep, pos, cap), cap + 1,
                           ht.dtype)[..., None, :])
        disp = disp[..., :cap]                                  # (T,K,E,C)
        dispatch_t = disp.sum(1)
        combine_t = (disp * gate_vals[..., None, None].to(ht.dtype)).sum(1)
        xe = shard_einsum("td,tec->ecd", ht, dispatch_t)
        ye = _experts(xe, p)
        y = shard_einsum("ecd,tec->td", ye, combine_t).reshape(b, s, d)

    elif dispatch == "scatter":
        cap = max(int(capacity_factor * n_tokens * top_k / n_experts), 4)
        gate_vals, gate_idx, pos, keep, probs, onehot = _routing(
            ht, p["router"], n_experts, top_k, cap)
        n_slots = n_experts * cap
        slot = torch.where(keep, gate_idx * cap + pos,
                           torch.full_like(gate_idx, n_slots))  # (T, K)
        xe_flat = scatter_rows(n_slots + 1, slot, ht, top_k)
        xe = xe_flat[:n_slots].reshape(n_experts, cap, d)
        if isinstance(xe, DTensor):
            # the slots whole (their partial sums reduced): the experts'
            # products then shard the expert dim as the weights do, and no
            # gradient reaches the reshape flattened over two axes
            xe = keep_shards(xe, ())
        ye = _experts(xe, p)
        if isinstance(ye, DTensor):
            # the experts' rows as their weights shard them; a dropped
            # token's slot (n_slots) lies past every shard and takes zeros
            ye_flat = keep_shards(ye, (0,)).reshape(n_slots, d)
        else:
            ye_flat = torch.cat([ye.reshape(n_slots, d),
                                 ye.new_zeros((1, d))])
        y = torch.zeros_like(ht)
        for k in range(top_k):
            y = y + take_rows(ye_flat, slot[:, k]) * gate_vals[
                :, k, None].to(ht.dtype)
        y = y.reshape(b, s, d)
    else:
        raise ValueError(f"unknown moe dispatch {dispatch!r}")

    # load-balancing auxiliary loss (Switch-style)
    me = probs.mean(0)
    ce = onehot.sum(1).float().mean(0) / top_k
    aux = n_experts * torch.sum(me * ce)
    return x + y.to(x.dtype), aux
