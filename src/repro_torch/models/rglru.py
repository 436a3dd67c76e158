"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

Counterpart of the reference's ``repro.models.rglru``.  Real-gated linear
recurrent unit:
    r_t = sigmoid(W_r x_t);  i_t = sigmoid(W_i x_t)
    a_t = exp(-c * softplus(Lambda) * r_t)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The reference runs an associative scan over the sequence; the port a
sequential one (the same recurrence, summed in another order: equal within
float32 rounding).  Decode carries the (B, D) hidden state with one update
per token.  On DTensors (under a mesh) the scan runs shard by shard.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.distributed.sharding import (constrain, keep_shards,
                                              local_shard)
from repro_torch.models.layers import rmsnorm

_C = 8.0


def _lru_scan(a: torch.Tensor, bx: torch.Tensor,
              h0: Optional[torch.Tensor]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_t = a_t h_{t-1} + bx_t over S.  a, bx: (B, S, D).  Returns
    (h (B, S, D), h at the last position).  The steps read ``unbind``'s
    views: one op for all S (and one ``stack`` in the backward), where an
    index per step would cost S ops, each of whose backward writes a
    zero-filled (B, S, D) gradient."""
    hs = []
    prev = h0
    for a_t, bx_t in zip(a.unbind(1), bx.unbind(1)):
        prev = bx_t if prev is None else a_t * prev + bx_t
        hs.append(prev)
    h = torch.stack(hs, dim=1)
    return h, h[:, -1]


def _scan_per_shard(a: DTensor, bx: DTensor, h0):
    """:func:`_lru_scan` on each rank's shards: the recurrence is
    elementwise in (B, D), so batch and channel shards scan alone (and a
    step's few ops run on the shards, not through DTensor's dispatch, which
    costs S x the step's ops)."""
    mesh = a.device_mesh
    want = [p if isinstance(p, Shard) and p.dim in (0, 2) else Replicate()
            for p in a.placements]
    args = [local_shard(t.redistribute(mesh, want)) for t in (a, bx)]
    if h0 is not None:
        h0 = local_shard(h0.redistribute(mesh, [
            Shard(1) if p == Shard(2) else p for p in want]))
    h, last = _lru_scan(*args, h0)
    b, s, d = a.shape
    return (DTensor.from_local(h.contiguous(), mesh, want, run_check=False,
                               shape=a.shape, stride=(s * d, d, 1)),
            DTensor.from_local(last.contiguous(), mesh, [
                Shard(1) if p == Shard(2) else p for p in want],
                run_check=False, shape=(b, d), stride=(d, 1)))


def _gate(u: torch.Tensor, w: torch.Tensor, bias: torch.Tensor):
    """``u @ w + bias``.  Under a mesh it is a column-parallel product on
    each rank's shards: u whole over model, the rank's columns of w and
    of the bias.  Left to DTensor, some releases contract over u's model
    shards, or meet the sharded bias with partial sums, neither of which
    they can redistribute."""
    if not isinstance(u, DTensor):
        return u @ w + bias
    mesh = u.device_mesh
    u = constrain(u, ("pod", "data"), None, None)
    cols = [p == Shard(1) for p in w.placements]
    out = [Shard(2) if c else p for c, p in zip(cols, u.placements)]
    y = (local_shard(u) @ local_shard(keep_shards(w, (1,)))
         + local_shard(keep_shards(bias, (0,))))
    b, s, _ = u.shape
    return DTensor.from_local(y, mesh, out, run_check=False,
                              shape=(b, s, w.shape[1]),
                              stride=(s * w.shape[1], w.shape[1], 1))


def rglru_block(x: torch.Tensor, p: Dict, *,
                state: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gated-MLP wrapper around the RG-LRU temporal mixer (Griffin block).
    x: (B, S, D).  state: (B, D_rnn).  Returns (y, new_state)."""
    b, s, d = x.shape
    h = rmsnorm(x, p["ln"])
    u = h @ p["w_in"]                                     # (B,S,Drnn)
    # jax.nn.gelu's default is the tanh approximation
    gate_branch = F.gelu(h @ p["w_gate"], approximate="tanh")

    r = torch.sigmoid(_gate(u, p["w_r"], p["b_r"]))
    i = torch.sigmoid(_gate(u, p["w_i"], p["b_i"]))
    log_a = -_C * F.softplus(p["lam"]).to(x.dtype) * r   # (B,S,Dr)
    a = torch.exp(log_a).to(x.dtype)
    gated = (torch.sqrt(torch.clamp(1.0 - a.float() ** 2, min=1e-6))
             .to(x.dtype) * (i * u))

    if s == 1 and state is not None:
        hseq = a[:, 0] * state + gated[:, 0]
        new_state = hseq.to(x.dtype)
        hseq = hseq[:, None]
    else:
        scan = _scan_per_shard if isinstance(a, DTensor) else _lru_scan
        hseq, new_state = scan(a, gated, state)
        new_state = new_state.to(x.dtype)

    y = (hseq.to(x.dtype) * gate_branch) @ p["w_out"]
    return (x + y).to(x.dtype), new_state
