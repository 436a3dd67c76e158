"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

Counterpart of the reference's ``repro.models.rglru``.  Real-gated linear
recurrent unit:
    r_t = sigmoid(W_r x_t);  i_t = sigmoid(W_i x_t)
    a_t = exp(-c * softplus(Lambda) * r_t)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The reference runs an associative scan over the sequence; the port a
sequential one (the same recurrence, summed in another order: equal within
float32 rounding).  Decode carries the (B, D) hidden state with one update
per token.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import rmsnorm

_C = 8.0


def _lru_scan(a: torch.Tensor, bx: torch.Tensor,
              h0: Optional[torch.Tensor]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_t = a_t h_{t-1} + bx_t over S.  a, bx: (B, S, D).  Returns
    (h (B, S, D), h at the last position)."""
    hs = []
    prev = h0
    for t in range(a.shape[1]):
        prev = bx[:, t] if prev is None else a[:, t] * prev + bx[:, t]
        hs.append(prev)
    h = torch.stack(hs, dim=1)
    return h, h[:, -1]


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

    r = torch.sigmoid(u @ p["w_r"] + p["b_r"])
    i = torch.sigmoid(u @ p["w_i"] + p["b_i"])
    log_a = -_C * F.softplus(p["lam"]).to(x.dtype) * r   # (B,S,Dr)
    a = torch.exp(log_a).to(x.dtype)
    gated = (torch.sqrt(torch.clamp(1.0 - a.float() ** 2, min=1e-6))
             .to(x.dtype) * (i * u))

    if s == 1 and state is not None:
        hseq = a[:, 0] * state + gated[:, 0]
        new_state = hseq.to(x.dtype)
        hseq = hseq[:, None]
    else:
        hseq, new_state = _lru_scan(a, gated, state)
        new_state = new_state.to(x.dtype)

    y = (hseq.to(x.dtype) * gate_branch) @ p["w_out"]
    return (x + y).to(x.dtype), new_state
