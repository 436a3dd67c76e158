"""AdamW with global-norm clipping and its learning-rate schedule, as the
JAX package writes them, on a dict of tensors.

Weight decay is added to the Adam direction (not applied to the weights
first, as ``torch.optim.AdamW`` does).  Types follow JAX's promotion: the
bias corrections are float32 numbers, so a bf16 parameter comes out of its
first update float32; a Python number meets a bf16 tensor as a bf16
number; the clipping scale takes the gradients' norm's type.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple

import torch


class State(NamedTuple):
    step: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


def _num(value: float, like: torch.Tensor):
    """A Python number as JAX meets it beside ``like``: in ``like``'s type
    where that is a 16-bit float."""
    if like.dtype in (torch.bfloat16, torch.float16):
        return torch.tensor(value, dtype=like.dtype)
    return value


def _to_wider(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x.to(torch.promote_types(x.dtype, dtype))


class AdamW:
    def __init__(self, b1: float, b2: float, eps: float, weight_decay: float,
                 clip_norm: float):
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay, self.clip_norm = weight_decay, clip_norm

    def init(self, params: Dict[str, torch.Tensor]) -> State:
        return State(0, {k: torch.zeros_like(v) for k, v in params.items()},
                     {k: torch.zeros_like(v) for k, v in params.items()})

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor],
               params: Dict[str, torch.Tensor], state: State,
               lr: float) -> State:
        """Update ``params`` (the dict's values replaced) and return the new
        state."""
        if self.clip_norm is not None:
            norm = torch.sqrt(sum(torch.sum(torch.square(g))
                                  for g in grads.values()))
            scale = torch.clamp(self.clip_norm / (norm + 1e-12), max=1.0)
            grads = {k: _to_wider(g, scale.dtype) * scale
                     for k, g in grads.items()}
        step = state.step + 1
        f32 = torch.float32
        bc1 = (1 - torch.tensor(self.b1, dtype=f32) ** step).item()
        bc2 = (1 - torch.tensor(self.b2, dtype=f32) ** step).item()
        mu, nu = {}, {}
        for k, p in params.items():
            g = grads[k]
            m, v = state.mu[k], state.nu[k]
            m = _num(self.b1, m) * m + _num(1 - self.b1, g) * g
            v = _num(self.b2, v) * v + _num(1 - self.b2, g) * g * g
            mu[k], nu[k] = m, v
            delta = (_to_wider(m, f32) / bc1) / (
                torch.sqrt(_to_wider(v, f32) / bc2) + self.eps)
            if self.weight_decay:
                delta = delta + _num(self.weight_decay, p) * p
            params[k] = (p - lr * delta).to(
                torch.promote_types(p.dtype, delta.dtype))
        return State(step, mu, nu)


def linear_warmup_cosine(base_lr: float, warmup: int, total: int,
                         min_frac: float = 0.05):
    """Linear warm-up from 0 over ``warmup`` steps, then a cosine from
    ``base_lr`` down to ``min_frac`` of it over the remaining steps."""
    span = max(total - warmup, 1)

    def lr(step: int) -> float:
        if step < warmup:
            return base_lr * min(step, warmup) / max(warmup, 1)
        t = min(step - warmup, span) / span
        return base_lr * (min_frac + (1 - min_frac)
                          * 0.5 * (1 + math.cos(math.pi * t)))
    return lr
