"""AdamW with optional global-norm clipping, written out as the reference
``repro.optimizer.adam`` does.

``torch.optim.AdamW`` is not used: it applies weight decay as
``p *= 1 - lr * wd`` before the Adam step, while this optimizer adds
``wd * p`` to the Adam direction.  State is explicit: ``state =
opt.init(params)``, then ``opt.update(grads, params, state, lr)`` updates the
parameters (the reference returns new arrays).

Types follow the reference's, that is JAX's promotion: the bias corrections
are float32, so a bfloat16 parameter comes out of its first update float32,
and its moments follow one step later (from float32 gradients); the
clipping scale, when a float32 gradient makes it float32, promotes every
gradient with it; a Python number meets a bf16 tensor as a bf16 number.  A
tensor whose type holds is updated in place; one whose type changes is
replaced (a parameter's ``.data`` is rebound, ``distributed.sharding.
set_data``, a moment is a new tensor in the returned state).
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Sequence

import torch

from repro_torch.distributed.sharding import set_data


class AdamWState(NamedTuple):
    step: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x)) for x in tensors))


@dataclasses.dataclass(frozen=True)
class AdamW:
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: float | None = 1.0

    def init(self, params: Sequence[torch.Tensor]) -> AdamWState:
        return AdamWState(step=0,
                          mu=[torch.zeros_like(p) for p in params],
                          nu=[torch.zeros_like(p) for p in params])

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor],
               params: Sequence[torch.Tensor], state: AdamWState,
               lr: float) -> AdamWState:
        grads = list(grads)
        if self.clip_norm is not None:
            gnorm = global_norm(grads)
            scale = torch.clamp(self.clip_norm / (gnorm + 1e-12), max=1.0)
            grads = [_promoted(g, scale.dtype) * scale for g in grads]
        step = state.step + 1
        b1, b2 = self.b1, self.b2
        f32 = torch.float32
        bc1 = (1 - torch.tensor(b1, dtype=f32) ** step).item()
        bc2 = (1 - torch.tensor(b2, dtype=f32) ** step).item()
        mu, nu = [], []
        for p, m, v, g in zip(params, state.mu, state.nu, grads):
            m = _blend(m, b1, _weak(1 - b1, g) * g)
            v = _blend(v, b2, _weak(1 - b2, g) * g * g)
            mu.append(m)
            nu.append(v)
            delta = (_promoted(m, f32) / bc1) / (
                torch.sqrt(_promoted(v, f32) / bc2) + self.eps)
            if self.weight_decay:
                delta = delta + _weak(self.weight_decay, p) * p
            if torch.promote_types(p.dtype, delta.dtype) == p.dtype:
                p.sub_(lr * delta)
            else:
                set_data(p, p - lr * delta)
        return AdamWState(step=step, mu=mu, nu=nu)


def _promoted(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` in its type promoted with ``dtype``: what JAX does to an array
    met with a 0-d array of ``dtype`` (torch keeps the array's type)."""
    return x.to(torch.promote_types(x.dtype, dtype))


def _weak(value: float, like: torch.Tensor):
    """A Python number met with ``like`` as JAX meets it: in ``like``'s
    type.  torch keeps the number in float32 for a bf16 tensor, so there it
    becomes a bf16 scalar tensor; for wider types the number stays as is."""
    if like.dtype in (torch.bfloat16, torch.float16):
        return torch.tensor(value, dtype=like.dtype)
    return value


def _blend(acc: torch.Tensor, beta: float, term: torch.Tensor
           ) -> torch.Tensor:
    """``beta * acc + term``, in place where ``acc``'s type holds."""
    if torch.promote_types(acc.dtype, term.dtype) == acc.dtype:
        return acc.mul_(_weak(beta, acc)).add_(term)
    return _weak(beta, acc) * acc + term
