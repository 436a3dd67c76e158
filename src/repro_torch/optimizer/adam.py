"""AdamW with optional global-norm clipping, written out as the reference
``repro.optimizer.adam`` does.

``torch.optim.AdamW`` is not used: it applies weight decay as
``p *= 1 - lr * wd`` before the Adam step, while this optimizer adds
``wd * p`` to the Adam direction.  State is explicit: ``state =
opt.init(params)``, then ``opt.update(grads, params, state, lr)`` updates the
parameters in place (the reference returns new arrays).
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Sequence

import torch


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
            grads = [g * scale for g in grads]
        step = state.step + 1
        b1, b2 = self.b1, self.b2
        dt = params[0].dtype
        bc1 = 1 - torch.tensor(b1, dtype=dt) ** step
        bc2 = 1 - torch.tensor(b2, dtype=dt) ** step
        for p, m, v, g in zip(params, state.mu, state.nu, grads):
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            delta = (m / bc1.item()) / (torch.sqrt(v / bc2.item()) + self.eps)
            if self.weight_decay:
                delta = delta + self.weight_decay * p
            p.sub_(lr * delta)
        return AdamWState(step=step, mu=state.mu, nu=state.nu)
