"""Learning-rate schedules: plain functions of the integer step."""
from __future__ import annotations

import math


def cosine_schedule(base_lr: float, total_steps: int, min_frac: float = 0.1):
    def lr(step: int) -> float:
        t = min(step, total_steps) / max(total_steps, 1)
        cos = 0.5 * (1 + math.cos(math.pi * t))
        return base_lr * (min_frac + (1 - min_frac) * cos)
    return lr


def linear_warmup_cosine(base_lr: float, warmup_steps: int, total_steps: int,
                         min_frac: float = 0.05):
    cos = cosine_schedule(base_lr, max(total_steps - warmup_steps, 1), min_frac)

    def lr(step: int) -> float:
        if step < warmup_steps:
            return base_lr * min(step, warmup_steps) / max(warmup_steps, 1)
        return cos(step - warmup_steps)
    return lr
