"""Gradient compression with error feedback, as the reference's
``repro.optimizer.grad_compress`` does it, over lists of tensors:

* int8 symmetric quantization (4x compression) with a per-tensor scale,
* top-k sparsification (magnitude), and
* error feedback (residual accumulation) so either compressor stays unbiased
  over time (Karimireddy et al., 2019).

The types follow the reference's (JAX's promotion, not torch's, where they
differ): ``int8_decompress`` returns float32 whatever the input's type, so
an ``int8`` residual is float32 after one step; ``topk`` keeps the input's
type.  ``torch.topk`` may break ties in magnitude otherwise than
``jax.lax.top_k``: the kept set can differ by entries whose magnitude equals
the k-th largest.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch


def int8_compress(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.amax(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    # float32 x the scale's type promotes to float32 (as in JAX)
    dtype = torch.promote_types(torch.float32, scale.dtype)
    return q.to(dtype) * scale.to(dtype)


def topk_compress(x: torch.Tensor, frac: float = 0.05):
    """Keep the top ``frac`` fraction of entries by magnitude."""
    flat = x.reshape(-1)
    k = max(1, int(flat.numel() * frac))
    _, idx = torch.topk(torch.abs(flat), k)
    return flat[idx], idx, tuple(x.shape)


def topk_decompress(vals: torch.Tensor, idx: torch.Tensor,
                    shape) -> torch.Tensor:
    n = 1
    for s in shape:
        n *= int(s)
    flat = torch.zeros(n, dtype=vals.dtype, device=vals.device)
    flat[idx] = vals
    return flat.reshape(shape)


class ErrorFeedbackState(NamedTuple):
    residual: List[torch.Tensor]


def _roundtrip(x: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "int8":
        return int8_decompress(*int8_compress(x))
    if mode == "topk":
        return topk_decompress(*topk_compress(x))
    raise ValueError(f"unknown mode {mode}")


@torch.no_grad()
def compress_with_error_feedback(grads: Sequence[torch.Tensor],
                                 state: ErrorFeedbackState,
                                 mode: str = "int8",
                                 groups: Optional[Sequence[Sequence[int]]]
                                 = None):
    """Compress ``grads + residual``; the new residual is what compression
    lost.  Returns (decompressed grads to feed the all-reduce, new state).

    ``groups`` lists the indices of tensors that form one leaf of the
    reference's tree (``LMParams.leaf_groups``: a segment's layers, which the
    reference stacks): a group is compressed as one tensor, its layers
    stacked, under one int8 scale or one top-k.  By default every tensor is
    a leaf of its own.

    The round trip happens locally; only the compressed representation would
    travel on the wire.  The decompressed value is returned so that callers
    can drop this in front of any existing all-reduce.
    """
    carried = [g + r for g, r in zip(grads, state.residual)]
    if groups is None:
        groups = [[i] for i in range(len(carried))]
    sent: List[Optional[torch.Tensor]] = [None] * len(carried)
    for group in groups:
        if len(group) == 1:
            sent[group[0]] = _roundtrip(carried[group[0]], mode)
            continue
        stacked = _roundtrip(torch.stack([carried[i] for i in group]), mode)
        for i, part in zip(group, stacked.unbind(0)):
            sent[i] = part
    new_resid = [c - s for c, s in zip(carried, sent)]
    return sent, ErrorFeedbackState(residual=new_resid)


def init_error_feedback(params: Sequence[torch.Tensor]) -> ErrorFeedbackState:
    return ErrorFeedbackState(
        residual=[torch.zeros_like(p) for p in params])
