"""The model FLOPs of a language model's training step, counted by the
benchmark whatever implements the step.

A token costs ``6 N`` in the matrix products of the forward and backward
passes, where N counts the matmul parameters: each layer's q, k, v and o
projections and its three MLP matrices, and the output head once (a tied
head is the embedding table, used as a product once; the embedding lookup
itself is no product).  Attention adds the causal half of its two products
(``q k^T`` and ``p v``), forward and backward: ``6 L s H d`` a token for
``L`` layers, sequence length ``s``, ``H`` query heads of size ``d``.
Recomputation (remat) is not counted: it is work the step chooses to
redo, not work the model needs.
"""
from __future__ import annotations

from typing import Dict


def matmul_params(config: Dict) -> int:
    """N: the parameters of the products a token goes through."""
    d, hd = int(config["d_model"]), int(config["head_dim"])
    heads, kv = int(config["n_heads"]), int(config["n_kv"])
    attn = d * heads * hd * 2 + d * kv * hd * 2
    mlp = 3 * d * int(config["d_ff"])
    return int(config["n_layers"]) * (attn + mlp) + d * int(config["vocab"])


def flops_per_token(config: Dict, seq_len: int) -> int:
    attn = (6 * int(config["n_layers"]) * int(seq_len)
            * int(config["n_heads"]) * int(config["head_dim"]))
    return 6 * matmul_params(config) + attn


def step_flops(config: Dict, batch: int, seq_len: int) -> int:
    """The model FLOPs of one step over ``batch`` sequences of
    ``seq_len`` tokens."""
    return flops_per_token(config, seq_len) * int(batch) * int(seq_len)
