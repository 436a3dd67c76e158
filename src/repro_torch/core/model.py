"""The predictor model (paper §4, §6) as an ``nn.Module``.

Ports the ``transformer`` arch of the reference ``repro.core.model`` with
``full``, ``hlsh`` and ``bypass`` attention: feature-embedding concat,
sinusoidal positions, encoder layers, last-token classification head,
optional 4-bit fake quantization of weights and activations.  The
simplified §6 predictor is this arch with 3 features (12 dims), 1 layer,
1 head, HLSH attention or the convergence bypass, and QAT.

Parameters carry the reference pytree's names (``emb.<feature>``,
``layers.<i>.<wq|wk|...|ln1_g|ln1_b|...>``, ``head``, ``head_b``), so
``repro_torch.core.convert.params_from_jax`` maps one onto the other.  Init
draws from a ``torch.Generator``: the same distributions as the reference,
not its numbers.

At inference (autograd off) on a CUDA device, the HLSH layer runs the K2
kernel (``repro_torch.kernels.ops.hlsh_attention``); with autograd on it
runs the differentiable ``core.attention.hlsh_apply``.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from repro_torch.core import attention as attn_lib
from repro_torch.core.families import PredictorConfig
from repro_torch.core.quantize import fake_quant, fake_quant_tensor
from repro_torch.core.vocab import FEATURE_BUCKETS
from repro_torch.kernels import ops

#: attention kinds of the transformer arch this port implements; the
#: reference's ``local`` and ``lsh`` attention and its fc/mlp/cnn/lstm
#: archs are later slices of the port
PORTED_ATTENTION = ("full", "hlsh", "bypass")

def _dense_init(g: torch.Generator, shape, scale=None) -> torch.Tensor:
    s = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    return torch.randn(shape, generator=g, dtype=torch.float32) * s


def _positional(seq_len: int, d: int) -> torch.Tensor:
    pos = np.arange(seq_len)[:, None]
    i = np.arange(d)[None, :]
    angle = pos / np.power(10000.0, (2 * (i // 2)) / d)
    enc = np.where(i % 2 == 0, np.sin(angle), np.cos(angle))
    return torch.as_tensor(enc, dtype=torch.float32)


def _layernorm(x, g, b):
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, correction=0)   # population variance
    return (x - mu) / torch.sqrt(var + 1e-5) * g + b


def _heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, s, d = x.shape
    return (x.reshape(b, s, n_heads, d // n_heads).transpose(1, 2)
            .reshape(b * n_heads, s, d // n_heads).contiguous())


def _unheads(x: torch.Tensor, n_heads: int, b: int) -> torch.Tensor:
    bh, s, dh = x.shape
    return (x.reshape(b, n_heads, s, dh).transpose(1, 2)
            .reshape(b, s, n_heads * dh))


class Predictor(nn.Module):
    """``forward(x)``: x (B, seq, n_features) int -> logits (B, n_classes)."""

    def __init__(self, cfg: PredictorConfig, generator: torch.Generator,
                 device: torch.device | str = "cuda") -> None:
        super().__init__()
        if cfg.arch != "transformer" or cfg.attention not in PORTED_ATTENTION:
            raise ValueError(
                f"arch={cfg.arch!r} attention={cfg.attention!r} is not in "
                "this slice of the port (transformer with "
                f"{'/'.join(PORTED_ATTENTION)} attention); the other archs "
                "and attentions come in a later slice")
        self.cfg = cfg
        g = generator
        d = cfg.d_model
        ff = d * cfg.d_ff_mult
        self.emb = nn.ParameterDict({
            f: nn.Parameter(torch.randn((FEATURE_BUCKETS[f], dim), generator=g)
                            * 0.02)
            for f, dim in cfg.emb_dims.items()})
        self.layers = nn.ModuleList()
        for _ in range(cfg.n_layers):
            self.layers.append(nn.ParameterDict({
                "wq": nn.Parameter(_dense_init(g, (d, d))),
                "wk": nn.Parameter(_dense_init(g, (d, d))),
                "wv": nn.Parameter(_dense_init(g, (d, d))),
                "wo": nn.Parameter(_dense_init(g, (d, d))),
                "ln1_g": nn.Parameter(torch.ones(d)),
                "ln1_b": nn.Parameter(torch.zeros(d)),
                "w1": nn.Parameter(_dense_init(g, (d, ff))),
                "b1": nn.Parameter(torch.zeros(ff)),
                "w2": nn.Parameter(_dense_init(g, (ff, d))),
                "b2": nn.Parameter(torch.zeros(d)),
                "ln2_g": nn.Parameter(torch.ones(d)),
                "ln2_b": nn.Parameter(torch.zeros(d)),
            }))
        self.head = nn.Parameter(_dense_init(g, (d, cfg.n_classes)))
        self.head_b = nn.Parameter(torch.zeros(cfg.n_classes))
        self.register_buffer("pos", _positional(cfg.seq_len, d),
                             persistent=False)
        if cfg.attention == "hlsh":
            r, sel = attn_lib.lsh_draws(d // cfg.n_heads, cfg.n_hashes,
                                        cfg.n_buckets, cfg.seq_len,
                                        cfg.lsh_seed)
            self.register_buffer("lsh_r", r, persistent=False)
            self.register_buffer("lsh_sel", sel, persistent=False)
        self.to(device)

    def _qw(self, w: torch.Tensor) -> torch.Tensor:
        return fake_quant_tensor(w) if self.cfg.quantize else w

    def _qa(self, a: torch.Tensor) -> torch.Tensor:
        return fake_quant(a) if self.cfg.quantize else a

    def _attention(self, q, k, v) -> torch.Tensor:
        cfg = self.cfg
        if cfg.attention == "full":
            return attn_lib.full_attention(q, k, v)
        plan = attn_lib.hlsh_plan(q, self.lsh_r, self.lsh_sel, cfg.n_hashes,
                                  cfg.htop, cfg.hbot)
        if torch.is_grad_enabled():
            return attn_lib.hlsh_apply(q, k, v, plan)
        return ops.hlsh_attention(q, k, v, plan.keep.to(q.dtype),
                                  plan.share_src)

    def _encoder_layer(self, lp, h: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b = h.shape[0]
        if cfg.attention != "bypass":
            if cfg.attention == "hlsh":
                # shared-QK structure (Reformer / paper Algorithm 1)
                q = k = h @ self._qw(lp["wq"])
            else:
                q = h @ self._qw(lp["wq"])
                k = h @ self._qw(lp["wk"])
            v = h @ self._qw(lp["wv"])
            qh, kh, vh = (_heads(t, cfg.n_heads) for t in (q, k, v))
            o = _unheads(self._attention(qh, kh, vh), cfg.n_heads, b)
            o = o @ self._qw(lp["wo"])
            h = _layernorm(self._qa(h + o), lp["ln1_g"], lp["ln1_b"])
        ff = torch.relu(h @ self._qw(lp["w1"]) + lp["b1"])
        ff = self._qa(ff)
        ff = ff @ self._qw(lp["w2"]) + lp["b2"]
        return _layernorm(self._qa(h + ff), lp["ln2_g"], lp["ln2_b"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.long()
        h = torch.cat([self._qw(self.emb[f])[x[:, :, j]]
                       for j, f in enumerate(self.cfg.features)], dim=-1)
        h = h + self.pos[:h.shape[1]]
        h = self._qa(h)
        for lp in self.layers:
            h = self._encoder_layer(lp, h)
        last = h[:, -1]
        return last @ self._qw(self.head) + self.head_b
