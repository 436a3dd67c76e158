"""The predictor model (paper §4, §6) as an ``nn.Module``.

Ports the ``transformer`` arch of the reference ``repro.core.model`` with
``full``, ``local``, ``hlsh`` and ``bypass`` attention: feature-embedding concat,
sinusoidal positions, encoder layers, last-token classification head,
optional 4-bit fake quantization of weights and activations.  The
simplified §6 predictor is this arch with 3 features (12 dims), 1 layer,
1 head, HLSH attention or the convergence bypass, and QAT.

Parameters carry the reference pytree's names (``emb.<feature>``,
``layers.<i>.<wq|wk|...|ln1_g|ln1_b|...>``, ``head``, ``head_b``), so
``repro_torch.core.convert.params_from_jax`` maps one onto the other.  Init
draws from a ``torch.Generator``: the same distributions as the reference,
not its numbers.

At inference (autograd off) the layers go through the kernel wrappers of
``repro_torch.kernels.ops``, which launch the kernels on CUDA tensors and
run their plain versions on CPU tensors: HLSH attention on K2, full
attention on K4 (the heads viewed as (B, H, S, Dh), no copy), and under
quantization every weight product on K3 (weights packed on each call from
the current parameters, with the codes and scale of ``fake_quant_tensor``).
With autograd on, the layers run the differentiable plain PyTorch code:
``core.attention.{full_attention,hlsh_apply}`` and ``x @
fake_quant_tensor(w)``.  Local attention is plain everywhere (the reference
has no kernel for it); the embedding gathers are no products and stay
``fake_quant_tensor(table)[x]``.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from repro_torch.core import attention as attn_lib
from repro_torch.core.families import PredictorConfig
from repro_torch.core.quantize import (fake_quant, fake_quant_tensor,
                                       pack_int4_like_fake_quant)
from repro_torch.core.vocab import FEATURE_BUCKETS
from repro_torch.kernels import ops

#: attention kinds of the transformer arch this port implements; the
#: reference's ``lsh`` attention and its fc/mlp/cnn/lstm archs are later
#: slices of the port
PORTED_ATTENTION = ("full", "local", "hlsh", "bypass")

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
        # per window length S, as the reference computes them on every call:
        # the positional table and the HLSH draws (r, sel)
        self._pos: dict[int, torch.Tensor] = {}
        self._lsh: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}
        self.to(device)

    def set_lsh_draws(self, s: int, r: torch.Tensor, sel: torch.Tensor
                      ) -> None:
        """Use ``r`` and ``sel`` as the HLSH draws of windows of ``s``
        tokens (for example the reference's own ``jax.random`` draws)."""
        self._lsh[s] = (r, sel)

    def _positions(self, s: int, d: int, device: torch.device
                   ) -> torch.Tensor:
        """The positional table of windows of ``s`` tokens, on ``device``."""
        pos = self._pos.get(s)
        if pos is None or pos.device != device:
            pos = self._pos[s] = _positional(s, d).to(device)
        return pos

    def _lsh_draws(self, s: int, device: torch.device):
        """The HLSH draws of windows of ``s`` tokens, on ``device``: those
        :meth:`set_lsh_draws` gave, else ``attention.lsh_draws``'s (JAX's
        for the simplified configuration at ``cfg.seq_len``, torch's at any
        other S)."""
        cfg = self.cfg
        draws = self._lsh.get(s) or attn_lib.lsh_draws(
            cfg.d_model // cfg.n_heads, cfg.n_hashes, cfg.n_buckets, s,
            cfg.lsh_seed)
        if draws[0].device != device:
            draws = tuple(t.to(device) for t in draws)
        self._lsh[s] = draws
        return draws

    def _qw(self, w: torch.Tensor) -> torch.Tensor:
        return fake_quant_tensor(w) if self.cfg.quantize else w

    def _qa(self, a: torch.Tensor) -> torch.Tensor:
        return fake_quant(a) if self.cfg.quantize else a

    def _mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``x @ _qw(w)``; at quantized inference through K3 on ``w``'s
        int4 codes, with the activations flattened to (M, K)."""
        if not self.cfg.quantize or torch.is_grad_enabled():
            return x @ self._qw(w)
        packed, scale = pack_int4_like_fake_quant(w)
        y = ops.int4_matmul(x.reshape(-1, x.shape[-1]).contiguous(), packed,
                            scale)
        return y[:, :w.shape[1]].reshape(*x.shape[:-1], w.shape[1])

    def _attention(self, q, k, v) -> torch.Tensor:
        cfg = self.cfg
        if cfg.attention == "local":
            return attn_lib.local_attention(q, k, v, cfg.local_window)
        if cfg.attention == "full":
            if torch.is_grad_enabled():
                return attn_lib.full_attention(q, k, v)
            bh, s, dh = q.shape
            heads = (bh // cfg.n_heads, cfg.n_heads, s, dh)
            return ops.flash_attention(q.view(heads), k.view(heads),
                                       v.view(heads)).view(bh, s, dh)
        r, sel = self._lsh_draws(q.shape[1], q.device)
        plan = attn_lib.hlsh_plan(q, r, sel, cfg.n_hashes, cfg.htop, cfg.hbot)
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
                q = k = self._mm(h, lp["wq"])
            else:
                q = self._mm(h, lp["wq"])
                k = self._mm(h, lp["wk"])
            v = self._mm(h, lp["wv"])
            qh, kh, vh = (_heads(t, cfg.n_heads) for t in (q, k, v))
            o = _unheads(self._attention(qh, kh, vh), cfg.n_heads, b)
            o = self._mm(o, lp["wo"])
            h = _layernorm(self._qa(h + o), lp["ln1_g"], lp["ln1_b"])
        ff = torch.relu(self._mm(h, lp["w1"]) + lp["b1"])
        ff = self._qa(ff)
        ff = self._mm(ff, lp["w2"]) + lp["b2"]
        return _layernorm(self._qa(h + ff), lp["ln2_g"], lp["ln2_b"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.long()
        h = torch.cat([self._qw(self.emb[f])[x[:, :, j]]
                       for j, f in enumerate(self.cfg.features)], dim=-1)
        h = h + self._positions(h.shape[1], h.shape[2], h.device)
        h = self._qa(h)
        for lp in self.layers:
            h = self._encoder_layer(lp, h)
        last = h[:, -1]
        return self._mm(last, self.head) + self.head_b
