"""The predictor models (paper §4, §6, §7.2) as one ``nn.Module``.

Ports the reference ``repro.core.model``: every arch (``transformer``, and
the comparison predictors ``fc``, ``mlp``, ``cnn`` and ``lstm`` of Table 4
and Fig 9) and every attention of the transformer arch (``full``,
``local``, ``lsh``, ``hlsh``, ``bypass``).  The transformer is the
feature-embedding concat, sinusoidal positions, encoder layers and a
last-token classification head, with optional 4-bit fake quantization of
weights and activations; the simplified §6 predictor is this arch with 3
features (12 dims), 1 layer, 1 head, HLSH attention or the convergence
bypass, and QAT.  The other archs read the same embedding concat (no
positions): ``fc`` one product of the flattened window, ``mlp`` two ReLU
layers, ``cnn`` two width-3 "SAME" convolutions and a max over the window,
``lstm`` an LSTM over the window.  Under quantization every arch
fake-quantizes its embedding tables; among the other archs' weights only
``fc``'s head is quantized, as in the reference.

Parameters carry the reference pytree's names (``emb.<feature>``,
``layers.<i>.<wq|wk|...|ln1_g|ln1_b|...>``, ``head``, ``head_b``; ``w1``,
``b1``, ``w2``, ``b2`` of ``mlp``; ``c1``, ``c2`` of ``cnn``; ``wx``,
``wh``, ``bh`` of ``lstm``), so ``repro_torch.core.convert.params_from_jax``
maps one onto the other.  Init draws from a ``torch.Generator``: the same
distributions as the reference, not its numbers.

At inference (autograd off) the layers go through the kernel wrappers of
``repro_torch.kernels.ops``, which launch the kernels on CUDA tensors and
run their plain versions on CPU tensors: HLSH attention on K2, full
attention on K4 (the heads viewed as (B, H, S, Dh), no copy), and under
quantization every quantized weight product (the transformer's and
``fc``'s head) on K3 (weights packed on each call from the current
parameters, with the codes and scale of ``fake_quant_tensor``).  With
autograd on, the layers run the differentiable plain PyTorch code:
``core.attention.{full_attention,hlsh_apply}`` and ``x @
fake_quant_tensor(w)``.  Local and LSH attention are plain everywhere, as
are the other archs' products and convolutions (the reference has no kernel
for any of them); the embedding gathers are no products and stay
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

#: the reference's archs and the attentions of its transformer arch
ARCHS = ("transformer", "fc", "mlp", "cnn", "lstm")
ATTENTIONS = ("full", "local", "lsh", "hlsh", "bypass")

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
        if cfg.arch not in ARCHS or (cfg.arch == "transformer"
                                     and cfg.attention not in ATTENTIONS):
            raise ValueError(f"unknown arch {cfg.arch!r} or attention "
                             f"{cfg.attention!r}")
        self.cfg = cfg
        g = generator
        d, h, s = cfg.d_model, cfg.hidden, cfg.seq_len
        self.emb = nn.ParameterDict({
            f: nn.Parameter(torch.randn((FEATURE_BUCKETS[f], dim), generator=g)
                            * 0.02)
            for f, dim in cfg.emb_dims.items()})
        self.layers = nn.ModuleList()
        dense = {}
        if cfg.arch == "transformer":
            ff = d * cfg.d_ff_mult
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
            head_in = d
        elif cfg.arch == "fc":
            head_in = s * d
        elif cfg.arch == "mlp":
            dense = {"w1": _dense_init(g, (s * d, h)), "b1": torch.zeros(h),
                     "w2": _dense_init(g, (h, h)), "b2": torch.zeros(h)}
            head_in = h
        elif cfg.arch == "cnn":
            dense = {"c1": _dense_init(g, (3, d, h), scale=0.1),
                     "c2": _dense_init(g, (3, h, h), scale=0.1)}
            head_in = h
        else:                                       # lstm
            dense = {"wx": _dense_init(g, (d, 4 * h)),
                     "wh": _dense_init(g, (h, 4 * h)),
                     "bh": torch.zeros(4 * h)}
            head_in = h
        for name, t in dense.items():
            self.register_parameter(name, nn.Parameter(t))
        self.head = nn.Parameter(_dense_init(g, (head_in, cfg.n_classes)))
        self.head_b = nn.Parameter(torch.zeros(cfg.n_classes))
        # per window length S, as the reference computes them on every call:
        # the positional table and the HLSH draws (r, sel); and LSH's
        # projection, which does not depend on S
        self._pos: dict[int, torch.Tensor] = {}
        self._lsh: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}
        self._lsh_r: torch.Tensor | None = None
        self.to(device)

    def set_lsh_draws(self, s: int, r: torch.Tensor, sel: torch.Tensor
                      ) -> None:
        """Use ``r`` and ``sel`` as the HLSH draws of windows of ``s``
        tokens (for example the reference's own ``jax.random`` draws)."""
        self._lsh[s] = (r, sel)

    def set_lsh_projection(self, r: torch.Tensor) -> None:
        """Use ``r`` (d_head, n_hashes, n_buckets // 2) as the projection
        of ``lsh`` attention (for example the reference's own
        ``jax.random`` draw); else ``attention.lsh_projection``'s."""
        self._lsh_r = r

    def _lsh_projection(self, device: torch.device) -> torch.Tensor:
        cfg = self.cfg
        r = self._lsh_r
        if r is None:
            r = attn_lib.lsh_projection(cfg.d_model // cfg.n_heads,
                                        cfg.n_hashes, cfg.n_buckets,
                                        cfg.lsh_seed)
        if r.device != device:
            r = r.to(device)
        self._lsh_r = r
        return r

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
        if cfg.attention == "lsh":
            return attn_lib.lsh_attention(q, k, v,
                                          self._lsh_projection(q.device))
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
        cfg = self.cfg
        x = x.long()
        h = torch.cat([self._qw(self.emb[f])[x[:, :, j]]
                       for j, f in enumerate(cfg.features)], dim=-1)
        b, s, d = h.shape
        if cfg.arch == "transformer":
            h = self._qa(h + self._positions(s, d, h.device))
            for lp in self.layers:
                h = self._encoder_layer(lp, h)
            return self._mm(h[:, -1], self.head) + self.head_b
        if cfg.arch == "fc":
            return self._mm(h.reshape(b, s * d), self.head) + self.head_b
        if cfg.arch == "mlp":
            z = torch.relu(h.reshape(b, s * d) @ self.w1 + self.b1)
            z = torch.relu(z @ self.w2 + self.b2)
        elif cfg.arch == "cnn":
            # "SAME" width-3 cross-correlations in the reference's NWC/WIO
            # layout: conv1d on (B, C, W) with the (W, I, O) kernel as
            # (O, I, W)
            z = h.transpose(1, 2)
            for c in (self.c1, self.c2):
                z = torch.relu(torch.nn.functional.conv1d(
                    z, c.permute(2, 1, 0), padding=1))
            z = z.amax(dim=2)
        else:                                       # lstm, gates i, f, g, o
            xw = h @ self.wx                        # (B, S, 4H), all steps
            hp = c = h.new_zeros((b, self.wh.shape[0]))
            for t in range(s):
                i, f, g, o = (xw[:, t] + hp @ self.wh + self.bh).chunk(4, -1)
                c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
                hp = torch.sigmoid(o) * torch.tanh(c)
            z = hp
        return z @ self.head + self.head_b


def count_activation_elems(cfg: PredictorConfig) -> int:
    """Per-example activation element count for the footprint report
    (Tables 6-7): embeddings + every encoder-layer intermediate, as the
    reference counts them."""
    s, d = cfg.seq_len, cfg.d_model
    total = s * d  # embeddings (+ positions in place)
    if cfg.arch == "transformer":
        per_layer = s * d * 4          # q,k,v,o
        if cfg.attention != "bypass":
            per_layer += s * s * cfg.n_heads   # attention matrix
        per_layer += s * d * cfg.d_ff_mult + s * d * 2  # ffn + norms
        total += cfg.n_layers * per_layer
    total += cfg.n_classes
    return total
