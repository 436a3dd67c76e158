"""Model builder: ArchConfig -> init / train_loss / prefill / decode.

Counterpart of the reference's ``repro.models.builder``.  Depth is organized
as *segments* of a repeated block pattern.  The reference stacks each
segment's parameters over its layers and scans them; the port keeps them
per layer (:class:`LMParams`, an ``nn.Module`` on an explicit device) and
loops over the layers.  Supported block kinds:

    attn   causal self-attention (GQA)        lattn  windowed self-attention
    eattn  bidirectional (encoder)            xattn  cross-attention
    ffn    SwiGLU MLP                         moe    top-k mixture of experts
    ssd    Mamba-2 state-space duality        lru    RG-LRU (Griffin)

Attention runs on K4 except in ``lattn`` blocks (``repro_torch.models.
layers`` says which path each block takes).

Decode state, ``states[segment][layer][block key]``: attention blocks carry
head-major (k, v) caches (B, Hkv, S_max, D), written in place by
:func:`decode`; ssd carries (B, H, P, N) states; lru (B, D) states; xattn
the encoder's (k, v).  ``cfg.remat`` (set in every full-size config) runs
each layer of a training forward under non-reentrant
``torch.utils.checkpoint``, as the reference wraps its scan body in
``jax.checkpoint``: no value changes, a layer's activations are recomputed
in the backward pass instead of kept.  The reference's sharding hints sit
at the same three places (``distributed.sharding.constrain``: the logits,
and the residual stream entering the backbone and each segment); each is
the identity on plain tensors and redistributes a DTensor (the model runs
on DTensors inside ``distributed.sharding.mesh_context``).  Under a mesh
the port also
constrains each block's input to the residual stream's layout: DTensor
propagates layouts op by op and, left alone, would leave the stream sharded
over ``model`` as well (a reduce-scatter after a row-parallel product),
whose later ``einsum`` flattenings ``aten.bmm`` cannot shard; GSPMD
chooses the layouts inside the reference's scanned layer itself.  A block's
weights (and the head's) are gathered over the data axes before it runs,
as FSDP does: left to choose, DTensor may instead contract a product over
a data-sharded dim and carry partial sums on into ops that cannot take
them.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.arch import ArchConfig
from repro_torch.distributed.sharding import (constrain, gathered,
                                              local_shard, take_rows)
from repro_torch.models import layers as L
from repro_torch.models.moe import moe_block
from repro_torch.models.rglru import rglru_block
from repro_torch.models.ssm import ssd_block

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class Segment:
    count: int
    pattern: Tuple[str, ...]
    encoder: bool = False      # bidirectional, no cache


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    segments: Tuple[Segment, ...]
    enc_segments: Tuple[Segment, ...] = ()


def build_model(cfg: ArchConfig) -> Model:
    if cfg.family in ("dense", "vlm"):
        segs = (Segment(cfg.n_layers, ("attn", "ffn")),)
    elif cfg.family == "moe":
        segs = (Segment(cfg.n_layers, ("attn", "moe")),)
    elif cfg.family == "ssm":
        segs = (Segment(cfg.n_layers, ("ssd",)),)
    elif cfg.family == "hybrid":
        period = cfg.pattern or ("lru", "lru", "lattn")
        full, rem = divmod(cfg.n_layers, len(period))
        segs = []
        if full:
            segs.append(Segment(full, tuple(period)))
        if rem:
            segs.append(Segment(1, tuple(period[:rem])))
        segs = tuple(segs)
    elif cfg.family == "audio":
        segs = (Segment(cfg.n_layers, ("attn", "xattn", "ffn")),)
        enc = (Segment(cfg.enc_layers, ("eattn", "ffn"), encoder=True),)
        return Model(cfg, segs, enc)
    else:
        raise ValueError(f"unknown family {cfg.family}")
    return Model(cfg, segs)


def all_segments(model: Model):
    """Main + encoder segments, in probe order."""
    return tuple(model.segments) + tuple(model.enc_segments)


def with_counts(model: Model, counts) -> Model:
    """The same architecture with overridden segment layer counts.
    ``counts`` covers main segments then encoder segments."""
    n = len(model.segments)
    segs = tuple(dataclasses.replace(s, count=c)
                 for s, c in zip(model.segments, counts[:n]))
    enc = tuple(dataclasses.replace(s, count=c)
                for s, c in zip(model.enc_segments, counts[n:]))
    return Model(model.cfg, segs, enc)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=t.is_floating_point())


class LMParams(nn.Module):
    """A model's parameters: the reference's tree with each segment's
    layers apart.  ``embed``, ``final_ln``, ``head`` (None where the
    embeddings are tied), ``enc_final_ln`` (None without an encoder);
    ``segments[i][layer][block key][name]`` and ``enc_segments`` likewise.

    ``tree`` is that layout as nested dicts and lists of tensors."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        for name in ("embed", "final_ln", "head", "enc_final_ln"):
            self.register_parameter(
                name, _param(tree[name]) if name in tree else None)

        def segment(layers):
            return nn.ModuleList(
                nn.ModuleDict({key: nn.ParameterDict(
                    {n: _param(t) for n, t in block.items()})
                    for key, block in layer.items()})
                for layer in layers)

        self.segments = nn.ModuleList(segment(s) for s in tree["segments"])
        self.enc_segments = nn.ModuleList(
            segment(s) for s in tree.get("enc_segments", ()))

    def leaf_groups(self) -> List[List[int]]:
        """Indices into ``list(self.parameters())`` grouped as the
        reference's leaves: one group per (segment, block key, name), its
        layers in order (the reference stacks them), and one for each of
        the rest."""
        groups: Dict[Tuple[str, ...], List[int]] = {}
        for i, (name, _) in enumerate(self.named_parameters()):
            parts = name.split(".")
            if parts[0] in ("segments", "enc_segments"):
                del parts[2]          # segments.<segment>.<layer>.<key>.<name>
            groups.setdefault(tuple(parts), []).append(i)
        return list(groups.values())


def _init_block(kind: str, cfg: ArchConfig, gen: torch.Generator, dtype,
                device) -> Dict[str, torch.Tensor]:
    d = cfg.d_model
    hd = cfg.hd

    def normal(shape):
        return torch.randn(shape, generator=gen, dtype=torch.float32,
                           device=device)

    def dense(shape):
        scale = 1.0 / math.sqrt(shape[0] if len(shape) == 2 else shape[-2])
        if kind == "moe" and len(shape) == 3:
            scale = 1.0 / math.sqrt(shape[1])
        return (normal(shape) * scale).to(dtype)

    def ones(n, dt=dtype):
        return torch.ones((n,), dtype=dt, device=device)

    def zeros(n, dt=dtype):
        return torch.zeros((n,), dtype=dt, device=device)

    if kind in ("attn", "lattn", "eattn", "xattn"):
        return {
            "ln": ones(d),
            "wq": dense((d, cfg.n_heads, hd)),
            "wk": dense((d, cfg.n_kv, hd)),
            "wv": dense((d, cfg.n_kv, hd)),
            "wo": (normal((cfg.n_heads, hd, d))
                   / math.sqrt(cfg.n_heads * hd)).to(dtype),
        }
    if kind == "ffn":
        return {
            "ln": ones(d),
            "wg": dense((d, cfg.d_ff)),
            "wu": dense((d, cfg.d_ff)),
            "wd": dense((cfg.d_ff, d)),
        }
    if kind == "moe":
        e, f = cfg.n_experts, cfg.d_ff
        return {
            "ln": ones(d),
            "router": normal((d, e)) * 0.02,
            "wg": dense((e, d, f)),
            "wu": dense((e, d, f)),
            "wd": dense((e, f, d)),
        }
    if kind == "ssd":
        din = 2 * d
        h = din // cfg.ssm_head_dim
        n = cfg.ssm_state
        return {
            "ln": ones(d),
            "wx": dense((d, 2 * din)),
            "wbc": dense((d, 2 * n)),
            "wdt": dense((d, h)),
            "dt_bias": zeros(h),
            "a_log": zeros(h, torch.float32),
            "wo": dense((din, d)),
        }
    if kind == "lru":
        dr = d
        return {
            "ln": ones(d),
            "w_in": dense((d, dr)),
            "w_gate": dense((d, dr)),
            "w_r": dense((dr, dr)),
            "w_i": dense((dr, dr)),
            "b_r": zeros(dr),
            "b_i": zeros(dr),
            "lam": torch.full((dr,), 1.0, dtype=torch.float32, device=device),
            "w_out": dense((dr, d)),
        }
    raise ValueError(f"unknown block kind {kind}")


def _init_segment(seg: Segment, cfg: ArchConfig, gen, dtype, device):
    return [{f"b{i}_{kind}": _init_block(kind, cfg, gen, dtype, device)
             for i, kind in enumerate(seg.pattern)}
            for _ in range(seg.count)]


def init_params(model: Model, generator: torch.Generator,
                device=None) -> LMParams:
    """Random parameters with the reference's shapes, types (``router``,
    ``a_log`` and ``lam`` float32, the rest ``cfg.dtype``) and scales,
    drawn from ``generator`` on ``device`` (the generator's by default)."""
    cfg = model.cfg
    device = generator.device if device is None else torch.device(device)
    dtype = DTYPES[cfg.dtype]
    tree: Dict[str, Any] = {
        "embed": (torch.randn((cfg.vocab, cfg.d_model), generator=generator,
                              dtype=torch.float32, device=device)
                  * 0.02).to(dtype),
        "final_ln": torch.ones((cfg.d_model,), dtype=dtype, device=device),
    }
    if not cfg.tie_embeddings:
        tree["head"] = (torch.randn((cfg.d_model, cfg.vocab),
                                    generator=generator, dtype=torch.float32,
                                    device=device)
                        / math.sqrt(cfg.d_model)).to(dtype)
    tree["segments"] = [_init_segment(seg, cfg, generator, dtype, device)
                        for seg in model.segments]
    if model.enc_segments:
        tree["enc_segments"] = [
            _init_segment(seg, cfg, generator, dtype, device)
            for seg in model.enc_segments]
        tree["enc_final_ln"] = torch.ones((cfg.d_model,), dtype=dtype,
                                          device=device)
    return LMParams(tree)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _apply_block(kind: str, h, bp, cfg: ArchConfig, *, mode: str,
                 state=None, cache_index=None, enc_out=None):
    """Returns (h, new_state)."""
    if kind in ("attn", "lattn", "eattn"):
        window = cfg.window if kind == "lattn" else None
        causal = kind != "eattn"
        want_cache = mode == "prefill" and kind != "eattn"
        return L.attention_block(
            h, bp, n_heads=cfg.n_heads, n_kv=cfg.n_kv, head_dim=cfg.hd,
            causal=causal, window=window,
            cache=state, cache_index=cache_index, want_cache=want_cache,
            f32_logits=cfg.attn_f32_logits)
    if kind == "xattn":
        if mode == "prefill":
            ckv = L.cross_kv_proj(enc_out, bp)
            y, _ = L.attention_block(
                h, bp, n_heads=cfg.n_heads, n_kv=cfg.n_kv, head_dim=cfg.hd,
                cross_kv=ckv, f32_logits=cfg.attn_f32_logits)
            return y, ckv
        ckv = state if state is not None else L.cross_kv_proj(enc_out, bp)
        y, _ = L.attention_block(
            h, bp, n_heads=cfg.n_heads, n_kv=cfg.n_kv, head_dim=cfg.hd,
            cross_kv=ckv, f32_logits=cfg.attn_f32_logits)
        return y, (ckv if mode == "decode" else None)
    if kind == "ffn":
        return L.swiglu_block(h, bp), None
    if kind == "moe":
        y, aux = moe_block(h, bp, n_experts=cfg.n_experts, top_k=cfg.top_k,
                           capacity_factor=cfg.capacity_factor,
                           dispatch=cfg.moe_dispatch,
                           group_tokens=cfg.moe_group_tokens)
        return y, aux          # aux routed through "state" slot, summed later
    if kind == "ssd":
        return ssd_block(h, bp, head_dim=cfg.ssm_head_dim,
                         ssm_state=cfg.ssm_state, state=state,
                         chunk=cfg.ssd_chunk)
    if kind == "lru":
        return rglru_block(h, bp, state=state)
    raise ValueError(kind)


def _run_layer(seg: Segment, layer_params, h, cfg: ArchConfig, *,
               mode: str, layer_states=None, cache_index=None, enc_out=None):
    """One layer's blocks.  Returns (h, new states by block key, aux)."""
    layer_new = {}
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for i, kind in enumerate(seg.pattern):
        key = f"b{i}_{kind}"
        st = None if layer_states is None else layer_states.get(key)
        # each block's input in the residual stream's layout, and its
        # weights gathered over the data axes (FSDP; see module docstring)
        h = constrain(h, ("pod", "data"), None, None)
        bp = layer_params[key]
        if isinstance(h, DTensor):
            bp = {n: gathered(w) for n, w in bp.items()}
        h, out = _apply_block(kind, h, bp, cfg,
                              mode=mode, state=st,
                              cache_index=cache_index, enc_out=enc_out)
        if kind == "moe":
            aux = aux + out
        elif out is not None and mode != "train":
            layer_new[key] = out
    return h, layer_new, aux


def _train_layer(seg: Segment, layer_params, cfg: ArchConfig, enc_out, h):
    h, _, aux = _run_layer(seg, layer_params, h, cfg, mode="train",
                           enc_out=enc_out)
    return h, aux


def _run_segment(seg: Segment, seg_params, h, cfg: ArchConfig, *,
                 mode: str, states=None, cache_index=None, enc_out=None):
    """One segment, layer by layer.  states: per layer, block key -> state
    (or None).  Returns (h, new_states or None, aux).

    With ``cfg.remat`` set, a layer that autograd records in ``mode="train"``
    runs under non-reentrant ``torch.utils.checkpoint``: its activations are
    recomputed in the backward pass instead of kept (the reference's
    ``jax.checkpoint`` of its scan body).  The recompute runs with autograd
    on, so attention takes the same differentiable path as the forward."""
    remat = cfg.remat and mode == "train" and torch.is_grad_enabled()
    new_states: List[Optional[Dict]] = []
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for li in range(seg.count):
        if remat:
            h, layer_aux = checkpoint(
                functools.partial(_train_layer, seg, seg_params[li], cfg,
                                  enc_out), h, use_reentrant=False)
            layer_new = None
        else:
            h, layer_new, layer_aux = _run_layer(
                seg, seg_params[li], h, cfg, mode=mode,
                layer_states=None if states is None else states[li],
                cache_index=cache_index, enc_out=enc_out)
        aux = aux + layer_aux
        new_states.append(layer_new or None)
    if all(s is None for s in new_states):
        new_states = None
    return h, new_states, aux


def _embed_tokens(cfg: ArchConfig, params: LMParams, tokens):
    h = take_rows(params.embed, tokens).to(DTYPES[cfg.dtype])
    # sqrt(d_model) in float32, cast to the model's type first
    scale = torch.tensor(math.sqrt(cfg.d_model), dtype=torch.float32)
    return h * scale.to(h.dtype)


def _logits(cfg: ArchConfig, params: LMParams, h):
    # the head's input in the residual stream's layout, as each block's is
    h = constrain(h, ("pod", "data"), None, None)
    h = L.rmsnorm(h, params.final_ln)
    if cfg.tie_embeddings:
        logits = h @ gathered(params.embed).T
    else:
        logits = h @ gathered(params.head)
    return constrain(logits, ("pod", "data"), None, "model")


def _encode(cfg: ArchConfig, model: Model, params: LMParams, frames):
    h = frames.to(DTYPES[cfg.dtype])
    for seg, sp in zip(model.enc_segments, params.enc_segments):
        h, _, _ = _run_segment(seg, sp, h, cfg, mode="train")
    return L.rmsnorm(h, params.enc_final_ln)


def _backbone(cfg, model, params, h, *, mode, states=None, cache_index=None,
              enc_out=None):
    all_states = []
    aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
    for si, (seg, sp) in enumerate(zip(model.segments, params.segments)):
        st = None if states is None else states[si]
        h = constrain(h, ("pod", "data"), None, None)
        h, new_st, aux = _run_segment(
            seg, sp, h, cfg, mode=mode, states=st, cache_index=cache_index,
            enc_out=enc_out)
        all_states.append(new_st)
        aux_total = aux_total + aux
    return h, all_states, aux_total


def _inputs(cfg: ArchConfig, model: Model, params: LMParams, batch):
    """(embedded tokens, with a VLM's patch prefix, and the encoder's
    output or None)."""
    h = _embed_tokens(cfg, params, batch["tokens"])
    enc_out = None
    if cfg.family == "vlm":
        h = torch.cat([batch["patches"].to(h.dtype), h], dim=1)
    if cfg.family == "audio":
        enc_out = _encode(cfg, model, params, batch["frames"])
    return h, enc_out


def _take_targets(logp, tgt):
    """``logp``'s entry at each target (``gather`` on the last dim).  On
    DTensors it runs on each rank's batch shard: DTensor's ``gather``
    backward would make a zero tensor of the whole of ``logp`` on every
    rank."""
    if not isinstance(logp, DTensor):
        return torch.gather(logp, -1, tgt[..., None])
    mesh = logp.device_mesh
    want = [p if p == Shard(0) else Replicate() for p in logp.placements]
    out = torch.gather(local_shard(logp.redistribute(mesh, want)), -1,
                       tgt.redistribute(mesh, want).to_local()[..., None])
    shape = (*tgt.shape, 1)
    return DTensor.from_local(out, mesh, want, run_check=False, shape=shape,
                              stride=(shape[1], 1, 1))


def train_loss(model: Model, params: LMParams,
               batch: Dict[str, torch.Tensor], aux_weight: float = 0.01
               ) -> Tuple[torch.Tensor, Dict]:
    """Next-token CE (+ MoE load-balance aux).  batch:
    tokens (B, S) int64; vlm: + patches (B, P, d); audio: + frames (B, F, d).
    Differentiable in ``params`` (autograd)."""
    cfg = model.cfg
    tokens = batch["tokens"]
    n_text = tokens.shape[1]
    h, enc_out = _inputs(cfg, model, params, batch)
    h = constrain(h, ("pod", "data"), None, None)
    h, _, aux = _backbone(cfg, model, params, h, mode="train",
                          enc_out=enc_out)
    h = h[:, -n_text:]
    logits = _logits(cfg, params, h)
    logp = torch.log_softmax(logits.float(), dim=-1)
    tgt = tokens[:, 1:].long()
    nll = -_take_targets(logp[:, :-1], tgt)
    loss = nll.mean() + aux_weight * aux
    return loss, {"nll": nll.mean(), "aux": aux}


def init_decode_state(model: Model, batch: int, max_len: int,
                      enc_len: int = 0, device="cpu"):
    """Zero decode states laid out as :func:`prefill` returns them."""
    cfg = model.cfg
    dtype = DTYPES[cfg.dtype]

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    states = []
    for seg in model.segments:
        layers = []
        for _ in range(seg.count):
            layer: Dict[str, Any] = {}
            for i, kind in enumerate(seg.pattern):
                key = f"b{i}_{kind}"
                if kind in ("attn", "lattn"):
                    shp = (batch, cfg.n_kv, max_len, cfg.hd)
                    layer[key] = (zeros(*shp), zeros(*shp))
                elif kind == "xattn":
                    shp = (batch, cfg.n_kv, enc_len, cfg.hd)
                    layer[key] = (zeros(*shp), zeros(*shp))
                elif kind == "ssd":
                    h = 2 * cfg.d_model // cfg.ssm_head_dim
                    layer[key] = zeros(batch, h, cfg.ssm_head_dim,
                                       cfg.ssm_state)
                elif kind == "lru":
                    layer[key] = zeros(batch, cfg.d_model)
            layers.append(layer or None)
        states.append(None if all(x is None for x in layers) else layers)
    return states


def _pad_caches(states, max_len: int):
    """Self-attention caches zero-padded to ``max_len`` positions."""
    def pad(kv):
        out = []
        for x in kv:
            full = x.new_zeros((*x.shape[:2], max_len, x.shape[3]))
            full[:, :, :x.shape[2]] = x
            out.append(full)
        return tuple(out)

    return [None if seg is None else [
        None if layer is None else {
            key: pad(st) if "attn" in key and "xattn" not in key else st
            for key, st in layer.items()}
        for layer in seg] for seg in states]


@torch.no_grad()
def prefill(model: Model, params: LMParams, batch: Dict[str, torch.Tensor],
            max_len: Optional[int] = None):
    """Run the prompt; returns (last-position logits (B, 1, V), decode
    states).  KV caches are padded to ``max_len``."""
    cfg = model.cfg
    h, enc_out = _inputs(cfg, model, params, batch)
    h, states, _ = _backbone(cfg, model, params, h, mode="prefill",
                             enc_out=enc_out)
    logits = _logits(cfg, params, h[:, -1:])
    if max_len is not None and max_len > h.shape[1]:
        states = _pad_caches(states, max_len)
    return logits, states


@torch.no_grad()
def decode(model: Model, params: LMParams, states, tokens_1: torch.Tensor,
           index: int):
    """One decode step.  tokens_1: (B, 1); index: the position it is
    written at.  Returns (logits (B, 1, V), new states): the attention
    caches of ``states`` are written in place."""
    cfg = model.cfg
    h = _embed_tokens(cfg, params, tokens_1)
    h, new_states, _ = _backbone(cfg, model, params, h, mode="decode",
                                 states=states, cache_index=int(index))
    return _logits(cfg, params, h), new_states
