"""The weight draw: the port's recipe for a dense model (``attn`` then
``ffn`` blocks), written out again.  The draws are made in the port's
order from one ``torch.Generator`` on the device, so the same seed on the
same device gives the same bits.  Leaves are named and ordered as the
port's parameters are (``nn.ParameterDict`` sorts a block's names): the
order in which the clipping norm sums them."""
from __future__ import annotations

import math
from typing import Dict

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def draw(config: Dict, device) -> Dict[str, torch.Tensor]:
    """Every leaf by name, in ``config["dtype"]``, from
    ``torch.Generator(device).manual_seed(config["weights_seed"])``."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(
        int(config["weights_seed"]))
    dtype = DTYPES[config["dtype"]]
    d, hd, ff = int(config["d_model"]), int(config["head_dim"]), \
        int(config["d_ff"])
    heads, kv = int(config["n_heads"]), int(config["n_kv"])

    def normal(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float32,
                           device=device)

    def dense(*shape):
        # a 2-D weight over its fan-in, a 3-D one over its second-to-last dim
        fan = shape[0] if len(shape) == 2 else shape[-2]
        return (normal(*shape) * (1.0 / math.sqrt(fan))).to(dtype)

    def ones(n):
        return torch.ones((n,), dtype=dtype, device=device)

    out = {"embed": (normal(int(config["vocab"]), d) * 0.02).to(dtype),
           "final_ln": ones(d)}
    if not config["tie_embeddings"]:
        raise ValueError("the reference draws tied embeddings only")
    for layer in range(int(config["n_layers"])):
        a = f"segments.0.{layer}.b0_attn."
        out[a + "ln"] = ones(d)
        out[a + "wq"] = dense(d, heads, hd)
        out[a + "wk"] = dense(d, kv, hd)
        out[a + "wv"] = dense(d, kv, hd)
        out[a + "wo"] = (normal(heads, hd, d)
                         / math.sqrt(heads * hd)).to(dtype)
        f = f"segments.0.{layer}.b1_ffn."
        out[f + "ln"] = ones(d)
        out[f + "wg"] = dense(d, ff)
        out[f + "wu"] = dense(d, ff)
        out[f + "wd"] = dense(ff, d)
    head = ["embed", "final_ln"]
    return {k: out[k] for k in head + sorted(set(out) - set(head),
                                             key=_layer_order)}


def _layer_order(name: str):
    _, _, layer, block, leaf = name.split(".")
    return int(layer), block, leaf
