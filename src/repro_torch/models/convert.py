"""Carry the reference's LM parameters into the port's ``LMParams``."""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.models.builder import LMParams, Model


def _tensor(x, device) -> torch.Tensor:
    """A numpy leaf (float32 or bfloat16) as a tensor of the same type."""
    dtype = torch.bfloat16 if str(x.dtype) == "bfloat16" else torch.float32
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(
        device=device, dtype=dtype)


def params_from_reference(model: Model, tree: Dict[str, Any],
                          device="cpu") -> LMParams:
    """The reference's ``repro.models.init_params`` tree (leaves as numpy
    arrays, each segment's leaves stacked over its layers) as ``LMParams``
    with per-layer tensors, so both packages compute the same function."""
    def segments(segs, trees):
        return [[{key: {name: _tensor(x[li], device)
                        for name, x in block.items()}
                  for key, block in seg_tree.items()}
                 for li in range(seg.count)]
                for seg, seg_tree in zip(segs, trees)]

    out: Dict[str, Any] = {
        name: _tensor(tree[name], device)
        for name in ("embed", "final_ln", "head", "enc_final_ln")
        if name in tree}
    out["segments"] = segments(model.segments, tree["segments"])
    if model.enc_segments:
        out["enc_segments"] = segments(model.enc_segments,
                                       tree["enc_segments"])
    return LMParams(out)
