"""Carry the reference's JAX parameters into the port's ``Predictor``."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def params_from_jax(params: Dict) -> Dict[str, torch.Tensor]:
    """Map the reference param pytree (``repro.core.model.init_params``
    layout of any arch, leaves as numpy arrays) onto a ``Predictor`` state
    dict, so ``Predictor.load_state_dict`` makes both compute the same
    function: ``emb.<feature>``, ``layers.<i>.<name>`` (``ln1``/``ln2``'s
    ``g`` and ``b`` as ``ln1_g`` ...), and every other leaf (``head``,
    ``head_b``, ``w1`` ... ``c1`` ... ``wx`` ...) under its own name."""
    state: Dict[str, torch.Tensor] = {}

    def put(name: str, x) -> None:
        state[name] = torch.from_numpy(np.array(x, dtype=np.float32))

    for f, tab in params["emb"].items():
        put(f"emb.{f}", tab)
    for i, lp in enumerate(params.get("layers", [])):
        for name, x in lp.items():
            if isinstance(x, dict):            # ln1 / ln2: {"g", "b"}
                for sub, y in x.items():
                    put(f"layers.{i}.{name}_{sub}", y)
            else:
                put(f"layers.{i}.{name}", x)
    for name, x in params.items():
        if name not in ("emb", "layers"):
            put(name, x)
    return state
