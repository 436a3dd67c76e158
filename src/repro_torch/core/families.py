"""Predictor configuration layer: the jax-free half of ``repro.core.model``.

The paper's §5-§6 story is a *comparison between model families*: the
unconstrained reference Transformer sets the accuracy bar, and the
simplified (revised) predictor is engineered to match it.  This module
makes that a first-class, config-driven axis — xformers-block-factory
style: each family is a plain dict of :class:`PredictorConfig` overrides
(``MODEL_FAMILY_BLOCKS``), and :func:`family_config` assembles the
resolved config from it.  Families:

* ``simplified`` — the §6 revised predictor (3 features, 12 embedding
  dims, 1 layer, 1 head, HLSH attention with the convergence bypass,
  4-bit quantization-aware).  The default everywhere.
* ``transformer`` — the reference encoder: full 13-feature embedding
  concat (200 dims), 2 layers, 4-head full softmax attention, fp32.
* ``transformer-local`` — the windowed/local-attention variant the
  paper's interpretability analysis derives (recent deltas dominate):
  the same reference stack with attention restricted to a
  ``local_window``-wide band.

Deliberately **jax-free**: :class:`PredictorConfig` is a plain frozen
dataclass and the registry is data, so the sweep CLI, the scenario
registry, and ``repro.uvm.predcache`` can validate family names and
fingerprint architectures (:func:`config_digest` — part of every
prediction-cache key) without importing jax.  ``repro.core.model`` owns
``init_params``/``apply`` and re-exports everything here.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Dict, Tuple

# embedding width per feature; the full 13(+kernel)-feature concat is 200
# dims, matching the paper's embedding output of 200 x 30.
EMB_DIMS: Dict[str, int] = {
    "pc": 24, "hit": 4, "warp": 12, "sm": 12, "tpc": 8, "cta": 12,
    "kernel": 8, "paddr": 32, "bbaddr": 16, "raddr": 8, "inarr": 8,
    "dp": 32, "dbb": 16, "dr": 8,
}
# revised predictor (§6): 3 features, 12 total embedding dims
REVISED_EMB_DIMS: Dict[str, int] = {"paddr": 4, "dp": 6, "pc": 2}
REVISED_FEATURES = ("paddr", "dp", "pc")


@dataclasses.dataclass(frozen=True)
class PredictorConfig:
    n_classes: int
    arch: str = "transformer"          # transformer|fc|mlp|cnn|lstm
    attention: str = "full"            # full|local|hlsh|lsh|bypass
    features: Tuple[str, ...] = tuple(EMB_DIMS)
    seq_len: int = 30
    n_layers: int = 2
    n_heads: int = 4
    d_ff_mult: int = 4
    quantize: bool = False
    revised_dims: bool = False         # use the 12-dim embedding set
    n_hashes: int = 8
    n_buckets: int = 8
    htop: float = 0.9
    hbot: float = 0.1
    lsh_seed: int = 7
    hidden: int = 128                  # lstm/cnn/mlp width
    local_window: int = 8              # attention="local": band half-width

    @property
    def emb_dims(self) -> Dict[str, int]:
        base = REVISED_EMB_DIMS if self.revised_dims else EMB_DIMS
        return {f: base[f] for f in self.features}

    @property
    def d_model(self) -> int:
        return sum(self.emb_dims.values())


def revised_config(n_classes: int, convergence: float,
                   bypass_threshold: float = 0.7,
                   quantize: bool = True) -> PredictorConfig:
    """§6: SM+warp clustering is handled upstream; here: 3 features, 1 layer,
    1 head, HLSH attention, and the bypass indicator — if one page delta
    dominates the training data, attention is skipped entirely."""
    bypass = convergence >= bypass_threshold
    return PredictorConfig(
        n_classes=n_classes, arch="transformer",
        attention="bypass" if bypass else "hlsh",
        features=REVISED_FEATURES, revised_dims=True,
        n_layers=1, n_heads=1, quantize=quantize,
    )


# ---------------------------------------------------------------------------
# the family registry (block-factory style: families are config dicts)
# ---------------------------------------------------------------------------

#: per-family encoder blocks: the :class:`PredictorConfig` overrides each
#: reference family is assembled from (``simplified`` is special-cased —
#: its attention/bypass resolution is convergence-driven, see
#: :func:`revised_config`).  The reference families pin ``quantize`` —
#: the paper's unconstrained Transformer is fp32 regardless of the
#: service's quantization knob.
MODEL_FAMILY_BLOCKS: Dict[str, Dict] = {
    "transformer": {
        "arch": "transformer", "attention": "full",
        "features": tuple(EMB_DIMS), "revised_dims": False,
        "n_layers": 2, "n_heads": 4, "d_ff_mult": 4, "quantize": False,
    },
    "transformer-local": {
        "arch": "transformer", "attention": "local", "local_window": 8,
        "features": tuple(EMB_DIMS), "revised_dims": False,
        "n_layers": 2, "n_heads": 4, "d_ff_mult": 4, "quantize": False,
    },
}

#: family vocabulary, in registry order (``simplified`` is the default
#: and must stay first: every pre-family code path assumes it)
MODEL_FAMILIES = ("simplified",) + tuple(MODEL_FAMILY_BLOCKS)


def validate_family(name: str) -> str:
    if name not in MODEL_FAMILIES:
        raise ValueError(f"unknown model family {name!r}; "
                         f"choose from {', '.join(MODEL_FAMILIES)}")
    return name


def family_config(family: str, n_classes: int, convergence: float = 0.0,
                  bypass_threshold: float = 0.7,
                  quantize: bool = True) -> PredictorConfig:
    """Assemble one family's resolved :class:`PredictorConfig`.

    ``convergence``/``bypass_threshold``/``quantize`` only shape the
    ``simplified`` family (the §6 bypass indicator and QAT knob); the
    reference families are fully determined by their registry block.
    """
    validate_family(family)
    if family == "simplified":
        return revised_config(n_classes, convergence, bypass_threshold,
                              quantize=quantize)
    return PredictorConfig(n_classes=n_classes,
                           **MODEL_FAMILY_BLOCKS[family])


def config_digest(cfg: PredictorConfig) -> str:
    """Stable fingerprint of a resolved :class:`PredictorConfig` — the
    architecture identity ``repro.uvm.predcache`` keys prediction arrays
    on, so two families (or two revisions of one family's block) can
    never share a cached ``predict_trace`` array."""
    doc = dataclasses.asdict(cfg)
    doc["features"] = list(doc["features"])
    blob = json.dumps(doc, sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]
