"""--arch <id> registry."""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs.arch import ArchConfig
from repro_torch.configs import (
    phi35_moe, qwen3_moe, llama3_8b, granite_20b, smollm_135m, smollm_360m,
    recurrentgemma_9b, mamba2_780m, internvl2_1b, seamless_m4t,
)

ARCHS: Dict[str, ArchConfig] = {
    "phi3.5-moe-42b-a6.6b": phi35_moe.CONFIG,
    "qwen3-moe-235b-a22b": qwen3_moe.CONFIG,
    "llama3-8b": llama3_8b.CONFIG,
    "granite-20b": granite_20b.CONFIG,
    "smollm-135m": smollm_135m.CONFIG,
    "smollm-360m": smollm_360m.CONFIG,
    "recurrentgemma-9b": recurrentgemma_9b.CONFIG,
    "mamba2-780m": mamba2_780m.CONFIG,
    "internvl2-1b": internvl2_1b.CONFIG,
    "seamless-m4t-medium": seamless_m4t.CONFIG,
}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def list_archs() -> List[str]:
    return sorted(ARCHS)
